"""mymedialite_tpu_torch — the PyTorch / CUDA port of mymedialite_tpu.

A second package beside ``mymedialite_tpu`` (the JAX reference, which it
imports only for its jax-free data, IO, metric and CLI helpers). Plain
tensor code is PyTorch; every TPU kernel on a ported path is a CUDA
kernel written for Hopper (``csrc/``), built with nvcc at first use.
The package never imports jax.

Ported so far: rating prediction with ``MatrixFactorization`` and
``BiasedMatrixFactorization`` (train, evaluate, save/load, CLI).
"""

__version__ = "0.1.0"

from mymedialite_tpu_torch.models.registry import (  # noqa: F401
    create_rating_predictor,
    list_rating_predictors,
)

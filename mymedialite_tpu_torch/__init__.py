"""mymedialite_tpu_torch — the PyTorch / CUDA port of mymedialite_tpu.

A second package beside ``mymedialite_tpu`` (the JAX reference). It
imports neither jax nor the JAX package: the jax-free data, IO, metric,
CLI and native helpers it shares with the reference are its own copies.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
CUDA kernel written for Hopper (``csrc/``), built with nvcc at first
use.

Ported so far (train, evaluate, save/load, CLIs): rating prediction
with the MF and SVD++ families (GSVDPlusPlus included), the rating
baselines and the KNNs; item recommendation with the BPR family
(resident and slab-tiled schedules, the minibatch epoch past them),
``MostPopular``, ``WRMF`` and the KNNs; serving through the fused top-k
kernel; cross-validation and the Nelder-Mead search. Where the JAX
package runs an XLA epoch instead of a Pallas kernel, the port runs the
same epoch in plain PyTorch. ``models/registry.py`` lists the names.
"""

__version__ = "0.1.0"

from mymedialite_tpu_torch.models.registry import (  # noqa: F401
    create_item_recommender,
    create_rating_predictor,
    list_item_recommenders,
    list_rating_predictors,
)

"""Device selection for the port.

The port runs on a CUDA card by default. Asking for CUDA where there is
none raises: the CPU is used only when it is named (``device=cpu``),
so a run never lands on the CPU by accident.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device=cpu to run on the CPU")
    return device


@contextlib.contextmanager
def exact_float32():
    """Products inside the block keep float32 on CUDA: no TF32 and no
    reduced-precision reductions of half types (bf16 {0,1} products stay
    exact below 2**24 only without them). The previous settings come
    back when the block ends."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved

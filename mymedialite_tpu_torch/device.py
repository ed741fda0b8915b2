"""Device selection for the port.

The port runs on a CUDA card by default. Asking for CUDA where there is
none raises: the CPU is used only when it is named (``device=cpu``),
so a run never lands on the CPU by accident.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device=cpu to run on the CPU")
    return device

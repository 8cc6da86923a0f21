"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without a
GPU and without an explicit CPU request they raise: the port never moves to
the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``.  Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev

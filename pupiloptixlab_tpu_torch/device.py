"""Device selection for the port's entry points.

Every entry point that makes tensors takes ``device=None``, which means
the card: ``cuda`` where there is one, an error where there is none. The
CPU is used only where the caller names it (``device="cpu"``), as the
tests do; nothing drops to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises without one); anything else is
    taken as the caller's explicit choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")

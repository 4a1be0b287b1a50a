"""Device selection: an explicit device, never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device for `device`; raises RuntimeError for a CUDA device when
    no card is visible (pass device="cpu" to run the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev

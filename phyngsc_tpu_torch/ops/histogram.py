"""Per-position symbol histograms (port of phyngsc_tpu/ops/histogram.py).

position_histogram is the K1 wrapper: CUDA tensors launch the hand-written
kernel (csrc/histogram.cu), CPU tensors take position_histogram_plain.
"""

from __future__ import annotations

import torch

from phyngsc_tpu_torch import kernels


def position_histogram_plain(symbols: torch.Tensor, valid: torch.Tensor,
                             alphabet_size: int = 256) -> torch.Tensor:
    """(R, L) symbols + (R, L) validity -> (L, A) int32 counts; symbols >= A
    are not counted (they match no bin, as in the TPU kernel's one-hot)."""
    kernels.note_plain("k1_histogram", symbols)
    R, L = symbols.shape
    A = alphabet_size
    s = symbols.long()
    m = valid.bool() & (s < A)
    pos = torch.arange(L, device=symbols.device).expand(R, L)
    idx = (pos * A + s)[m]
    return torch.bincount(idx, minlength=L * A).view(L, A).to(torch.int32)


def position_histogram(symbols: torch.Tensor, valid: torch.Tensor,
                       alphabet_size: int = 256) -> torch.Tensor:
    """(R, L) uint8 symbols, (R, L) bool validity -> (L, A) int32 counts;
    the kernel reads the bool mask's own bytes."""
    if symbols.device.type == "cpu":
        return position_histogram_plain(symbols, valid, alphabet_size)
    return kernels.histogram(symbols.contiguous(), valid.contiguous(),
                             alphabet_size)


def global_histogram(symbols: torch.Tensor, valid: torch.Tensor,
                     alphabet_size: int = 256) -> torch.Tensor:
    """Whole-stream histogram: the per-position counts summed outside the
    kernel, as phyngsc_tpu/ops/histogram.py:128-134 does. (A,) int32."""
    return position_histogram(symbols, valid, alphabet_size).sum(
        dim=0, dtype=torch.int32)

"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W) and the least time a piece of work could take on it: copied
from the port's chip check (chip_smoke.py bound())."""

from __future__ import annotations

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations a second
SCALAR_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds the card could take for work that moves nbytes
    (each input read once, each output written once) and does ops
    operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)

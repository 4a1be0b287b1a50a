"""Code-table lookups and symbol grouping (port of phyngsc_tpu/ops/lookup.py).

fused_lookup is the K4 wrapper: CUDA tensors launch the hand-written table
gather (csrc/lookup.cu), CPU tensors take fused_lookup_plain. The TPU's
one-hot matmul variants exist only because XLA:TPU serializes gathers and
Pallas cannot gather from VMEM; they are not ported. Grouped code values
travel as int64 so that every shift is exact (torch's uint32 coverage is
thin).
"""

from __future__ import annotations

import numpy as np
import torch

from phyngsc_tpu_torch import kernels

#: fused entry layout: (len << CODE_BITS) | code
CODE_BITS = 12


# group_for and window_np are copied from phyngsc_tpu/ops/lookup.py:27-60
# (host code in a module that imports jax).
def group_for(max_len: int) -> int:
    """Grouping factor for group_codes: the largest k with
    k * max_len <= 32, clamped to [2, 8]."""
    return max(2, min(32 // max(max_len, 1), 8))


def window_np(counts) -> tuple:
    """Alphabet window (off, A) for a (..., 256) symbol-count array: the
    encoder slices its code tables to A in {64, 128, 256} columns starting at
    `off` (every symbol with a nonzero count is inside)."""
    c = np.asarray(counts).reshape(-1, counts.shape[-1])
    nz = np.flatnonzero(c.any(axis=0))
    if nz.size == 0:
        return 0, 64
    width = int(nz[-1]) - int(nz[0]) + 1
    for A in (64, 128, 256):
        if width <= A:
            return min(int(nz[0]), c.shape[1] - A), A
    raise AssertionError("symbol alphabet exceeds 256")


def fuse_tables(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(T, A) codes + (T, A) lens -> (T, A) int32 fused entries (< 2^16).
    Requires code < 2**CODE_BITS (max_code_len <= 12)."""
    return ((lens.long() << CODE_BITS) | codes.long()).to(torch.int32)


def fused_lookup_plain(symbols: torch.Tensor,
                       fused_tab: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: symbols (R, L), fused_tab (L, A) -> (R, L) int32,
    out[r, p] = fused_tab[p, sym[r, p]]; a symbol outside [0, A) gives 0, as
    the TPU kernel's one-hot matches no column."""
    kernels.note_plain("k4_lookup", symbols)
    L = symbols.shape[1]
    A = fused_tab.shape[1]
    s = symbols.long()
    hit = (s >= 0) & (s < A)
    pos = torch.arange(L, device=symbols.device)[None, :]
    out = fused_tab[pos, s.clamp(0, A - 1)]
    return torch.where(hit, out, 0).to(torch.int32)


def fused_lookup(symbols: torch.Tensor, fused_tab: torch.Tensor) -> torch.Tensor:
    """K4 wrapper. symbols (R, L) uint8, fused_tab (L, A) int32 fused
    entries -> (R, L) int32 (see fused_lookup_plain)."""
    if symbols.device.type == "cpu":
        return fused_lookup_plain(symbols, fused_tab)
    return kernels.lookup(symbols.contiguous(),
                          fused_tab.to(torch.int32).contiguous())


def split_fused(fused: torch.Tensor):
    """fused entries -> (codes, lens), in the entries' dtype."""
    return fused & ((1 << CODE_BITS) - 1), fused >> CODE_BITS


def group_codes(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """Combine k adjacent codes per element: (R, L) -> (R, ceil(L/k)), earlier
    symbols in the higher bits. Requires k * max_code_len <= 32 and code 0 at
    zero-length symbols, so the bit layout is unchanged."""
    pad = (-codes.shape[1]) % k
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
        lens = torch.nn.functional.pad(lens, (0, pad))
    c = codes[:, 0::k].long()
    n = lens[:, 0::k].long()
    for i in range(1, k):
        li = lens[:, i::k].long()
        c = (c << li) | codes[:, i::k].long()
        n = n + li
    return c, n


def group_fixed2(values: torch.Tensor, keep: torch.Tensor, group: int = 16):
    """Pack 2-bit symbols in groups: (R, L) values/keep -> (R, ceil(L/group))
    codes/lens; kept symbols concatenate MSB-first in position order."""
    R, L = values.shape
    pad = (-L) % group
    v = torch.nn.functional.pad(values.long(), (0, pad))
    k = torch.nn.functional.pad(keep.long(), (0, pad))
    vg = v.view(R, -1, group)
    kg = k.view(R, -1, group)
    bits_before = (torch.cumsum(kg, dim=2) - kg) * 2
    total = kg.sum(dim=2) * 2
    shift = total[:, :, None] - bits_before - 2
    contrib = torch.where(kg > 0, vg << shift.clamp(min=0), 0)
    return contrib.sum(dim=2), total

"""Code-table lookups and symbol grouping (port of phyngsc_tpu/ops/lookup.py).

On the TPU the per-position lookup is a one-hot matmul because XLA:TPU
serializes gathers; a GPU gathers freely, so fused_lookup is the plain
gather (the non-TPU branch, lookup.py:103-105). Code values travel as int64
so that every shift is exact (torch's uint32 coverage is thin).
"""

from __future__ import annotations

import numpy as np
import torch

#: fused entry layout: (len << CODE_BITS) | code
CODE_BITS = 12


# group_for and window_np are copied from phyngsc_tpu/ops/lookup.py:27-60
# (host); deduplicated once the JAX package splits its host code out.
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
    """(T, A) codes + (T, A) lens -> (T, A) int64 fused entries. Requires
    code < 2**CODE_BITS (max_code_len <= 12)."""
    return (lens.long() << CODE_BITS) | codes.long()


def fused_lookup(symbols: torch.Tensor, fused_tab: torch.Tensor) -> torch.Tensor:
    """symbols (R, L), fused_tab (L, A) -> out[r, p] = fused_tab[p, sym[r, p]]."""
    L = symbols.shape[1]
    pos = torch.arange(L, device=symbols.device)[None, :]
    return fused_tab[pos, symbols.long()]


def split_fused(fused: torch.Tensor):
    """fused entries -> (codes, lens), both int64."""
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

"""Code-table lookups and symbol grouping (port of phyngsc_tpu/ops/lookup.py).

fused_lookup is the K4 wrapper: CUDA tensors launch the hand-written table
gather (csrc/lookup.cu), CPU tensors take fused_lookup_plain. It takes the
(T, A) table of each tree and the tree of each position, where the TPU
kernel takes the (L, A) table of each position: the host fuses the tables
(fused_table_np) and the encode uploads them once. The TPU's one-hot matmul
variants exist only because XLA:TPU serializes gathers and Pallas cannot
gather from VMEM; they are not ported. Grouped code values travel as int64
so that every shift is exact (torch's uint32 coverage is thin).
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


# fused_table_np is copied from phyngsc_tpu/ops/lookup.py:33 fuse_tables
# (numpy in place of jax.numpy, uint16 entries in place of int32).
def fused_table_np(codes, lens) -> np.ndarray:
    """(T, A) codes + (T, A) lens -> (T, A) uint16 fused entries. Requires
    code < 2**CODE_BITS (max_code_len <= 12, which CodecConfig enforces),
    so every entry is below 13 << CODE_BITS."""
    return ((np.asarray(lens).astype(np.int32) << CODE_BITS)
            | np.asarray(codes).astype(np.int32)).astype(np.uint16)


def fused_lookup_plain(symbols: torch.Tensor, tab: torch.Tensor,
                       tree: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K4: symbols (R, L), tab (T, A) fused entries (int16
    holding uint16, widened with & 0xFFFF), tree (L,) tree ids or None (tree
    0 everywhere) -> (R, L) int32, out[r, p] = tab[tree[p], sym[r, p]]. An
    id >= T reads tree T - 1; a symbol outside [0, A) gives 0, as the TPU
    kernel's one-hot matches no column."""
    kernels.note_plain("k4_lookup", symbols)
    L = symbols.shape[1]
    T, A = tab.shape
    s = symbols.long()
    hit = (s >= 0) & (s < A)
    rows = (torch.zeros(L, dtype=torch.long, device=symbols.device)
            if tree is None else tree.long().clamp(0, T - 1))
    out = (tab.long() & 0xFFFF)[rows[None, :], s.clamp(0, A - 1)]
    return torch.where(hit, out, 0).to(torch.int32)


def fused_lookup(symbols: torch.Tensor, tab: torch.Tensor,
                 tree: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper. symbols (R, L) uint8, tab (T, A) int16 fused entries
    (fused_table_np), tree (L,) uint8 tree ids or None when T == 1 -> (R, L)
    int32 (see fused_lookup_plain)."""
    if symbols.device.type == "cpu":
        return fused_lookup_plain(symbols, tab, tree)
    return kernels.lookup(symbols.contiguous(), tab.contiguous(),
                          None if tree is None else tree.contiguous())


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

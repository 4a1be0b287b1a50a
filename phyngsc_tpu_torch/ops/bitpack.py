"""Bit packing and the substream LUT walks (port of phyngsc_tpu/ops/bitpack.py).

Encode: substream_layout + pack_bits_scatter in plain torch. Every symbol
owns the bit span [offset, offset + len) of its substream; disjoint spans
make add == or, so an int64 scatter_add is exact in any order.

Decode: walk_uniform (K2) and walk_masked (K3) wrap the hand-written CUDA
walks (csrc/walk.cu); CPU tensors take their plain versions, which walk all
substreams in lockstep, one step per loop iteration. Words travel as int32
tensors holding the uint32 bits, and are widened to int64 for bit work.
"""

from __future__ import annotations

import torch

from phyngsc_tpu_torch import kernels

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF


def substream_layout(lens2d: torch.Tensor, records_per_substream: int):
    """Bit offsets for (R, L) per-symbol code lengths, records grouped G at a
    time into word-aligned substreams (R a multiple of G). Returns a dict of
    bit_offsets (R, L), sub_n_words (S,), sub_word_start (S,) and
    total_words (0-d), all int64."""
    R, L = lens2d.shape
    G = records_per_substream
    assert R % G == 0, "pad R to a multiple of records_per_substream"
    S = R // G
    flat = lens2d.long().reshape(S, G * L)
    sub_n_words = (flat.sum(dim=1) + WORD_BITS - 1) // WORD_BITS
    sub_word_start = torch.cumsum(sub_n_words, dim=0) - sub_n_words
    within = torch.cumsum(flat, dim=1) - flat
    bit_offsets = (within + (sub_word_start * WORD_BITS)[:, None]).reshape(R, L)
    return {
        "bit_offsets": bit_offsets,
        "sub_n_words": sub_n_words,
        "sub_word_start": sub_word_start,
        "total_words": sub_n_words.sum(),
    }


def pack_bits_scatter(codes: torch.Tensor, lens: torch.Tensor,
                      bit_offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """(N,) codes/lens/offsets (codes < 2^32, lens <= 32) -> (n_words,) int64
    words holding uint32 values."""
    codes = codes.reshape(-1).long()
    lens = lens.reshape(-1).long()
    off = bit_offsets.reshape(-1).long()
    w = off >> 5
    r = WORD_BITS - (off & 31)           # bits left in the first word, [1, 32]
    fits = lens <= r
    hi = torch.where(fits, codes << (r - lens).clamp(min=0),
                     codes >> (lens - r).clamp(min=0)) & _MASK32
    lo = torch.where(fits, 0,
                     (codes << (WORD_BITS - (lens - r)).clamp(0, 63)) & _MASK32)
    zero = lens == 0
    hi = torch.where(zero, 0, hi)
    lo = torch.where(zero, 0, lo)
    # zero-length padding can sit exactly at the buffer end; clamp its index
    w = w.clamp(max=n_words - 1)
    words = torch.zeros(n_words + 1, dtype=torch.int64, device=codes.device)
    words.scatter_add_(0, w, hi)
    words.scatter_add_(0, w + 1, lo)
    return words[:n_words]


def word_starts(sub_n_words: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of the substream table: each lane's first word."""
    sub = sub_n_words.long()
    return torch.cumsum(sub, dim=0) - sub


def _walk_plain(words, word_start, luts, tree_step, consume, lut_bits,
                plain2):
    """The LUT walk of every lane in lockstep: step t of lane s reads the
    32-bit window at its cursor, looks (len << 9) | sym up in
    luts[tree_step[t]] (or takes (2 << 9) | top two bits when plain2), and
    emits sym and advances by len only where consume[s, t]. Reads past the
    end of `words` give 0. Returns (S, T) int64 symbols, 0 where not
    consumed."""
    S, T = consume.shape
    dev = words.device
    w = torch.cat([words.long() & _MASK32, torch.zeros(2, dtype=torch.int64,
                                                       device=dev)])
    last = w.shape[0] - 1
    wi = word_start.long().clone()
    bit = torch.zeros(S, dtype=torch.int64, device=dev)
    out = torch.zeros((S, T), dtype=torch.int64, device=dev)
    for t in range(T):
        w0 = w[wi.clamp(0, last)]
        w1 = w[(wi + 1).clamp(0, last)]
        win = ((w0 << bit) | (w1 >> (WORD_BITS - bit))) & _MASK32
        if plain2:
            e = (2 << 9) | (win >> 30)
        else:
            e = luts[tree_step[t]][win >> (WORD_BITS - lut_bits)]
        c = consume[:, t]
        out[:, t] = torch.where(c, e & 0x1FF, 0)
        bit = bit + torch.where(c, e >> 9, 0)
        wi = wi + (bit >> 5)
        bit = bit & 31
    return out


def walk_uniform_plain(words, sub_n_words, totals, luts, tree_of_pos,
                       lut_bits: int, G: int, Lt: int, L: int) -> torch.Tensor:
    """Plain version of K2: lane s decodes totals[s] symbols, step t being
    position t % Lt (tree tree_of_pos[t % Lt]) of record s*G + t // Lt.
    Returns (S*G, L) uint8, 0 past each lane's total and at positions >= Lt."""
    kernels.note_plain("k2_walk_uniform", words)
    S = sub_n_words.shape[0]
    dev = words.device
    steps = torch.arange(G * Lt, device=dev)
    consume = steps[None, :] < totals.long()[:, None]
    tree_step = tree_of_pos.long()[:Lt].repeat(G)
    syms = _walk_plain(words, word_starts(sub_n_words), luts.long(),
                       tree_step, consume, lut_bits, False)
    out = torch.zeros((S * G, L), dtype=torch.uint8, device=dev)
    out[:, :Lt] = syms.reshape(S * G, Lt).to(torch.uint8)
    return out


def walk_uniform(words, sub_n_words, totals, luts, tree_of_pos,
                 lut_bits: int, G: int, Lt: int, L: int) -> torch.Tensor:
    """K2 wrapper. words (N,) int32 (uint32 bits), sub_n_words (S,), totals
    (S,) symbols per lane, luts (n_trees, 2^lut_bits) int32 entries
    (len << 9) | sym, tree_of_pos (>= Lt,) int32. Returns (S*G, L) uint8."""
    if words.device.type == "cpu":
        return walk_uniform_plain(words, sub_n_words, totals, luts,
                                  tree_of_pos, lut_bits, G, Lt, L)
    return kernels.walk_uniform(
        words.contiguous(), word_starts(sub_n_words).contiguous(),
        totals.to(torch.int32).contiguous(), luts.to(torch.int32).contiguous(),
        tree_of_pos.to(torch.int32).contiguous(), lut_bits, G, Lt, L)


def walk_masked_plain(words, sub_n_words, keep, luts, tree_of_pos,
                      lut_bits: int, plain2: bool) -> torch.Tensor:
    """Plain version of K3: slot t of lane s consumes the lane's next symbol
    only where keep[s, t] is set, looking it up in tree tree_of_pos[t % L]
    (clamped to the tree count) of luts. keep (S, T); luts (n_trees,
    2^lut_bits) int32 and tree_of_pos (L,) with L dividing T, or both None
    for plain2 (fixed 2-bit codes). Returns (S, T) uint8, 0 where keep is
    unset."""
    kernels.note_plain("k3_walk_masked", words)
    S, T = keep.shape
    tree_step = torch.zeros(T, dtype=torch.int64, device=words.device)
    if not plain2:
        luts = luts.long()
        tid = tree_of_pos.long().clamp(0, luts.shape[0] - 1)
        tree_step = tid.repeat(T // tid.shape[0])
    syms = _walk_plain(words, word_starts(sub_n_words), luts, tree_step,
                       keep.bool(), lut_bits, plain2)
    return syms.to(torch.uint8)


def walk_masked(words, sub_n_words, keep, luts, tree_of_pos, lut_bits: int,
                plain2: bool) -> torch.Tensor:
    """K3 wrapper; see walk_masked_plain."""
    if words.device.type == "cpu":
        return walk_masked_plain(words, sub_n_words, keep, luts, tree_of_pos,
                                 lut_bits, plain2)
    keep8 = keep.to(torch.uint8).contiguous()
    totals = keep8.sum(dim=1, dtype=torch.int32)
    if not plain2:
        luts = luts.to(torch.int32).contiguous()
        tree_of_pos = tree_of_pos.to(torch.int32).contiguous()
    return kernels.walk_masked(
        words.contiguous(), word_starts(sub_n_words).contiguous(), totals,
        keep8, luts, tree_of_pos, lut_bits, plain2)

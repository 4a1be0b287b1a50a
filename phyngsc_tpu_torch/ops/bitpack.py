"""Bit packing and the substream LUT walks (port of phyngsc_tpu/ops/bitpack.py).

Encode: substream_layout + pack_bits_scatter in plain torch. Every symbol
owns the bit span [offset, offset + len) of its substream; disjoint spans
make add == or, so an int64 scatter_add is exact in any order.

Decode: dense_words (K5, csrc/densify.cu) lays the linear word stream out
as the (Wmax, Sp) lane-minor plane, word w of lane s at [w, s], and
walk_uniform (K2) and walk_masked (K3) walk that plane (csrc/walk.cu); CPU
tensors take the plain versions, the walks stepping all lanes in lockstep,
one step per loop iteration. The walks take their LUTs as WalkLuts
(walk_luts): the full int32 tables, which the plain versions read, and, for
CUDA tensors, the 16-bit two-level tables that the kernels stage in shared
memory (two_level_luts): the decode builds both on the device from the
code lengths (ops/tables.py, K6), the models' callers on the host from
host LUTs (walk_tables). Words travel as int32 tensors holding the uint32 bits, and
are widened to int64 for bit work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.device import upload
from phyngsc_tpu_torch.ops.bitpack_host import dense_geometry

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


def lane_words_max(G: int, L: int, max_code_len: int) -> int:
    """The most words a lane of a well-formed sub-block holds: G records of
    at most L symbols, each code at most max_code_len bits, one word of
    slack."""
    return -(-G * L * max_code_len // WORD_BITS) + 1


def plane_geometry(sub_n_words: np.ndarray, G: int, L: int,
                   max_code_len: int) -> tuple:
    """(Wmax, Sp) of the walk plane for a host substream table
    (bitpack_host.dense_geometry: lanes padded to 128, rows bucketed to
    256). Raises ValueError, before anything is allocated for the table, on
    a lane longer than lane_words_max(G, L, max_code_len), which only a
    corrupt table holds."""
    sub = np.asarray(sub_n_words)
    limit = lane_words_max(G, L, max_code_len)
    if sub.size and int(sub.max()) > limit:
        raise ValueError(f"corrupt substream table: a lane of "
                         f"{int(sub.max())} words, more than {limit}")
    return dense_geometry(sub)


def lane_table(sub_n_words: np.ndarray) -> np.ndarray:
    """(2, S) int64 lane table of a host substream table, which
    plane_geometry has checked: row 0 each lane's first word (the exclusive
    prefix sum), row 1 its word count. dense_words takes it uploaded, in one
    copy."""
    out = np.empty((2, np.shape(sub_n_words)[0]), np.int64)
    out[1] = sub_n_words
    np.cumsum(out[1], out=out[0])
    out[0] -= out[1]
    return out


def dense_words_plain(words: torch.Tensor, lanes: torch.Tensor, Wmax: int,
                      Sp: int) -> torch.Tensor:
    """Plain version of K5: (N,) int32 linear words and the (2, S) int64
    lane table (lane_table: start, count) -> (Wmax, Sp) int32 plane,
    out[w, s] = words[start[s] + w] for w < count[s], 0 elsewhere: past a
    lane's words, in pad lanes s >= S and where start[s] + w lies outside
    the words."""
    kernels.note_plain("k5_densify", words)
    start, sub = lanes[0].long(), lanes[1].long()
    S, n = sub.shape[0], words.shape[0]
    w = torch.arange(Wmax, device=words.device)[:, None]
    src = start[None, :] + w
    ok = (w < sub[None, :]) & (src >= 0) & (src < n)
    padded = torch.cat([words, words.new_zeros(1)])
    out = torch.zeros((Wmax, Sp), dtype=torch.int32, device=words.device)
    out[:, :S] = padded[torch.where(ok, src, n)]
    return out


def dense_words(words: torch.Tensor, lanes: torch.Tensor, Wmax: int,
                Sp: int) -> torch.Tensor:
    """K5 wrapper: see dense_words_plain. words (N,) int32 and lanes, the
    (2, S) int64 lane_table of the stream's host substream table, on one
    device; Wmax and Sp come from plane_geometry of that table. On the card
    the call is one launch, with no device op around it."""
    if words.device.type == "cpu":
        return dense_words_plain(words, lanes, Wmax, Sp)
    return kernels.densify(words, lanes, Wmax, Sp)


#: bit 15 of a two-level entry: look further (a primary entry names a
#: secondary block, a secondary entry sends the lookup to the full LUT)
ESCAPE = 0x8000


def two_level_luts(luts, lut_bits: int, budget: int):
    """The kernels' shared-memory form of (n_trees, 2^lut_bits) int32 LUTs
    whose entries are (len << 9) | sym: one uint16 array holding a
    (n_trees, 2^k) primary table, then secondary blocks of 2^d entries,
    d = lut_bits - k, in at most `budget` bytes. Let i be a window's top
    lut_bits bits and j = i >> d its top k bits. Where every entry of tree t
    under prefix j is the same value below 2^15, primary[t, j] is that
    value; else primary[t, j] = ESCAPE | b, and secondary block b holds the
    tree's entries i of that prefix, each the full LUT's value, or ESCAPE
    where it does not fit 15 bits (no table built from code lengths has
    one), for which the kernel reads the full LUT. So the lookup equals the
    full LUT for every window and any int32 contents.

    k is the largest whose primaries and blocks all fit. Where no k leaves
    room for a block per escaped prefix, the escaped prefixes take blocks in
    tree-major order while they fit, the rest point at one shared block of
    ESCAPE entries, and k is the one that sends the fewest prefixes to the
    full LUT (under a prefix code every prefix is about equally likely).
    Where not even k = 1 fits, k = 0 and the table is empty: the kernels
    then read every entry from the full LUT. Returns (table padded with
    zeros to a multiple of 8 entries, which a budget that is a multiple of
    16 bytes holds too, k, n_primary = n_trees << k, or 0 when k = 0)."""
    luts = np.asarray(luts, dtype=np.int32)
    n_trees, V = luts.shape
    if V != 1 << lut_bits or n_trees < 1:
        raise ValueError(f"LUTs of shape {luts.shape} for {lut_bits} bits")
    room = budget // 2
    fits = luts.view(np.uint32) < ESCAPE  # in [0, 2^15)
    # direct[t, j]: the 2^d entries of tree t under prefix j are one value
    # that fits, first[t, j]; each step to a smaller k halves both
    direct, first = fits, luts
    best = None  # (share of prefixes left to the full LUT, k, direct,
    #              first, blocks of their own)
    for k in range(lut_bits, 0, -1):
        d = lut_bits - k
        if d:
            u = direct.reshape(n_trees, -1, 2)
            v = first.reshape(n_trees, -1, 2)
            direct = u[..., 0] & u[..., 1] & (v[..., 0] == v[..., 1])
            first = v[..., 0]
        n_esc = int(direct.size - np.count_nonzero(direct))
        if (n_trees << k) + (n_esc << d) <= room and n_esc <= ESCAPE:
            best = (0, k, direct, first, n_esc)
            break
        free = room - (n_trees << k) - (1 << d)  # beside the shared block
        if free >= 0:
            own = min(free >> d, ESCAPE - 1)
            lost = (n_esc - own) / (n_trees << k)
            if best is None or lost < best[0]:
                best = (lost, k, direct, first, own)
    if best is None:
        return np.zeros(0, dtype=np.uint16), 0, 0
    _, k, direct, first, own = best
    d = lut_bits - k
    escaped = ~direct
    n_esc = int(np.count_nonzero(escaped))
    n_blocks = own + (own < n_esc)  # the shared block last
    n = (n_trees << k) + (n_blocks << d)
    table = np.zeros(-(-n // 8) * 8, dtype=np.uint16)
    primary = table[:n_trees << k].reshape(direct.shape)
    primary[...] = first
    primary[escaped] = ESCAPE + np.minimum(np.arange(n_esc), own)
    blocks = luts.reshape(n_trees, 1 << k, 1 << d)[escaped][:own]
    sec = table[n_trees << k:n]
    sec[...] = ESCAPE
    sec[:own << d] = np.where(
        fits.reshape(n_trees, 1 << k, 1 << d)[escaped][:own], blocks,
        ESCAPE).ravel()
    return table, k, n_trees << k


def two_level_entry(table: torch.Tensor, k: int, n_primary: int,
                    lut_bits: int, luts: torch.Tensor, tree: torch.Tensor,
                    win: torch.Tensor) -> torch.Tensor:
    """The kernels' lookup (csrc/walk.cu Tables) in plain torch: the entry
    of tree `tree` for 32-bit windows `win` (int64 tensors of one shape),
    from two_level_luts' table (int64 values) and, for flagged entries or
    when k = 0, the full luts."""
    i = win >> (32 - lut_bits)
    if k == 0:
        return luts[tree, i]
    d = lut_bits - k
    e = table[(tree << k) + (win >> (32 - k))]
    esc = (e & ESCAPE) != 0
    sec = table[torch.where(esc, n_primary + ((e & ~ESCAPE) << d)
                            + (i & ((1 << d) - 1)), 0)]
    e = torch.where(esc, sec, e)
    glob = esc & ((sec & ESCAPE) != 0)
    return torch.where(glob, luts[tree, i], e)


@dataclasses.dataclass
class WalkLuts:
    """A sub-block's decode LUTs as the walks take them (see walk_luts)."""

    full: torch.Tensor    # (n_trees, 2^lut_bits) int32 (len << 9) | sym
    lut_bits: int
    #: two_level_luts' table as int16 holding uint16, its k and n_primary;
    #: built for CUDA tensors only (the plain versions read full)
    packed: torch.Tensor | None = None
    k: int = 0
    n_primary: int = 0

    @property
    def n_trees(self) -> int:
        return int(self.full.shape[0])


def walk_tables(luts, lut_bits: int, cuda: bool, n_ids: int = 1) -> tuple:
    """The host half of walk_luts: (full, packed, k, n_primary). full: the
    (n_trees, 2^lut_bits) int32 LUTs (a single (2^lut_bits,) LUT is one
    tree); for a CUDA device, packed is their two-level form
    (two_level_luts) as int16 holding the uint16 entries, sized for the
    shared memory that a walk block leaves beside n_ids tree ids (K2: Lt,
    K3: kernels.masked_ids(L); kernels.table_budget), with its k and
    n_primary; else (None, 0, 0)."""
    full = np.ascontiguousarray(luts, dtype=np.int32)
    if full.ndim == 1:
        full = full[None, :]
    if not cuda:
        return full, None, 0, 0
    table, k, n_primary = two_level_luts(full, lut_bits,
                                         kernels.table_budget(n_ids))
    return full, table.view(np.int16), k, n_primary


def walk_luts(luts, lut_bits: int, device, n_ids: int = 1) -> WalkLuts:
    """Host LUTs -> WalkLuts on `device`: walk_tables' tables, built on
    the host and uploaded, so that nothing waits on the device. A WalkLuts
    (the decode's, built on the device by ops/tables.py) is taken as it
    is."""
    if isinstance(luts, WalkLuts):
        return luts
    full, packed, k, n_primary = walk_tables(
        luts, lut_bits, torch.device(device).type == "cuda", n_ids)
    if packed is None:
        return WalkLuts(upload([full], device)[0], lut_bits)
    full_d, packed_d = upload([full, packed], device)
    return WalkLuts(full_d, lut_bits, packed_d, k, n_primary)


def _walk_plain(plane, luts, tree_step, consume, lut_bits, plain2):
    """The LUT walk of lanes 0..S-1 of the (Wmax, Sp) plane in lockstep:
    step t of lane s reads the 32-bit window at its cursor, looks
    (len << 9) | sym up in luts[tree_step[t]] (or takes (2 << 9) | top two
    bits when plain2), and emits sym and advances by len only where
    consume[s, t]. Reads past row Wmax give 0. Returns (S, T) int64
    symbols, 0 where not consumed. The steps run in numpy on the host, one
    vector of lanes a step; a step that no lane consumes changes nothing
    and is left out."""
    S, T = consume.shape
    mask = int(_MASK32)
    w = np.concatenate([plane[:, :S].cpu().numpy().astype(np.int64) & mask,
                        np.zeros((2, S), np.int64)])
    last = w.shape[0] - 1
    lut = None if plain2 else luts.cpu().numpy().astype(np.int64)
    ts = None if plain2 else tree_step.cpu().numpy()
    con = consume.cpu().numpy()
    lanes = np.arange(S)
    wi = np.zeros(S, np.int64)
    bit = np.zeros(S, np.int64)
    out = np.zeros((S, T), np.int64)
    shift = WORD_BITS - lut_bits
    for t in np.flatnonzero(con.any(axis=0)):
        w0 = w[np.minimum(wi, last), lanes]
        w1 = w[np.minimum(wi + 1, last), lanes]
        win = ((w0 << bit) | (w1 >> (WORD_BITS - bit))) & mask
        e = (2 << 9) | (win >> 30) if plain2 else lut[ts[t]][win >> shift]
        c = con[:, t]
        out[:, t] = np.where(c, e & 0x1FF, 0)
        bit += np.where(c, e >> 9, 0)
        wi += bit >> 5
        bit &= 31
    return torch.from_numpy(out).to(plane.device)


def walk_uniform_plain(plane, totals, luts, tree_of_pos, lut_bits: int,
                       G: int, Lt: int, L: int) -> torch.Tensor:
    """Plain version of K2: lane s < S = len(totals) of the (Wmax, Sp) plane
    decodes totals[s] symbols, step t being position t % Lt (tree
    tree_of_pos[t % Lt]) of record s*G + t // Lt. Returns (S*G, L) uint8, 0
    past each lane's total and at positions >= Lt."""
    kernels.note_plain("k2_walk_uniform", plane)
    S = totals.shape[0]
    dev = plane.device
    steps = torch.arange(G * Lt, device=dev)
    consume = steps[None, :] < totals.long()[:, None]
    tree_step = tree_of_pos.long()[:Lt].repeat(G)
    syms = _walk_plain(plane, luts.long(), tree_step, consume, lut_bits,
                       False)
    out = torch.zeros((S * G, L), dtype=torch.uint8, device=dev)
    out[:, :Lt] = syms.reshape(S * G, Lt).to(torch.uint8)
    return out


def walk_uniform(plane, totals, luts: WalkLuts, tree_of_pos, G: int,
                 Lt: int, L: int) -> torch.Tensor:
    """K2 wrapper. plane (Wmax, Sp) int32 (uint32 bits) from dense_words,
    totals (S,) symbols per lane, luts from walk_luts, tree_of_pos (>= Lt,)
    int32. Returns (S*G, L) uint8."""
    if plane.device.type == "cpu":
        return walk_uniform_plain(plane, totals, luts.full, tree_of_pos,
                                  luts.lut_bits, G, Lt, L)
    return kernels.walk_uniform(
        plane.contiguous(), totals.to(torch.int32).contiguous(), luts,
        tree_of_pos.to(torch.int32).contiguous(), G, Lt, L)


def walk_masked_plain(plane, keep, luts, tree_of_pos, lut_bits: int,
                      plain2: bool) -> torch.Tensor:
    """Plain version of K3: slot t of lane s < S = len(keep) of the
    (Wmax, Sp) plane consumes the lane's next symbol only where keep[s, t]
    is set, looking it up in tree tree_of_pos[t % L] (clamped to the tree
    count) of luts. keep (S, T); luts (n_trees, 2^lut_bits) int32 and
    tree_of_pos (L,) with L dividing T, or both None for plain2 (fixed
    2-bit codes). Returns (S, T) uint8, 0 where keep is unset."""
    kernels.note_plain("k3_walk_masked", plane)
    S, T = keep.shape
    tree_step = torch.zeros(T, dtype=torch.int64, device=plane.device)
    if not plain2:
        luts = luts.long()
        tid = tree_of_pos.long().clamp(0, luts.shape[0] - 1)
        tree_step = tid.repeat(T // tid.shape[0])
    syms = _walk_plain(plane, luts, tree_step, keep.bool(), lut_bits, plain2)
    return syms.to(torch.uint8)


def walk_masked(plane, keep, luts: WalkLuts | None, tree_of_pos,
                plain2: bool) -> torch.Tensor:
    """K3 wrapper; see walk_masked_plain. luts from walk_luts, or None with
    tree_of_pos for plain2."""
    if plane.device.type == "cpu":
        if plain2:  # fixed 2-bit codes: no table
            return walk_masked_plain(plane, keep, None, None, 2, True)
        return walk_masked_plain(plane, keep, luts.full, tree_of_pos,
                                 luts.lut_bits, False)
    keep8 = keep.to(torch.uint8).contiguous()
    totals = keep8.sum(dim=1, dtype=torch.int32)
    if not plain2:
        tree_of_pos = tree_of_pos.to(torch.int32).contiguous()
    return kernels.walk_masked(plane.contiguous(), totals, keep8, luts,
                               tree_of_pos, plain2)

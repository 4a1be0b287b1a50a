"""The decode's walk tables built on the device from code lengths (port of
phyngsc_tpu/ops/bitpack.py lut_runs_device / luts_from_lens_device).

The decode uploads each stream's canonical code lengths as nibbles
(lens_wire: bitpack_host.pack_lens4_np, T * 33 uint32 words) and builds
its tables where the walks read them: K6 (csrc/tables.cu) on a CUDA
device, one launch for both streams of a sub-block (walk_luts_both),
luts_from_lens_plain on the CPU. The walks take a bitpack.WalkLuts:
the full (T, 2^lut_bits) int32 LUTs of (len << 9) | sym entries, and, for
CUDA tensors, bitpack.two_level_luts' 16-bit two-level table.

Where the two-level table's escapes fall follows from the lengths alone,
so the host lays it out (two_level_layout) from each tree's count of
codes of each length, without the LUTs: canonical codes put the codes
longer than k bits in one contiguous tail of the window space, and a
k-bit prefix needs a secondary block exactly where that tail touches it.
The device then fills the table from the LUTs it built (two_level_plain,
or K6 in the same launch), and nothing waits on the device to pick k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.ops.bitpack import ESCAPE, WalkLuts
from phyngsc_tpu_torch.ops.bitpack_host import pack_lens4_np

#: symbols of a tree, and the code lengths a nibble holds
SYMBOLS = 256
N_LENS = 16


def _unpack_lens(lens_words: torch.Tensor, T: int) -> torch.Tensor:
    """(T * 32,) nibble words (int32 holding uint32) -> (T, 256) int64
    code lengths."""
    w = (lens_words[:T * 32].long() & 0xFFFFFFFF).reshape(T, 32)
    sh = 28 - 4 * torch.arange(8, device=w.device)
    return ((w[:, :, None] >> sh) & 0xF).reshape(T, SYMBOLS)


def lut_runs_plain(lens_words: torch.Tensor, singles: torch.Tensor, T: int,
                   V: int) -> tuple:
    """Port of lut_runs_device: T trees' nibble words and their (T,)
    singleton symbols (int32, -1 where none) -> the LUT runs in canonical
    order, (starts (T, 256), deltas (T, 256)) int32. Symbol i's run starts
    at the Kraft sum of its (len, sym) predecessors, and the LUT's value at
    window w is the sum of the deltas of the runs that start at or before
    w; absent symbols start at the Kraft end, where the first one's delta
    zeroes the rest of an incomplete code. A singleton tree is one run over
    every window carrying its symbol."""
    B = (V - 1).bit_length()
    dev = lens_words.device
    lens = _unpack_lens(lens_words, T)
    sym = torch.arange(SYMBOLS, device=dev).expand(T, SYMBOLS)
    key = torch.where(lens > 0, lens * 512 + sym, 1 << 20)
    order = torch.argsort(key, dim=1, stable=True)
    ssym = torch.gather(sym, 1, order)
    slens = torch.gather(lens, 1, order)
    wk = torch.where(slens > 0, 1 << (B - slens.clamp(max=B)), 0)
    start = torch.cumsum(wk, dim=1) - wk
    entry = torch.where(slens > 0, (slens << 9) | ssym, 0)
    prev = torch.cat([entry.new_zeros((T, 1)), entry[:, :-1]], dim=1)
    deltas = entry - prev
    singles = singles.long()[:, None]
    single_row = singles >= 0
    col0 = torch.arange(SYMBOLS, device=dev)[None, :] == 0
    start = torch.where(single_row, torch.where(col0, 0, V), start)
    deltas = torch.where(single_row, torch.where(col0, singles, 0), deltas)
    return start.int(), deltas.int()


def luts_from_lens_plain(lens_words: torch.Tensor, singles: torch.Tensor,
                         T: int, V: int) -> torch.Tensor:
    """Port of luts_from_lens_device, the plain version of K6's full LUTs:
    -> (T, V) int32 (len << 9) | sym, equal to huffman.decode_lut_batch's
    but for one case that the JAX package's device build keeps: an
    incomplete code that holds all 256 symbols has no absent symbol to
    zero the windows past its Kraft end, which repeat its last code's
    entry (windows that no well-formed stream reaches). Runs that start at
    or past V are dropped, as the JAX scatter drops them."""
    kernels.note_plain("k6_tables", lens_words)
    start, deltas = lut_runs_plain(lens_words, singles, T, V)
    grid = torch.zeros((T, V + 1), dtype=torch.int64, device=lens_words.device)
    grid.scatter_add_(1, start.long().clamp(max=V), deltas.long())
    return torch.cumsum(grid[:, :V], dim=1).int()


@dataclasses.dataclass(frozen=True)
class Layout:
    """bitpack.two_level_luts' table shape for a set of trees, from their
    code lengths: k (0: no table), n_primary = n_trees << k (0 when k = 0),
    `own` escaped prefixes with a secondary block of their own, n_blocks
    blocks in all (own, and the shared block of escapes where some escaped
    prefix has none), n entries padded to a multiple of 8, and trees, the
    (3, n_trees) int32 per-tree rows: the first escaped prefix, the count of
    escaped prefixes (a contiguous range), the first one's block."""

    k: int
    n_primary: int
    own: int
    n_blocks: int
    n: int
    trees: np.ndarray


def two_level_layout(lens2d, singletons, lut_bits: int,
                     budget: int) -> Layout:
    """The Layout of two_level_luts(LUTs of lens2d, lut_bits, budget),
    computed from each tree's count of codes of each length. A code of
    length l (capped at lut_bits, as the LUT build caps it) covers
    2^(lut_bits - l) windows, in (len, sym) order from window 0. Under k
    bits, the codes of length <= k cover whole prefixes, each one value;
    the longer ones follow from window A_k, a prefix boundary, to the
    Kraft end E, and every prefix they touch holds two values or more (two
    codes, or a code and the zeros after an incomplete code): prefixes
    A_k >> d .. ceil(min(E, V) / 2^d) - 1, d = lut_bits - k, are escaped.
    Where an incomplete code holds all 256 symbols, its last run reaches V
    (luts_from_lens_plain), so the prefixes wholly inside it are direct and
    the escapes end at ceil(its start / 2^d). A singleton or empty tree is
    one value everywhere. The choice of k and of the blocks is
    two_level_luts' own, on those counts. The entries of tables built from
    code lengths all fit 15 bits, so the layout needs no LUT; a singleton
    symbol that would not raises ValueError."""
    lens = np.asarray(lens2d, np.int64)
    single = np.asarray(singletons, np.int64).reshape(-1)
    T = lens.shape[0]
    V = 1 << lut_bits
    if T < 1 or lens.shape != (T, SYMBOLS) or single.shape != (T,):
        raise ValueError(f"two_level_layout: lengths of shape {lens.shape}, "
                         f"{single.shape[0]} singletons")
    if int(single.max()) >= ESCAPE:
        raise ValueError("corrupt table: singleton symbol out of range")
    counts = np.bincount((lens + N_LENS * np.arange(T)[:, None]).ravel(),
                         minlength=N_LENS * T).reshape(T, N_LENS)
    counts[:, 0] = 0
    counts[single >= 0] = 0
    ln = np.arange(N_LENS)
    width = np.where(ln > 0, 1 << (lut_bits - np.minimum(ln, lut_bits)), 0)
    kraft = np.cumsum(counts * width, axis=1)   # [:, l]: lengths <= l
    end = np.minimum(kraft[:, -1], V)
    # all 256 present, incomplete: the escapes end where the last run starts
    last = N_LENS - 1 - np.argmax(counts[:, ::-1] > 0, axis=1)
    open_tail = (counts.sum(axis=1) == SYMBOLS) & (end < V)
    end = np.where(open_tail, end - width[last], end)
    # per k = 1 .. lut_bits: each tree's first escaped prefix and count
    ks = np.arange(1, lut_bits + 1)
    d = lut_bits - ks
    lo = np.minimum(kraft[:, np.minimum(ks, N_LENS - 1)], V) >> d
    hi = (end[:, None] + (1 << d) - 1) >> d
    n_esc_t = np.maximum(hi - lo, 0)
    n_esc_k = n_esc_t.sum(axis=0)
    room = budget // 2
    best = None  # (share of prefixes left to the full LUT, k, own)
    for k in range(lut_bits, 0, -1):
        dk, n_esc = lut_bits - k, int(n_esc_k[k - 1])
        if (T << k) + (n_esc << dk) <= room and n_esc <= ESCAPE:
            best = (0, k, n_esc)
            break
        free = room - (T << k) - (1 << dk)  # beside the shared block
        if free >= 0:
            own = min(free >> dk, ESCAPE - 1)
            lost = (n_esc - own) / (T << k)
            if best is None or lost < best[0]:
                best = (lost, k, own)
    if best is None:
        return Layout(0, 0, 0, 0, 0, np.zeros((3, T), np.int32))
    _, k, own = best
    dk = lut_bits - k
    count = n_esc_t[:, k - 1]
    n_esc = int(count.sum())
    n_blocks = own + (own < n_esc)
    trees = np.stack([lo[:, k - 1], count, np.cumsum(count) - count])
    n = (T << k) + (n_blocks << dk)
    return Layout(k, T << k, own, n_blocks, -(-n // 8) * 8,
                  trees.astype(np.int32))


def two_level_plain(full: torch.Tensor, trees: torch.Tensor, layout: Layout,
                    lut_bits: int) -> torch.Tensor:
    """The plain version of K6's two-level table: bitpack.two_level_luts'
    table for the (T, 2^lut_bits) int32 LUTs `full`, filled from the
    Layout (its per-tree rows `trees` as a tensor beside full) -> (n,)
    int16 holding the uint16 entries. A prefix outside its tree's escaped
    range is its first window's entry; an escaped one is ESCAPE | its
    block, or the shared block past `own`; block b holds its prefix's
    entries (ESCAPE where one does not fit 15 bits)."""
    k = layout.k
    if k == 0:
        return torch.zeros(0, dtype=torch.int16, device=full.device)
    T = full.shape[0]
    d = lut_bits - k
    dev = full.device
    trees = trees.long()
    lo, cnt, base = trees[0][:, None], trees[1][:, None], trees[2][:, None]
    j = torch.arange(1 << k, device=dev)[None, :]
    esc = (j >= lo) & (j < lo + cnt)
    e = full.long() & 0xFFFFFFFF
    primary = torch.where(esc, ESCAPE + (base + j - lo).clamp(max=layout.own),
                          e[:, ::1 << d])
    table = torch.zeros(layout.n, dtype=torch.int64, device=dev)
    table[:T << k] = primary.reshape(-1)
    sec_end = layout.n_primary + (layout.n_blocks << d)
    table[layout.n_primary:sec_end] = ESCAPE
    t_idx, j_idx = esc.nonzero(as_tuple=True)  # tree-major: block order
    t_idx, j_idx = t_idx[:layout.own], j_idx[:layout.own]
    blocks = e.reshape(T, 1 << k, 1 << d)[t_idx, j_idx]
    table[layout.n_primary:layout.n_primary + (layout.own << d)] = torch.where(
        blocks < ESCAPE, blocks, ESCAPE).reshape(-1)
    return torch.where(table >= 0x8000, table - 0x10000, table).to(torch.int16)


@dataclasses.dataclass
class LensWire:
    """A stream's decode tables as the decode uploads them: the lens4
    words (pack_lens4_np as int32, T * 33) and the two-level Layout the
    host laid out for them, whose per-tree rows travel beside the words
    (K6 reads them; the CPU's walks read the full LUTs alone)."""

    words: np.ndarray
    n_trees: int
    lut_bits: int
    layout: Layout

    def pieces(self) -> list:
        """The upload's pieces: the words, then the layout's rows."""
        return [self.words, self.layout.trees]


def lens_wire(lens2d, singletons, lut_bits: int, n_ids: int = 1) -> LensWire:
    """Host code lengths (T, 256) and singletons -> their LensWire, the
    layout sized for the shared memory a walk block leaves beside n_ids
    tree ids (kernels.table_budget: K2 Lt, K3 kernels.masked_ids(L)). No
    trees (an empty quality stream) take one empty tree, as the JAX
    package's decode does. A code length >= 16 raises ValueError here,
    before anything is uploaded."""
    lens = np.asarray(lens2d)
    single = np.asarray(singletons, np.int32).reshape(-1)
    if not lens.shape[0]:
        lens, single = np.zeros((1, SYMBOLS), np.uint8), np.full(1, -1,
                                                                 np.int32)
    words = pack_lens4_np(lens, single).view(np.int32)
    layout = two_level_layout(lens, single, lut_bits,
                              kernels.table_budget(n_ids))
    return LensWire(words, lens.shape[0], lut_bits, layout)


def walk_luts_both(q: tuple, d: tuple | None = None) -> tuple:
    """Both streams' WalkLuts of a sub-block, built on their device from
    their uploaded pieces: q and d are (LensWire, words, rows), d None
    where the DNA stream is plain; both at one lut_bits -> (quality
    WalkLuts, DNA WalkLuts or None). On a CUDA device one K6 launch over
    both streams' trees builds the full LUTs and the two-level tables; on
    the CPU each stream's plain full LUTs (the CPU's walks read nothing
    else)."""
    streams = [q] if d is None else [q, d]
    bits = q[0].lut_bits
    if any(wire.lut_bits != bits for wire, _, _ in streams):
        raise ValueError("walk_luts_both: the streams' lut_bits differ")
    if q[1].device.type == "cpu":
        out = [WalkLuts(luts_from_lens_plain(words, words[wire.n_trees * 32:],
                                             wire.n_trees, 1 << bits), bits)
               for wire, words, _ in streams]
    else:
        built = kernels.decode_tables(bits, [
            (words, wire.n_trees, rows if wire.layout.k else None,
             wire.layout.k, wire.layout.own, wire.layout.n_blocks,
             wire.layout.n) for wire, words, rows in streams])
        out = [WalkLuts(full, bits, packed, wire.layout.k,
                        wire.layout.n_primary)
               for (wire, _, _), (full, packed) in zip(streams, built)]
    return out[0], out[1] if d is not None else None


def walk_luts(wire: LensWire, words: torch.Tensor,
              rows: torch.Tensor) -> WalkLuts:
    """One stream's WalkLuts: walk_luts_both of that stream alone."""
    return walk_luts_both((wire, words, rows))[0]


def walk_luts_plain(wire: LensWire, words: torch.Tensor,
                    rows: torch.Tensor) -> WalkLuts:
    """K6's plain version on any device: the same WalkLuts as walk_luts
    gives on a CUDA device, from luts_from_lens_plain and two_level_plain
    (the card's tests and chip_smoke hold K6 to it)."""
    T, bits = wire.n_trees, wire.lut_bits
    full = luts_from_lens_plain(words, words[T * 32:], T, 1 << bits)
    lay = wire.layout
    packed = two_level_plain(full, rows, lay, bits)
    return WalkLuts(full, bits, packed, lay.k, lay.n_primary)

"""Quality stream codec: per-position Huffman models (port of
phyngsc_tpu/models/quality.py).

analyze runs on K1 (ops/histogram.py); encode is the per-position code
lookup on K4 (ops/lookup.py), then grouping and the scatter pack in plain
torch; decode_walk (uniform lengths) runs on K2 and decode_walk_masked
(variable lengths) on K3 (ops/bitpack.py). Table building and the stream
header are host code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import huffman
from phyngsc_tpu.utils.bitio import (BitReader, BitWriter, bit_length,
                                     get_uint_array, put_uint_array)
from phyngsc_tpu_torch.ops import bitpack, histogram, lookup

ALPHABET = 256
MAX_TREES = 256


# QualityTables, tree_group_ids, _table_cost_bits, _tables_bits,
# lens_rows_for, build_tables_adaptive, build_tables, write_header and
# read_header are copied from phyngsc_tpu/models/quality.py (host code in a
# module that imports jax).
@dataclasses.dataclass
class QualityTables:
    lens: np.ndarray        # (T, 256) uint8 code lengths (0 = absent)
    codes: np.ndarray       # (T, 256) uint32 canonical codes
    singletons: np.ndarray  # (T,) int32 — sym of zero-bit trees, else -1

    @property
    def n_trees(self) -> int:
        return int(self.lens.shape[0])

    def luts(self, lut_bits: int) -> np.ndarray:
        sym, ln = huffman.decode_lut_batch(self.lens, lut_bits, self.singletons)
        return np.asarray((ln.astype(np.int32) << 9) | sym.astype(np.int32))


def valid_mask(lens: torch.Tensor, L: int) -> torch.Tensor:
    return torch.arange(L, device=lens.device)[None, :] < lens[:, None]


def tree_of_position(pos: torch.Tensor, n_trees: int, L: int = 0,
                     legacy: bool = False) -> torch.Tensor:
    """Position -> quality tree index: 1:1 with the tail clamped for reads
    <= MAX_TREES bp and every v1-v3 container, else proportional grouping
    pos * n_trees // L (container v4+)."""
    if legacy or not L or n_trees >= L:
        return pos.clamp(max=n_trees - 1)
    return ((pos * n_trees) // L).clamp(max=n_trees - 1)


def tree_group_ids(L: int, n_trees: int) -> np.ndarray:
    """Static position -> tree map for grouping histograms (encode side)."""
    return (np.arange(L, dtype=np.int64) * n_trees // L).astype(np.int32)


# -- analyze ----------------------------------------------------------------

def analyze(qual: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(R, L) symbols + (R,) record lengths -> (min(L, MAX_TREES), 256) int32
    counts; long reads sum adjacent positions by tree_group_ids."""
    L = qual.shape[1]
    counts = histogram.position_histogram(qual, valid_mask(lens, L), ALPHABET)
    if L > MAX_TREES:
        gid = torch.from_numpy(tree_group_ids(L, MAX_TREES)).long().to(
            counts.device)
        grouped = torch.zeros((MAX_TREES, ALPHABET), dtype=torch.int32,
                              device=counts.device)
        counts = grouped.index_add_(0, gid, counts)
    return counts


def _table_cost_bits(lens: np.ndarray, singleton: int) -> int:
    """Exact huffman.store_table bit cost (16-bit count, byte-rounded
    presence mask, 4-bit nibbles; singleton/one-symbol → 32 bits)."""
    if singleton >= 0:
        return 32
    n = int(np.count_nonzero(lens))
    if n == 0:
        return 16
    if n == 1:
        return 32
    return 16 + 8 * ((lens.shape[0] + 7) // 8) + 4 * n


def _tables_bits(tables: "QualityTables") -> int:
    return sum(_table_cost_bits(tables.lens[t], int(tables.singletons[t]))
               for t in range(tables.n_trees))


def lens_rows_for(tables: "QualityTables", T0: int) -> np.ndarray:
    """Expand a (possibly tree-grouped) table set's code lengths back to T0
    histogram rows via the same proportional map, for exact-cost math
    against ungrouped counts (subblock._exact_cap)."""
    T = tables.n_trees
    if T == T0 or T == 0:
        return tables.lens
    gid = np.arange(T0, dtype=np.int64) * T // T0
    return tables.lens[gid]


def build_tables_adaptive(counts: np.ndarray, cfg: CodecConfig):
    """Returns (tables, group): trees merged while the exact total bits fall
    (v4 proportional grouping), then code lengths capped at 6 or 8 bits when
    that costs < 0.4% extra output bits (see phyngsc_tpu/models/quality.py)."""
    counts = np.asarray(counts)
    tables = build_tables(counts, cfg)
    T0 = counts.shape[0]
    from phyngsc_tpu.container import footer as _footer

    if T0 > 1 and _footer.VERSION >= 4:
        c64 = counts.astype(np.int64)
        best_bits = int((c64 * tables.lens).sum()) + _tables_bits(tables)
        T2 = T0 // 2
        while T2 >= 1:
            gid = np.arange(T0, dtype=np.int64) * T2 // T0
            cand_counts = np.zeros((T2, counts.shape[1]), np.int64)
            np.add.at(cand_counts, gid, c64)
            cand = build_tables(cand_counts, cfg)
            bits = int((c64 * cand.lens[gid]).sum()) + _tables_bits(cand)
            if bits >= best_bits:
                break
            best_bits = bits
            counts, tables = cand_counts, cand
            T2 //= 2
    max_len = int(tables.lens.max()) if tables.lens.size else 1
    k = lookup.group_for(max_len)
    c64 = counts.astype(np.int64)
    base = int((c64 * tables.lens).sum())
    if not base:
        return tables, k
    if (max_len > 6 and cfg.max_code_len > 6
            and int(np.count_nonzero(counts, axis=1).max()) <= 64):
        t6 = build_tables(counts, dataclasses.replace(cfg, max_code_len=6))
        if int((c64 * t6.lens).sum()) <= base * 1.004:
            return t6, lookup.group_for(6)
    if k >= 4 or cfg.max_code_len <= 8:
        return tables, k
    t8 = build_tables(counts, dataclasses.replace(cfg, max_code_len=8))
    if int((c64 * t8.lens).sum()) <= base * 1.004:
        return t8, 4
    return tables, k


def build_tables(counts: np.ndarray, cfg: CodecConfig) -> QualityTables:
    counts = np.asarray(counts)
    from phyngsc_tpu.utils import native

    built = native.huffman_lengths(counts, cfg.max_code_len)
    if built is not None:
        lens, singletons = built
    else:
        lens = huffman.build_code_lengths_batch(counts, cfg.max_code_len)
        singletons = huffman.singleton_of_batch(counts)
    return QualityTables(
        lens=lens,
        codes=np.asarray(huffman.canonical_codes(lens)),
        singletons=singletons,
    )


# -- encode -----------------------------------------------------------------

def encode_device(qual: torch.Tensor, lens: torch.Tensor,
                  codes_tab: torch.Tensor, lens_tab: torch.Tensor,
                  records_per_substream: int, n_words_cap: int,
                  group: int = 2, off: int = 0):
    """Pack the quality stream. Returns (words (n_words_cap,) int64 holding
    uint32, sub_n_words (S,) int64, total_words 0-d int64). codes_tab /
    lens_tab are (n_trees, A) tables, possibly sliced to an alphabet window
    starting at `off` (lookup.window_np)."""
    L = qual.shape[1]
    n_trees = lens_tab.shape[0]
    tree = tree_of_position(torch.arange(L, device=qual.device), n_trees, L)
    v = valid_mask(lens, L)
    sym = (qual.int() - off).clamp(0, codes_tab.shape[1] - 1).to(torch.uint8)
    fused = lookup.fused_lookup(sym,
                                lookup.fuse_tables(codes_tab, lens_tab)[tree])
    sym_codes, sym_lens = lookup.split_fused(fused)
    sym_codes = torch.where(v, sym_codes, 0)
    sym_lens = torch.where(v, sym_lens, 0)
    pc, pl = lookup.group_codes(sym_codes, sym_lens, group)
    lay = bitpack.substream_layout(pl, records_per_substream)
    words = bitpack.pack_bits_scatter(pc, pl, lay["bit_offsets"], n_words_cap)
    return words, lay["sub_n_words"], lay["total_words"]


# -- decode -----------------------------------------------------------------

def decode_walk(words: torch.Tensor, sub_n_words: torch.Tensor,
                lens: torch.Tensor, luts: torch.Tensor, L: int, Lt: int,
                records_per_substream: int, lut_bits: int,
                legacy: bool = False) -> torch.Tensor:
    """Uniform-length decode on K2: words (N,) int32 linear stream,
    sub_n_words (S,), lens (S*G,) record lengths (Lt or 0), luts
    (n_trees, 2^lut_bits) int32. Returns (S*G, L) uint8 (0 where invalid)."""
    G = records_per_substream
    S = sub_n_words.shape[0]
    n_trees = luts.shape[0]
    totals = lens.reshape(S, G).sum(dim=1, dtype=torch.int32)
    tid = tree_of_position(torch.arange(max(Lt, 1), device=words.device),
                           n_trees, L, legacy)
    return bitpack.walk_uniform(words, sub_n_words, totals, luts, tid,
                                lut_bits, G, Lt, L)


def decode_walk_masked(words: torch.Tensor, sub_n_words: torch.Tensor,
                       lens: torch.Tensor, luts: torch.Tensor, L: int,
                       records_per_substream: int, lut_bits: int,
                       legacy: bool = False) -> torch.Tensor:
    """Variable-length decode on K3 (port of decode_device_walk_masked): slot
    t = g*L + p of lane s is position p of record s*G + g, consumes a symbol
    only where p < its record's length, and takes tree
    tree_of_position(p). lens (S*G,) record lengths. Returns (S*G, L) uint8
    (0 where invalid)."""
    G = records_per_substream
    S = sub_n_words.shape[0]
    slots = valid_mask(lens, L).reshape(S, G * L)
    tid = tree_of_position(torch.arange(L, device=words.device),
                           luts.shape[0], L, legacy)
    syms = bitpack.walk_masked(words, sub_n_words, slots, luts, tid,
                               lut_bits, plain2=False)
    return syms.reshape(S * G, L)


# -- stream header ----------------------------------------------------------

def write_header(bw: BitWriter, tables: QualityTables, sub_n_words: np.ndarray,
                 total_words: int) -> None:
    sub_n_words = np.asarray(sub_n_words)
    bw.put_bits(tables.n_trees, 16)
    bw.put_uint(int(total_words), 4)
    bw.put_bits(sub_n_words.shape[0], 24)
    w = bit_length(int(sub_n_words.max())) if sub_n_words.size else 1
    bw.put_bits(w, 6)
    put_uint_array(bw, sub_n_words, w)
    for t in range(tables.n_trees):
        huffman.store_table(bw, tables.lens[t], int(tables.singletons[t]))


def read_header(br: BitReader):
    n_trees = br.get_bits(16)
    total_words = br.get_uint(4)
    n_sub = br.get_bits(24)
    w = br.get_bits(6)
    if w > 31:
        raise ValueError(f"corrupt substream-table width {w}")
    sub_n_words = get_uint_array(br, n_sub, w).astype(np.int32)
    if int(sub_n_words.sum()) > total_words:
        # writer invariant: per-substream words sum to total_words (minus
        # alignment slack); a corrupted entry would otherwise size giant
        # device buffers
        raise ValueError("corrupt quality substream table (sum > total)")
    if n_trees:
        pairs = [huffman.load_table(br, ALPHABET) for _ in range(n_trees)]
        lens = np.stack([p[0] for p in pairs])
        singletons = np.array([p[1] for p in pairs], dtype=np.int32)
    else:
        lens = np.zeros((0, ALPHABET), np.uint8)
        singletons = np.zeros(0, np.int32)
    tables = QualityTables(
        lens=lens, codes=np.asarray(huffman.canonical_codes(lens)),
        singletons=singletons,
    )
    return tables, sub_n_words, total_words

"""Title stream codec: separator-split field model.

Capability equivalent of the reference title machinery (C4/C5): titles are
split on the separator set " ._,=:/-#" (phyNGSC.cpp:208), and each field is
modeled per sub-block as either

- **numeric** — integer values coded as `value - min` or first value +
  deltas (`delta - min_delta`), whichever is fewer bits — the reference's
  value-vs-delta range rule (tasks.cpp:206-222); emitted at a fixed bit width
  (wide values split into <= 16-bit chunks), or
- **char** — one canonical Huffman tree per position (capped at
  `max_stat_positions`, tasks.cpp:25; positions past the cap share an
  overflow tree). Constant positions become zero-bit singleton trees, which
  subsumes both the reference's Hamming mask (tasks.cpp:187-193) and its
  constant-field class at zero payload cost.

If records disagree on field count or separator sequence — the reference
prints a warning and miscompresses (phyNGSC.cpp:417-421) — the model falls
back to a single whole-title char field, which is the same machinery with
F = 1 (strictly stronger than the reference).

TPU split: tokenization/classification/reassembly are host numpy (irregular,
string-heavy — SURVEY §7 step 3c); payload emission runs on device as two
streams: a **fixed stream** (numeric chunks + variable field lengths; constant
per-record stride → fully parallel extract on decode) and a **char stream**
(per-position Huffman through the substream LUT walk).
"""


# Copied from phyngsc_tpu/models/title.py (host-only), which imports the
# jax-importing ops/bitpack.py; the port never imports jax, so it keeps the copy.
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import huffman
from phyngsc_tpu_torch.ops import bitpack_host as bitpack
from phyngsc_tpu.utils.bitio import (BitReader, BitWriter, bit_length,
                                     get_uint_array, put_uint_array)
from phyngsc_tpu.utils.shapes import bucket_records

SEPARATORS = b" ._,=:/-#"
_SEP_LOOKUP = np.zeros(256, dtype=bool)
for _c in SEPARATORS:
    _SEP_LOOKUP[_c] = True

ALPHABET = 256
KIND_NUMERIC = 0
KIND_CHAR = 1
NUM_VALUE = 0
NUM_DELTA = 1
#: per-block descriptors (reference BlockDesc granularity, tasks.cpp:63-81 /
#: DEFAULT_B_SIZE=32, tasks.cpp:26): each 32-record block is flagged
#: constant / delta-constant / raw and pays only what it needs — the win on
#: tile-sorted datasets where a coordinate field holds still for runs.
#: Signaled by the width==127 escape in the header (old containers never
#: write widths > 64, so v2 files parse unchanged).
NUM_BLOCK = 2
#: shared-tree numeric Huffman (reference tasks.cpp:338-347: one Huffman tree
#: per field over `value - base` (or `delta - min_delta`) whenever the range
#: fits HUF_GLOBAL_SIZE=512, structures.h:25). Payload rides the char-stream
#: substream walk as ONE symbol per record; symbols <= 511 fit the 9-bit LUT
#: field. Chosen by exact measured bits like every other mode.
NUM_HUF = 3
MAX_HUF_RANGE = 512
BLOCK_RECORDS = 32
#: header escape value for NUM_BLOCK (7-bit width field)
_WIDTH_ESCAPE = 127
#: header escape value for NUM_HUF (real widths are <= 64, so 126 is free)
_WIDTH_ESCAPE_HUF = 126
BLK_CONST = 0
BLK_DELTA = 1
BLK_RAW = 2
MAX_NUMERIC_DIGITS = 18


def _zigzag(n: int) -> int:
    return (int(n) << 1) ^ (int(n) >> 63) if n < 0 else int(n) << 1


def _unzigzag(z: int) -> int:
    return (z >> 1) ^ -(z & 1)


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tokenized:
    """Field spans for R titles under a consistent schema (or F == 1 raw)."""
    n_fields: int
    sep_chars: np.ndarray      # (F-1,) uint8
    starts: np.ndarray         # (R, F) int32
    lens: np.ndarray           # (R, F) int32


def tokenize(titles: np.ndarray, tlens: np.ndarray) -> Tokenized:
    """Split padded title matrix (R, TL) on separators; fall back to a single
    raw field when the schema is inconsistent across records."""
    R, TL = titles.shape
    if R == 0:
        return Tokenized(1, np.zeros(0, np.uint8),
                         np.zeros((0, 1), np.int32), np.zeros((0, 1), np.int32))
    valid = np.arange(TL)[None, :] < tlens[:, None]
    sep = _SEP_LOOKUP[titles] & valid
    counts = sep.sum(axis=1)
    raw = Tokenized(
        1, np.zeros(0, np.uint8),
        np.zeros((R, 1), np.int32), tlens.astype(np.int32)[:, None],
    )
    if not np.all(counts == counts[0]):
        return raw
    nsep = int(counts[0])
    if nsep == 0:
        return raw
    rows, cols = np.nonzero(sep)
    cols = cols.reshape(R, nsep).astype(np.int32)
    chars = titles[np.arange(R)[:, None], cols]
    if not np.all(chars == chars[0]):
        return raw
    F = nsep + 1
    starts = np.zeros((R, F), np.int32)
    starts[:, 1:] = cols + 1
    ends = np.concatenate([cols, tlens.astype(np.int32)[:, None]], axis=1)
    return Tokenized(F, chars[0].astype(np.uint8), starts, ends - starts)


def field_content(titles: np.ndarray, tok: Tokenized, f: int) -> np.ndarray:
    """(R, W_f) padded byte matrix of field f."""
    R = titles.shape[0]
    W = int(tok.lens[:, f].max()) if R else 0
    if W == 0:
        return np.zeros((R, 0), np.uint8)
    from phyngsc_tpu.utils import native

    TL = titles.shape[1]
    flat_starts = np.arange(R, dtype=np.int64) * TL + tok.starts[:, f]
    out = native.gather(np.ascontiguousarray(titles).reshape(-1), flat_starts,
                        tok.lens[:, f], W)
    if out is not None:
        return out
    cols = tok.starts[:, f : f + 1] + np.arange(W, dtype=np.int32)[None, :]
    mask = np.arange(W)[None, :] < tok.lens[:, f : f + 1]
    out = titles[np.arange(R)[:, None], np.clip(cols, 0, titles.shape[1] - 1)]
    out[~mask] = 0
    return out


# ---------------------------------------------------------------------------
# Field plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NumericPlan:
    kind: int            # KIND_NUMERIC
    mode: int            # NUM_VALUE | NUM_DELTA | NUM_BLOCK
    width: int           # payload bits per record (0 = constant); NUM_BLOCK:
                         # bits per value (relative to base)
    base: int            # value/block mode: min; delta mode: min delta (signed)
    first: int = 0       # delta mode: value of record 0
    dwidth: int = 0      # NUM_BLOCK: bits per zigzag in-block delta
    # NUM_BLOCK per-block descriptors (filled by the planner on encode, by
    # read_header on decode): flag per block + its payload values
    blk_flags: Optional[np.ndarray] = None   # (nB,) uint8 BLK_*
    blk_a: Optional[np.ndarray] = None       # (nB,) uint64 value/first − base
    blk_d: Optional[np.ndarray] = None       # (nB,) uint64 zigzag delta
    blk_raw: Optional[np.ndarray] = None     # (sum of raw counts,) uint64
    # NUM_HUF: shared tree over (value|delta) - base; one symbol per record
    hsub: int = NUM_VALUE                    # NUM_VALUE | NUM_DELTA
    alpha: int = 0                           # alphabet size (range + 1)
    huf_lens: Optional[np.ndarray] = None    # (alpha,) uint8 code lengths
    huf_sing: int = -1

    @property
    def chunk_widths(self) -> List[int]:
        if self.width == 0 or self.mode in (NUM_BLOCK, NUM_HUF):
            return []
        n = (self.width + 15) // 16
        return [self.width - 16 * (n - 1)] + [16] * (n - 1)


@dataclasses.dataclass
class CharPlan:
    kind: int                  # KIND_CHAR
    max_len: int               # W_f
    const_len: int             # record length if constant, else -1
    len_width: int             # bits for per-record length (0 if const)
    tables_lens: np.ndarray    # (n_trees, 256) uint8
    tables_singletons: np.ndarray  # (n_trees,) int32
    #: per-32-record block constancy (reference block-constancy bits,
    #: tasks.cpp:393-509 / BlockDesc tasks.cpp:63-81): block b constant →
    #: only its FIRST record's chars ride the walk; the rest replicate on
    #: decode. None = plain per-record mode. Chosen by exact emitted bits.
    blk_const: Optional[np.ndarray] = None   # (nB,) bool

    @property
    def n_positions(self) -> int:  # tracked positions (before overflow tree)
        n = self.tables_lens.shape[0]
        return n - 1 if self.max_len > n - 1 else n

    @property
    def has_overflow(self) -> bool:
        return self.max_len > self.n_positions

    def tree_of_pos(self, p: np.ndarray) -> np.ndarray:
        return np.minimum(p, self.tables_lens.shape[0] - 1)

    def rep_mask(self, R: int) -> Optional[np.ndarray]:
        """(R,) bool — True where the record's chars are actually emitted
        (first of a constant block, or any record of a varying block)."""
        if self.blk_const is None:
            return None
        B = BLOCK_RECORDS
        idx = np.arange(R)
        in_const = self.blk_const[idx // B]
        return ~in_const | (idx % B == 0)


def plan_numeric(content: np.ndarray, flens: np.ndarray,
                 max_code_len: int = 12) -> Optional[NumericPlan]:
    R, W = content.shape
    if R == 0 or W == 0 or W > MAX_NUMERIC_DIGITS:
        return None
    if np.any(flens < 1):
        return None
    mask = np.arange(W)[None, :] < flens[:, None]
    digits = (content >= ord("0")) & (content <= ord("9"))
    if not np.all(digits | ~mask):
        return None
    # no leading zeros unless the value is exactly "0"
    leading_zero = (content[:, 0] == ord("0")) & (flens > 1)
    if np.any(leading_zero):
        return None
    place = np.where(mask, flens[:, None] - 1 - np.arange(W)[None, :], 0)
    vals = np.sum(
        np.where(mask, (content - ord("0")).astype(np.int64), 0)
        * (10 ** place.astype(np.int64)),
        axis=1,
    )
    return _numeric_plan_from_values(vals, max_code_len)


def plan_numeric_scan(vals: np.ndarray, ok: np.ndarray,
                      max_code_len: int = 12) -> Optional[NumericPlan]:
    """Fast path from the native title scan (values + validity pre-parsed)."""
    if vals.shape[0] == 0 or not bool(np.all(ok)):
        return None
    return _numeric_plan_from_values(vals, max_code_len)


class _NumPre:
    """Batched per-field numeric statistics: the mode planners' reductions
    (min/max/diff/block constancy) computed for ALL fields in one matrix
    pass each instead of ~10 strided passes per field — title analyze sits
    on the compress critical path at scale (VERDICT r4 next #4). Plans are
    bit-identical to the per-field path (same reductions, same padding)."""

    __slots__ = ("vmin", "vmax", "dT", "dmin", "dmax",
                 "cnt", "const", "dconst", "first_d", "nB", "blocks")


def _numeric_pre(V: np.ndarray) -> _NumPre:
    """One field-major transpose, then every reduction runs over contiguous
    rows (axis-0 reductions on the (R, F) layout stride F*8 bytes and run
    ~5x slower). Block statistics reproduce the padded per-field path
    exactly: padding repeats the last value, so padded comparisons are
    always-equal no-ops."""
    R, F = V.shape
    pre = _NumPre()
    if R >= 2:
        from phyngsc_tpu.utils import native

        B = BLOCK_RECORDS
        ns = native.numeric_stats(V, B)
        if ns is not None:
            pre.vmin, pre.vmax = ns["vmin"], ns["vmax"]
            pre.dmin, pre.dmax = ns["dmin"], ns["dmax"]
            pre.dT = None            # deltas rebuilt lazily per NUM_HUF field
            pre.blocks = True
            nB = (R + B - 1) // B
            pre.nB = nB
            pre.cnt = np.clip(np.minimum(np.arange(nB) * -B + R, B), 1, B)
            pre.const = ns["const"]
            pre.dconst = ns["dconst"]
            pre.first_d = ns["first_d"]
            return pre
    VT = np.ascontiguousarray(V.T)                               # (F, R)
    pre.vmin = VT.min(axis=1)
    pre.vmax = VT.max(axis=1)
    pre.dT = None
    pre.blocks = False
    if R < 2:
        return pre
    dT = np.diff(VT, axis=1)                                     # (F, R-1)
    pre.dT = dT
    pre.dmin = dT.min(axis=1)
    pre.dmax = dT.max(axis=1)
    B = BLOCK_RECORDS
    nB = (R + B - 1) // B
    pre.nB = nB
    pre.blocks = True
    cnt = np.clip(np.minimum(np.arange(nB) * -B + R, B), 1, B)
    pre.cnt = cnt
    pad = nB * B - R
    V3 = np.concatenate([VT, np.repeat(VT[:, -1:], pad, axis=1)],
                        axis=1).reshape(F, nB, B)
    pre.const = np.all(V3 == V3[:, :, :1], axis=2).T             # (nB, F)
    D3 = np.diff(V3, axis=2)                                     # (F,nB,B-1)
    first_d = D3[:, :, 0]
    dmask = np.arange(1, B)[None, None, :] < cnt[None, :, None]
    pre.first_d = first_d.T
    pre.dconst = (np.all((D3 == first_d[:, :, None]) | ~dmask, axis=2)
                  & (cnt >= 2)[None, :]).T
    return pre


def _numeric_plan_from_values(vals: np.ndarray, max_code_len: int = 12,
                              pre: Optional[_NumPre] = None,
                              f: int = 0) -> NumericPlan:
    """Pick the cheapest numeric mode by EXACT emitted bits — every
    candidate's total includes its full header as write_header serializes
    it (kind 1 + mode 1 + width 7 = 9 common bits, 64-bit base/first words,
    exact store_table cost), so borderline fields can never flip to a mode
    that actually emits more (VERDICT r2 weak #6). pre/f: batched stats
    from _numeric_pre (column f), same values as the local reductions."""
    R = vals.shape[0]
    if pre is not None:
        vmin, vmax = int(pre.vmin[f]), int(pre.vmax[f])
    else:
        vmin, vmax = int(vals.min()), int(vals.max())
    width_v = bit_length(vmax - vmin) if vmax > vmin else 0
    best = NumericPlan(KIND_NUMERIC, NUM_VALUE, width_v, vmin)
    best_bits = 9 + 64 + R * width_v
    d_fn = None
    if R >= 2:
        if pre is not None:
            dmin, dmax = int(pre.dmin[f]), int(pre.dmax[f])
            if pre.dT is not None:
                dT = pre.dT
                d_fn = lambda: dT[f]                          # noqa: E731
            else:
                # native pre keeps no delta rows; NUM_HUF-eligible fields
                # (small delta range) rebuild them from the column
                d_fn = lambda: np.diff(vals)                  # noqa: E731
        else:
            d_arr = np.diff(vals)
            dmin, dmax = int(d_arr.min()), int(d_arr.max())
            d_fn = lambda: d_arr                              # noqa: E731
        width_d = bit_length(dmax - dmin) if dmax > dmin else 0
        bits_d = 9 + 128 + (R - 1) * width_d
        if bits_d < best_bits:
            best = NumericPlan(KIND_NUMERIC, NUM_DELTA, width_d, dmin,
                               int(vals[0]))
            best_bits = bits_d
    blk = _plan_numeric_block(vals, vmin, width_v, pre, f)
    if blk is not None and blk[1] < best_bits:
        best, best_bits = blk
    huf = _plan_numeric_huf(vals, d_fn, dmin if d_fn else 0,
                            dmax if d_fn else 0, vmin, vmax, width_v,
                            max_code_len)
    if huf is not None and huf[1] < best_bits:
        best, best_bits = huf
    return best


def _table_cost_bits(lens: np.ndarray, singleton: int = -1) -> int:
    """Exact store_table bit cost (huffman.store_table layout: 16-bit count,
    byte-rounded presence mask, 4-bit nibbles; singleton / one-symbol tables
    collapse to 32 bits)."""
    if singleton >= 0:
        return 32
    n = int(np.count_nonzero(lens))
    if n == 0:
        return 16
    if n == 1:
        return 32  # always stored via the singleton form
    return 16 + 8 * ((lens.shape[0] + 7) // 8) + 4 * n


def _plan_numeric_huf(vals, d_fn, dmin: int, dmax: int, vmin: int, vmax: int,
                      width_v: int, max_code_len: int):
    """Shared-tree Huffman candidates over values / deltas, range <= 512
    (tasks.cpp:338-347 / HUF_GLOBAL_SIZE parity): returns (plan, exact bits)
    of the better of the two, or None when neither range qualifies. d_fn is
    a lazy delta supplier (materialized only for eligible small ranges) with
    dmin/dmax precomputed by the caller."""
    best = None
    cap = min(MAX_HUF_RANGE, 1 << max_code_len)  # Kraft-feasible alphabets only
    A = vmax - vmin + 1
    if 2 <= A <= cap:
        hist = np.bincount((vals - vmin).astype(np.int64), minlength=A)
        lens = huffman.build_code_lengths(hist, max_code_len)
        sing = huffman.singleton_of(hist)
        # exact header: 9 common + hsub 1 + alpha 10 + base 64 = 84
        bits = int((hist * lens).sum()) + _table_cost_bits(lens, sing) + 84
        best = (NumericPlan(KIND_NUMERIC, NUM_HUF, width_v, vmin,
                            hsub=NUM_VALUE, alpha=A, huf_lens=lens,
                            huf_sing=sing), bits)
    if d_fn is not None:
        Ad = dmax - dmin + 1
        if 2 <= Ad <= cap:
            d = d_fn()
            # record 0 emits symbol 0 (decode overwrites d[0]; `first`
            # carries the true value) — included in the histogram
            enc = np.concatenate([[0], (d - dmin).astype(np.int64)])
            hist = np.bincount(enc, minlength=Ad)
            lens = huffman.build_code_lengths(hist, max_code_len)
            sing = huffman.singleton_of(hist)
            # exact header: 9 common + hsub 1 + alpha 10 + first/base 128
            bits = (int((hist * lens).sum())
                    + _table_cost_bits(lens, sing) + 148)
            if best is None or bits < best[1]:
                best = (NumericPlan(KIND_NUMERIC, NUM_HUF, width_v, dmin,
                                    int(vals[0]), hsub=NUM_DELTA, alpha=Ad,
                                    huf_lens=lens, huf_sing=sing), bits)
    return best


def _plan_numeric_block(vals: np.ndarray, vmin: int, width_v: int,
                        pre: Optional[_NumPre] = None, f: int = 0):
    """Per-32-record-block descriptors (NUM_BLOCK): returns (plan, bits) or
    None. Each block is constant (one value), delta-constant (first + step)
    or raw (count × width_v); 2 flag bits per block. Wins on tile-sorted
    datasets where coordinate fields hold still or count up for runs."""
    R = vals.shape[0]
    B = BLOCK_RECORDS
    if R < 2 or width_v == 0:
        return None
    if pre is not None and pre.blocks:
        nB, cnt = pre.nB, pre.cnt
        const = pre.const[:, f]
        first_d = pre.first_d[:, f]
        dconst = pre.dconst[:, f]
    else:
        nB = (R + B - 1) // B
        pad = nB * B - R
        V = np.concatenate([vals, np.repeat(vals[-1:], pad)]).reshape(nB, B)
        cnt = np.minimum(np.arange(nB) * -B + R, B)  # records in each block
        cnt = np.clip(cnt, 1, B)
        const = np.all(V == V[:, :1], axis=1)
        D = np.diff(V, axis=1)                    # padded tail deltas are 0
        dmask = np.arange(1, B)[None, :] < cnt[:, None]
        first_d = D[:, 0]
        dconst = np.all((D == first_d[:, None]) | ~dmask, axis=1) & (cnt >= 2)
    zz = np.where(first_d < 0, (np.abs(first_d) << 1) - 1, first_d << 1)
    use_d = dconst & ~const
    wzd = bit_length(int(zz[use_d].max())) if bool(use_d.any()) else 0
    flags = np.where(const, BLK_CONST,
                     np.where(dconst, BLK_DELTA, BLK_RAW)).astype(np.uint8)
    raw = flags == BLK_RAW
    # exact: 9 common (kind+mode+escape width) + wv 7 + wzd 7 + base 64
    # = 87, then 2 flag bits/block, blk_a for const+delta blocks, blk_d
    # for delta, raw records at width_v
    bits = int(2 * nB + width_v * (np.sum(~raw) + np.sum(cnt[raw]))
               + wzd * int(use_d.sum())) + 87
    a = (vals[np.arange(nB, dtype=np.int64) * B].astype(np.int64)
         - vmin).astype(np.uint64)
    # raw blocks store only their real records, row-major
    if raw.any():
        blk_raw = (np.concatenate(
            [vals[g * B : g * B + int(cnt[g])]
             for g in np.flatnonzero(raw)]) - vmin).astype(np.uint64)
    else:
        blk_raw = np.zeros(0, np.uint64)
    plan = NumericPlan(KIND_NUMERIC, NUM_BLOCK, width_v, vmin, 0, wzd,
                       flags, a, zz.astype(np.uint64), blk_raw)
    return plan, bits


def plan_char(content: np.ndarray, flens: np.ndarray, cfg: CodecConfig) -> CharPlan:
    R, W = content.shape
    # constant-field fast path (ubiquitous in real titles: run ids, machine
    # names): every position is a zero-bit singleton tree, no histograms
    if R and W and bool(np.all(flens == flens[0])) and bool(np.all(content == content[0])):
        cl = int(flens[0])
        P = min(W, cfg.max_stat_positions)
        n_trees = P  # cl == W <= max positions in practice; overflow below
        if W > P:
            n_trees = P + 1
        singles = np.full(n_trees, -1, np.int32)
        singles[: min(P, W)] = content[0, : min(P, W)].astype(np.int32)
        if W > P:
            # overflow tree: constant too only if tail chars are all equal
            tail = content[0, P:W]
            if np.all(tail == tail[0]):
                singles[-1] = int(tail[0])
            else:
                counts = np.zeros((1, ALPHABET), np.int64)
                counts[0] = np.bincount(tail, minlength=ALPHABET)[:ALPHABET] * R
                lens_tab = huffman.build_code_lengths_batch(counts, cfg.max_code_len)
                full = np.zeros((n_trees, ALPHABET), np.uint8)
                full[-1] = lens_tab[0]
                return CharPlan(KIND_CHAR, W, cl, 0, full, singles)
        return CharPlan(KIND_CHAR, W, cl, 0,
                        np.zeros((n_trees, ALPHABET), np.uint8), singles)
    P = min(W, cfg.max_stat_positions)
    mask = np.arange(W)[None, :] < flens[:, None]
    n_trees = P + (1 if W > P else 0)

    def _stats(rowsel) -> np.ndarray:
        counts = np.zeros((n_trees, ALPHABET), np.int64)
        m = mask if rowsel is None else (mask & rowsel[:, None])
        if R and P:
            mm = m[:, :P]
            flat = (np.arange(P)[None, :] * ALPHABET
                    + content[:, :P].astype(np.int64))
            counts[:P] += np.bincount(
                flat[mm], minlength=P * ALPHABET).reshape(P, ALPHABET)
        if W > P and R:
            counts[-1] = np.bincount(
                content[:, P:][m[:, P:]], minlength=ALPHABET)[:ALPHABET]
        return counts

    def _emit_bits(counts, lens_tab, singles) -> int:
        """Exact emitted bits: payload (hist × code lens) + table storage."""
        bits = int(np.sum(counts * lens_tab.astype(np.int64)))
        for t in range(n_trees):
            bits += _table_cost_bits(lens_tab[t], int(singles[t]))
        return bits

    counts = _stats(None)
    lens_tab = huffman.build_code_lengths_batch(counts, cfg.max_code_len)
    singles = huffman.singleton_of_batch(counts)
    if np.all(flens == flens[0]) if R else True:
        cl, lw = int(flens[0]) if R else 0, 0
    else:
        cl, lw = -1, bit_length(int(flens.max()))

    # per-32-record block constancy (tasks.cpp:393-509 equivalent): when a
    # block's records all hold the same bytes, only the first record's chars
    # ride the walk. Chosen by exact emitted bits vs plain per-record mode
    # (block mode pays nB flag bits + a 16-bit header escape and builds its
    # trees from the deduplicated histogram).
    B = BLOCK_RECORDS
    if R >= 2 and W:
        first_idx = (np.arange(R) // B) * B
        row_eq = (np.all(content == content[first_idx], axis=1)
                  & (flens == flens[first_idx]))
        nB = (R + B - 1) // B
        blk_const = np.minimum.reduceat(
            row_eq.astype(np.uint8), np.arange(0, R, B)).astype(bool)
        # only blocks with >= 2 records can save anything
        if R % B == 1:
            blk_const[-1] = False
        if blk_const.any():
            idx = np.arange(R)
            rep = ~blk_const[idx // B] | (idx % B == 0)
            counts_b = _stats(rep)
            lens_b = huffman.build_code_lengths_batch(
                counts_b, cfg.max_code_len)
            singles_b = huffman.singleton_of_batch(counts_b)
            if (_emit_bits(counts_b, lens_b, singles_b) + nB + 16
                    < _emit_bits(counts, lens_tab, singles)):
                return CharPlan(KIND_CHAR, W, cl, lw, lens_b, singles_b,
                                blk_const=blk_const)
    return CharPlan(KIND_CHAR, W, cl, lw, lens_tab, singles)


@dataclasses.dataclass
class TitlePlan:
    tok_schema: Tokenized          # schema info (sep chars); spans unused on decode
    fields: list                   # NumericPlan | CharPlan per field

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @staticmethod
    def _field_n_trees(p) -> int:
        if p.kind == KIND_CHAR:
            return p.tables_lens.shape[0]
        return 1 if p.mode == NUM_HUF else 0

    def char_tree_base(self, f: int) -> int:
        base = 0
        for g, p in enumerate(self.fields):
            if g == f:
                return base
            base += self._field_n_trees(p)
        return base

    @property
    def all_char_lens(self) -> np.ndarray:
        """All walk trees (char positions + NUM_HUF shared trees) in field
        order, zero-padded to a common alphabet width (padding symbols have
        length 0 — absent from every codebook, so codes are unchanged)."""
        mats = []
        for p in self.fields:
            if p.kind == KIND_CHAR:
                mats.append(p.tables_lens)
            elif p.mode == NUM_HUF:
                mats.append(p.huf_lens[None, :])
        if not mats:
            return np.zeros((0, ALPHABET), np.uint8)
        amax = max(m.shape[1] for m in mats)
        mats = [np.pad(m, ((0, 0), (0, amax - m.shape[1]))) for m in mats]
        return np.concatenate(mats)

    @property
    def all_char_singletons(self) -> np.ndarray:
        vecs = []
        for p in self.fields:
            if p.kind == KIND_CHAR:
                vecs.append(p.tables_singletons)
            elif p.mode == NUM_HUF:
                vecs.append(np.array([p.huf_sing], np.int32))
        return np.concatenate(vecs) if vecs else np.zeros(0, np.int32)

    def luts(self, lut_bits: int) -> np.ndarray:
        lens = self.all_char_lens
        if lens.shape[0] == 0:
            return np.zeros((1, 1 << lut_bits), np.int32)
        sym, ln = huffman.decode_lut_batch(lens, lut_bits, self.all_char_singletons)
        return np.asarray((ln.astype(np.int32) << 9) | sym.astype(np.int32))

    @property
    def fixed_widths(self) -> List[int]:
        """Per-record fixed-stream chunk widths, field-major order."""
        out: List[int] = []
        for p in self.fields:
            if p.kind == KIND_NUMERIC:
                out.extend(p.chunk_widths)
            elif p.const_len < 0:
                out.append(p.len_width)
        return out


@dataclasses.dataclass
class TitleContext:
    """Tokenization (+ native numeric pre-parse) computed once per sub-block
    and shared by analyze and encode. Field content matrices are gathered
    lazily — numeric fields never need them."""
    titles: np.ndarray
    tok: Tokenized
    scan_values: Optional[np.ndarray] = None      # (R, F) int64
    scan_numeric_ok: Optional[np.ndarray] = None  # (R, F) bool
    _contents: dict = dataclasses.field(default_factory=dict)

    def content(self, f: int) -> np.ndarray:
        c = self._contents.get(f)
        if c is None:
            c = self._contents[f] = field_content(self.titles, self.tok, f)
        return c

    @classmethod
    def build(cls, titles: np.ndarray, tlens: np.ndarray) -> "TitleContext":
        from phyngsc_tpu.utils import native

        R = titles.shape[0]
        scan = native.title_scan(titles, tlens, SEPARATORS) if R else None
        if scan is not None and np.all(scan["nsep"] == scan["nsep"][0]) \
                and int(scan["nsep"][0]) < scan["sep_pos"].shape[1]:
            ns = int(scan["nsep"][0])
            raw_ok = True
            if ns > 0:
                chars = scan["sep_chars"][:, :ns]
                raw_ok = bool(np.all(chars == chars[0]))
            if raw_ok and ns > 0:
                F = ns + 1
                cols = scan["sep_pos"][:, :ns]
                starts = np.zeros((R, F), np.int32)
                starts[:, 1:] = cols + 1
                ends = np.concatenate(
                    [cols, tlens.astype(np.int32)[:, None]], axis=1)
                tok = Tokenized(F, scan["sep_chars"][0, :ns].copy(),
                                starts, ends - starts)
                return cls(titles, tok, scan["values"][:, :F],
                           scan["numeric_ok"][:, :F])
            if raw_ok and ns == 0:
                tok = Tokenized(1, np.zeros(0, np.uint8),
                                np.zeros((R, 1), np.int32),
                                tlens.astype(np.int32)[:, None])
                return cls(titles, tok, scan["values"][:, :1],
                           scan["numeric_ok"][:, :1])
            # inconsistent schema → raw fallback (single whole-title field)
            tok = Tokenized(1, np.zeros(0, np.uint8),
                            np.zeros((R, 1), np.int32),
                            tlens.astype(np.int32)[:, None])
            return cls(titles, tok)
        return cls(titles, tokenize(titles, tlens))


def analyze(titles: np.ndarray, tlens: np.ndarray, cfg: CodecConfig,
            ctx: Optional[TitleContext] = None) -> TitlePlan:
    ctx = ctx or TitleContext.build(titles, tlens)
    fields = []
    R = titles.shape[0]
    pre = allok = None
    if ctx.scan_numeric_ok is not None and R:
        allok = np.all(ctx.scan_numeric_ok, axis=0)      # (F,) one pass
        if bool(np.any(allok[: ctx.tok.n_fields])):
            pre = _numeric_pre(ctx.scan_values)
    for f in range(ctx.tok.n_fields):
        flens = ctx.tok.lens[:, f]
        if ctx.scan_numeric_ok is not None:
            # batched fast path: same decision as plan_numeric_scan, with
            # the reductions shared across fields (_NumPre)
            p = (_numeric_plan_from_values(ctx.scan_values[:, f],
                                           cfg.max_code_len, pre, f)
                 if allok is not None and bool(allok[f]) else None)
        else:
            p = plan_numeric(ctx.content(f), flens, cfg.max_code_len)
        if p is None:
            p = plan_char(ctx.content(f), flens, cfg)
        fields.append(p)
    return TitlePlan(ctx.tok, fields)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _numeric_values(content: np.ndarray, flens: np.ndarray) -> np.ndarray:
    W = content.shape[1]
    mask = np.arange(W)[None, :] < flens[:, None]
    place = np.where(mask, flens[:, None] - 1 - np.arange(W)[None, :], 0)
    return np.sum(
        np.where(mask, (content - ord("0")).astype(np.int64), 0)
        * (10 ** place.astype(np.int64)),
        axis=1,
    )


def _fixed_payload(plan: TitlePlan, ctx: TitleContext, R: int) -> np.ndarray:
    """(R, K) uint32 fixed-stream chunk values (field-major), widths constant."""
    tok = ctx.tok
    cols = []
    for f, p in enumerate(plan.fields):
        if p.kind == KIND_NUMERIC:
            if p.width == 0 or p.mode in (NUM_BLOCK, NUM_HUF):
                # constant / block-descriptor / huffman-coded fields pay no
                # fixed-stream payload (NUM_HUF rides the char walk)
                continue
            if ctx.scan_values is not None:
                vals = ctx.scan_values[:, f]
            else:
                vals = _numeric_values(ctx.content(f), tok.lens[:, f])
            if p.mode == NUM_VALUE:
                enc = vals - p.base
            else:
                d = np.concatenate([[0], np.diff(vals)])
                enc = d - p.base
                enc[0] = 0
            enc = enc.astype(np.uint64)
            for j, w in enumerate(p.chunk_widths):
                shift = sum(p.chunk_widths[j + 1 :])
                cols.append(((enc >> np.uint64(shift)) & np.uint64((1 << w) - 1)).astype(np.uint32))
        elif p.const_len < 0:
            cols.append(tok.lens[:, f].astype(np.uint32))
    return np.stack(cols, axis=1) if cols else np.zeros((R, 0), np.uint32)


def _char_symbols(plan: TitlePlan, ctx: TitleContext, R: int):
    """Char-stream per-symbol (codes, lens) as (R, K) arrays, K = sum of
    char-field max widths."""
    tok = ctx.tok
    lens_tab = plan.all_char_lens
    codes_tab = np.asarray(huffman.canonical_codes(lens_tab)) \
        if lens_tab.shape[0] else np.zeros((1, ALPHABET), np.uint32)
    code_cols, len_cols = [], []
    for f, p in enumerate(plan.fields):
        if p.kind == KIND_NUMERIC:
            if p.mode != NUM_HUF:
                continue
            # one shared-tree symbol per record: (value|delta) - base
            if ctx.scan_values is not None:
                vals = ctx.scan_values[:, f]
            else:
                vals = _numeric_values(ctx.content(f), tok.lens[:, f])
            if p.hsub == NUM_VALUE:
                enc = (vals - p.base).astype(np.int64)
            else:
                enc = np.concatenate([[0], np.diff(vals) - p.base])
                enc[0] = 0
            base = plan.char_tree_base(f)
            code_cols.append(codes_tab[base, enc][:, None].astype(np.uint32))
            len_cols.append(lens_tab[base, enc][:, None].astype(np.int32))
            continue
        if p.max_len == 0:
            continue
        # all-singleton (constant) fields emit zero bits — skip the gathers
        if (p.const_len >= 0 and np.all(p.tables_singletons >= 0)):
            continue
        content = ctx.content(f)
        flens = tok.lens[:, f]
        W = p.max_len
        base = plan.char_tree_base(f)
        tree = base + p.tree_of_pos(np.arange(W))
        v = np.arange(W)[None, :] < flens[:, None]
        rep = p.rep_mask(R)
        if rep is not None:
            # block mode: constant blocks emit only their first record
            v = v & rep[:, None]
        c32 = content.astype(np.int64)
        code_cols.append(np.where(v, codes_tab[tree[None, :], c32], 0).astype(np.uint32))
        len_cols.append(np.where(v, lens_tab[tree[None, :], c32], 0).astype(np.int32))
    if not code_cols:
        z = np.zeros((R, 0))
        return z.astype(np.uint32), z.astype(np.int32)
    return np.concatenate(code_cols, axis=1), np.concatenate(len_cols, axis=1)


@dataclasses.dataclass
class EncodedTitle:
    plan: TitlePlan
    fixed_words: np.ndarray     # uint32
    char_words: np.ndarray      # uint32
    char_sub_n_words: np.ndarray

    def byte_size(self) -> int:
        return 4 * (self.fixed_words.shape[0] + self.char_words.shape[0])


def encode(titles: np.ndarray, tlens: np.ndarray, cfg: CodecConfig,
           plan: Optional[TitlePlan] = None) -> EncodedTitle:
    R = titles.shape[0]
    ctx = TitleContext.build(titles, tlens)
    if plan is None:
        plan = analyze(titles, tlens, cfg, ctx)

    # fixed stream: constant stride → offsets are an affine map. Shapes are
    # bucketed over the record axis (utils/shapes.py) so every sub-block
    # shares the same compiled pack kernel; padded rows are zeros.
    Rp = bucket_records(R, cfg.records_per_substream)
    payload = _fixed_payload(plan, ctx, R)
    widths = np.array(plan.fixed_widths, dtype=np.int32)
    stride = int(widths.sum())
    if stride:
        payload = np.vstack(
            [payload, np.zeros((Rp - R, payload.shape[1]), payload.dtype)])
        prefix = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
        offs = (np.arange(Rp, dtype=np.int64)[:, None] * stride + prefix[None, :]).astype(np.int32)
        cap = (Rp * stride + 31) // 32
        n_words = (R * stride + 31) // 32
        w = np.broadcast_to(widths[None, :], payload.shape).astype(np.int32)
        fixed_words = bitpack.pack_bits_scatter_np(payload, w, offs, cap)[:n_words]
    else:
        fixed_words = np.zeros(0, np.uint32)

    # char stream: substream layout + scatter pack
    codes, clens = _char_symbols(plan, ctx, R)
    G = cfg.records_per_substream
    pad = Rp - R
    if pad:
        codes = np.vstack([codes, np.zeros((pad, codes.shape[1]), codes.dtype)])
        clens = np.vstack([clens, np.zeros((pad, clens.shape[1]), clens.dtype)])
    if codes.shape[1]:
        lay = bitpack.substream_layout_np(clens, G)
        total = int(lay["total_words"])
        char_words = bitpack.pack_bits_scatter_np(
            codes, clens, lay["bit_offsets"], max(total, 1))[:total]
        sub_n_words = np.asarray(lay["sub_n_words"])
    else:
        char_words = np.zeros(0, np.uint32)
        sub_n_words = np.zeros(Rp // G if G else 0, np.int32)
    return EncodedTitle(plan, fixed_words, char_words, sub_n_words)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _block_values(p: NumericPlan, R: int) -> np.ndarray:
    """Reconstruct R values from NUM_BLOCK per-block descriptors."""
    B = BLOCK_RECORDS
    nB = p.blk_flags.shape[0]
    cnt = np.clip(np.minimum(np.arange(nB) * -B + R, B), 1, B)
    i = np.arange(B, dtype=np.int64)
    zz = p.blk_d.astype(np.int64)
    step = np.where(zz & 1, -((zz + 1) >> 1), zz >> 1)
    step = np.where(p.blk_flags == BLK_DELTA, step, 0)
    firsts = p.blk_a.astype(np.int64) + p.base
    V = firsts[:, None] + step[:, None] * i[None, :]
    rawsel = p.blk_flags == BLK_RAW
    if rawsel.any():
        mr = i[None, :] < cnt[rawsel][:, None]
        Vr = np.zeros((int(rawsel.sum()), B), np.int64)
        Vr[mr] = p.blk_raw.astype(np.int64) + p.base
        V[rawsel] = Vr
    m = i[None, :] < cnt[:, None]
    return V[m]

_POW10 = np.array([10 ** k for k in range(1, 19)], dtype=np.int64)


def _ndigits(vals: np.ndarray) -> np.ndarray:
    """Exact decimal digit count: one searchsorted against the power-of-10
    table (v in [10^(k-1), 10^k) → k digits; ~6x faster than the float
    log10 + correction it replaced, and exact by construction)."""
    vv = np.maximum(np.asarray(vals, np.int64), 1)
    return (np.searchsorted(_POW10, vv, side="right") + 1).astype(np.int32)


def decode(enc_plan: TitlePlan, fixed_words: np.ndarray, char_words: np.ndarray,
           char_sub_n_words: np.ndarray, R: int, cfg: CodecConfig):
    """Reconstruct R title byte strings. Returns (titles (R, TL) uint8, tlens)."""
    plan = enc_plan
    widths = np.array(plan.fixed_widths, dtype=np.int32)
    stride = int(widths.sum())
    K = widths.shape[0]
    Rp = bucket_records(R, cfg.records_per_substream)
    if stride and R:
        prefix = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
        offs = (np.arange(Rp, dtype=np.int64)[:, None] * stride + prefix[None, :]).astype(np.int32)
        w = np.broadcast_to(widths[None, :], (Rp, K)).astype(np.int32)
        chunks = bitpack.extract_fixed_width_np(
            fixed_words, offs, w).reshape(Rp, K)[:R]
    else:
        chunks = np.zeros((R, K), np.uint32)

    # walk fixed stream: recover numeric values and variable field lengths
    field_vals: dict = {}
    field_lens = np.zeros((R, plan.n_fields), np.int32)
    k = 0
    for f, p in enumerate(plan.fields):
        if p.kind == KIND_NUMERIC:
            if p.mode == NUM_HUF:
                continue  # values come from the char walk below
            if p.mode == NUM_BLOCK:
                vals = _block_values(p, R)
            else:
                cw = p.chunk_widths
                enc = np.zeros(R, np.uint64)
                for j, wdt in enumerate(cw):
                    enc = (enc << np.uint64(wdt)) | chunks[:, k + j].astype(np.uint64)
                k += len(cw)
                if p.mode == NUM_VALUE:
                    vals = enc.astype(np.int64) + p.base
                else:
                    d = enc.astype(np.int64) + p.base
                    if R:
                        d[0] = 0
                    vals = np.cumsum(d) + p.first
            field_vals[f] = vals
            field_lens[:, f] = _ndigits(vals)
        else:
            if p.const_len >= 0:
                field_lens[:, f] = p.const_len
            else:
                field_lens[:, f] = chunks[:, k].astype(np.int32)
                k += 1

    # walk-stream decode: char fields (one tree per position) + NUM_HUF
    # numeric fields (one shared-tree symbol per record), in field order —
    # matching _char_symbols' encode column order
    walk_fields = [f for f, p in enumerate(plan.fields)
                   if (p.kind == KIND_CHAR and p.max_len > 0)
                   or (p.kind == KIND_NUMERIC and p.mode == NUM_HUF)]
    contents: dict = {}
    if walk_fields and R:
        G = cfg.records_per_substream
        S = Rp // G
        sub_start = np.concatenate(
            [[0], np.cumsum(char_sub_n_words)[:-1]]).astype(np.int64)
        luts = plan.luts(cfg.max_code_len)

        # native fused walk: decodes straight into per-field matrices
        # (no (S,T) tree maps / (R,W) index matrices — the numpy path below
        # measured as the decompressor's host wall)
        from phyngsc_tpu.utils import native

        Fw = len(walk_fields)
        steps = np.empty((R, Fw), np.int32)
        kinds_w = np.empty(Fw, np.int32)
        tb = np.empty(Fw, np.int32)
        ntr = np.empty(Fw, np.int32)
        ow = np.empty(Fw, np.int32)
        for j, f in enumerate(walk_fields):
            p = plan.fields[f]
            tb[j] = plan.char_tree_base(f)
            if p.kind == KIND_CHAR:
                rep = p.rep_mask(R)
                steps[:, j] = (field_lens[:R, f] if rep is None
                               else field_lens[:R, f] * rep)
                kinds_w[j] = 0
                ntr[j] = p.tables_lens.shape[0]
                ow[j] = int(field_lens[:R, f].max())
            else:
                steps[:, j] = 1
                kinds_w[j] = 1
                ntr[j] = 1
                ow[j] = 1
        blocks = native.title_walk(char_words, sub_start, G, luts,
                                   cfg.max_code_len, tb, ntr, kinds_w,
                                   steps, R, ow)
        if blocks is not None:
            for j, f in enumerate(walk_fields):
                p = plan.fields[f]
                if p.kind == KIND_CHAR:
                    c = blocks[j]
                    rep = p.rep_mask(R)
                    if rep is not None:
                        # replicate each constant block's first record
                        c = c[np.where(rep, np.arange(R),
                                       (np.arange(R) // BLOCK_RECORDS)
                                       * BLOCK_RECORDS)]
                    contents[f] = c
                else:
                    sym = blocks[j][:, 0].astype(np.int64)
                    if p.hsub == NUM_VALUE:
                        vals = sym + p.base
                    else:
                        d = sym + p.base
                        d[0] = 0
                        vals = np.cumsum(d) + p.first
                    field_vals[f] = vals
                    field_lens[:R, f] = _ndigits(vals)
            return _assemble_titles(plan, field_vals, field_lens,
                                    contents, R)

        def _walk_steps(f):
            p = plan.fields[f]
            if p.kind == KIND_CHAR:
                fl = field_lens[:R, f].astype(np.int64)
                rep = p.rep_mask(R)
                return fl if rep is None else fl * rep
            return np.ones(R, np.int64)

        before_of: dict = {}
        acc = np.zeros(R, np.int64)
        for f in walk_fields:
            before_of[f] = acc.copy()
            acc = acc + _walk_steps(f)
        steps_per_rec = np.zeros(Rp, np.int64)
        steps_per_rec[:R] = acc
        # build (S, T) tree ids + validity, and (r, f, pos) → step maps
        sub_tot = steps_per_rec.reshape(S, G).sum(axis=1)
        T = int(sub_tot.max()) if S else 0
        T = max((T + 63) // 64 * 64, 64)  # bucketed step count
        tree_ids = np.zeros((S, T), np.int32)
        valid = np.zeros((S, T), bool)
        rec_step0 = np.zeros(Rp, np.int64)
        cums = np.cumsum(steps_per_rec.reshape(S, G), axis=1)
        rec_step0.reshape(S, G)[:, 1:] = cums[:, :-1]
        for f in walk_fields:
            p = plan.fields[f]
            base = plan.char_tree_base(f)
            fl = _walk_steps(f)
            W = int(fl.max()) if R else 0
            if W == 0:
                continue
            pos = np.arange(W, dtype=np.int64)
            m = pos[None, :] < fl[:, None]
            step = rec_step0[:R, None] + before_of[f][:, None] + pos[None, :]
            srow = (np.arange(R) // G)[:, None].repeat(W, 1)
            trees = (base + p.tree_of_pos(pos) if p.kind == KIND_CHAR
                     else np.full(W, base, np.int64))
            tree_ids[srow[m], step[m]] = trees[None, :].repeat(R, 0)[m]
            valid[srow[m], step[m]] = True
        syms = bitpack.unpack_substreams_np(
            char_words, sub_start, luts, tree_ids, valid, T, cfg.max_code_len)
        srow1 = np.arange(R) // G
        for f in walk_fields:
            p = plan.fields[f]
            if p.kind == KIND_NUMERIC:
                step = np.clip(rec_step0[:R] + before_of[f], 0, T - 1)
                sym = syms[srow1, step].astype(np.int64)
                if p.hsub == NUM_VALUE:
                    vals = sym + p.base
                else:
                    d = sym + p.base
                    d[0] = 0
                    vals = np.cumsum(d) + p.first
                field_vals[f] = vals
                field_lens[:R, f] = _ndigits(vals)
                continue
            fl = _walk_steps(f)
            W = int(fl.max())
            pos = np.arange(W, dtype=np.int64)
            m = pos[None, :] < fl[:, None]
            step = np.clip(rec_step0[:R, None] + before_of[f][:, None] + pos[None, :], 0, T - 1)
            srow = srow1[:, None].repeat(W, 1)
            c = np.zeros((R, W), np.uint8)
            c[m] = syms[srow[m], step[m]].astype(np.uint8)
            rep = p.rep_mask(R)
            if rep is not None:
                c = c[np.where(rep, np.arange(R),
                               (np.arange(R) // BLOCK_RECORDS)
                               * BLOCK_RECORDS)]
            contents[f] = c

    return _assemble_titles(plan, field_vals, field_lens, contents, R)


def _assemble_titles(plan: TitlePlan, field_vals: dict, field_lens: np.ndarray,
                     contents: dict, R: int):
    """Rebuild the (R, TL) title matrix from decoded fields: native fused
    per-record writer when available, else a vectorized numpy scatter."""
    tlens = field_lens.sum(axis=1) + max(plan.n_fields - 1, 0)
    TL = int(tlens.max()) if R else 0
    F = plan.n_fields
    if R:
        from phyngsc_tpu.utils import native

        kinds = np.array([p.kind for p in plan.fields], np.int32)
        nvals_list: list = []
        nval_off = np.zeros(F, np.int64)
        chars_list: list = []
        char_off = np.zeros(F, np.int64)
        char_w = np.zeros(F, np.int32)
        nacc = cacc = 0
        for f, p in enumerate(plan.fields):
            if p.kind == KIND_NUMERIC:
                nvals_list.append(
                    np.ascontiguousarray(field_vals[f], np.int64))
                nval_off[f] = nacc
                nacc += R
            else:
                c = contents.get(f)
                w = 0 if c is None else c.shape[1]
                if w:
                    chars_list.append(
                        np.ascontiguousarray(c, np.int32).reshape(-1))
                char_off[f] = cacc
                char_w[f] = w
                cacc += R * w
        titles = native.title_assemble(
            kinds, field_lens,
            np.concatenate(nvals_list) if nvals_list else np.zeros(0, np.int64),
            nval_off,
            np.concatenate(chars_list) if chars_list else np.zeros(0, np.int32),
            char_off, char_w, plan.tok_schema.sep_chars, TL)
        if titles is not None:
            return (titles[:, :TL] if TL else titles[:, :0],
                    tlens.astype(np.int32))
    titles = np.zeros((R, max(TL, 1)), np.uint8)
    col0 = np.zeros(R, np.int64)
    for f, p in enumerate(plan.fields):
        fl = field_lens[:, f]
        if p.kind == KIND_NUMERIC:
            vals = field_vals[f]
            W = int(fl.max()) if R else 0
            if W:
                pos = np.arange(W, dtype=np.int64)
                m = pos[None, :] < fl[:, None]
                place = np.where(m, fl[:, None] - 1 - pos[None, :], 0)
                digs = (vals[:, None] // 10 ** place) % 10
                cols = col0[:, None] + pos[None, :]
                titles[np.arange(R)[:, None].repeat(W, 1)[m],
                       cols[m]] = (digs[m] + ord("0")).astype(np.uint8)
        else:
            c = contents.get(f)
            if c is not None:
                W = c.shape[1]
                pos = np.arange(W, dtype=np.int64)
                m = pos[None, :] < fl[:, None]
                cols = col0[:, None] + pos[None, :]
                titles[np.arange(R)[:, None].repeat(W, 1)[m], cols[m]] = c[m]
        col0 += fl
        if f < plan.n_fields - 1:
            titles[np.arange(R), col0] = plan.tok_schema.sep_chars[f]
            col0 += 1
    return titles[:, :TL] if TL else titles[:, :0], tlens.astype(np.int32)


# ---------------------------------------------------------------------------
# Header serialization
# ---------------------------------------------------------------------------

def write_header(bw: BitWriter, enc: EncodedTitle) -> None:
    plan = enc.plan
    bw.put_bits(plan.n_fields, 16)
    for c in plan.tok_schema.sep_chars:
        bw.put_byte(int(c))
    for p in plan.fields:
        bw.put_bit(p.kind)
        if p.kind == KIND_NUMERIC:
            if p.mode == NUM_BLOCK:
                # width==127 escape: v2 decoders never see it (real widths
                # <= 64); everything after is the block-descriptor layout
                bw.put_bit(0)
                bw.put_bits(_WIDTH_ESCAPE, 7)
                bw.put_bits(p.width, 7)
                bw.put_bits(p.dwidth, 7)
                bw.put_uint(p.base, 8)
                for b in range(p.blk_flags.shape[0]):
                    fl = int(p.blk_flags[b])
                    bw.put_bits(fl, 2)
                    if fl != BLK_RAW:
                        bw.put_bits(int(p.blk_a[b]), p.width)
                    if fl == BLK_DELTA:
                        bw.put_bits(int(p.blk_d[b]), p.dwidth)
                if p.blk_raw.shape[0]:
                    put_uint_array(bw, p.blk_raw, p.width)
                continue
            if p.mode == NUM_HUF:
                # width==126 escape: shared-tree numeric Huffman
                # (tasks.cpp:338-347 parity); payload rides the char walk
                bw.put_bit(0)
                bw.put_bits(_WIDTH_ESCAPE_HUF, 7)
                bw.put_bit(p.hsub)
                bw.put_bits(p.alpha, 10)
                if p.hsub == NUM_VALUE:
                    bw.put_uint(p.base, 8)
                else:
                    bw.put_uint(p.first, 8)
                    bw.put_uint(_zigzag(p.base), 8)
                huffman.store_table(bw, p.huf_lens, p.huf_sing)
                continue
            bw.put_bit(p.mode)
            bw.put_bits(p.width, 7)
            if p.mode == NUM_VALUE:
                bw.put_uint(p.base, 8)
            else:
                bw.put_uint(p.first, 8)
                bw.put_uint(_zigzag(p.base), 8)
        else:
            bw.put_bits(p.max_len, 16)
            if p.const_len >= 0:
                bw.put_bit(1)
                bw.put_bits(p.const_len, 16)
            else:
                bw.put_bit(0)
                bw.put_bits(p.len_width, 5)
            n_trees = p.tables_lens.shape[0]
            if p.blk_const is not None:
                # n_trees==0xFFFF escape (real counts are <= 129): char
                # block-constancy bits follow (tasks.cpp:393-509 analogue)
                bw.put_bits(0xFFFF, 16)
                bw.put_bits(n_trees, 16)
                for b in p.blk_const:
                    bw.put_bit(bool(b))
            else:
                bw.put_bits(n_trees, 16)
            for t in range(n_trees):
                huffman.store_table(bw, p.tables_lens[t], int(p.tables_singletons[t]))
    bw.put_uint(enc.fixed_words.shape[0], 4)
    bw.put_uint(enc.char_words.shape[0], 4)
    sub = np.asarray(enc.char_sub_n_words)
    bw.put_bits(sub.shape[0], 24)
    w = bit_length(int(sub.max())) if sub.size else 1
    bw.put_bits(w, 6)
    put_uint_array(bw, sub, w)


def _checked_base(br: BitReader) -> int:
    """64-bit base/first field bounded to int64 range: legit numeric values
    are <= 10^18 (MAX_NUMERIC_DIGITS), so a top-bit-set word is corruption
    and would overflow the int64 decode arithmetic."""
    v = br.get_uint(8)
    if v >= 1 << 63:
        raise ValueError(f"corrupt numeric base {v:#x}")
    return v


def read_header(br: BitReader, R: int):
    """R (the sub-block's record count, from the meta section) is required:
    the NUM_BLOCK width-escape derives its per-32-record block count from R,
    and R == 0 with records present would silently desync the bit stream."""
    F = br.get_bits(16)
    seps = np.array([br.get_byte() for _ in range(max(F - 1, 0))], np.uint8)
    fields = []
    for _ in range(F):
        kind = br.get_bit()
        if kind == KIND_NUMERIC:
            mode = br.get_bit()
            width = br.get_bits(7)
            if width == _WIDTH_ESCAPE:
                wv = br.get_bits(7)
                wzd = br.get_bits(7)
                if wv > 64 or wzd > 64:
                    # writers emit bit_length(...) <= 64; anything wider is
                    # corruption and would overflow the uint64 decode arrays
                    raise ValueError(
                        f"corrupt NUM_BLOCK widths ({wv}, {wzd})")
                base = _checked_base(br)
                B = BLOCK_RECORDS
                nB = (R + B - 1) // B
                cnt = np.clip(np.minimum(np.arange(nB) * -B + R, B), 1, B)
                flags = np.zeros(nB, np.uint8)
                a = np.zeros(nB, np.uint64)
                d = np.zeros(nB, np.uint64)
                for b in range(nB):
                    fl = br.get_bits(2)
                    flags[b] = fl
                    if fl != BLK_RAW:
                        a[b] = br.get_bits(wv)
                    if fl == BLK_DELTA:
                        d[b] = br.get_bits(wzd)
                n_raw = int(cnt[flags == BLK_RAW].sum())
                raw = get_uint_array(br, n_raw, wv).astype(np.uint64)
                fields.append(NumericPlan(KIND_NUMERIC, NUM_BLOCK, wv, base,
                                          0, wzd, flags, a, d, raw))
                continue
            if width == _WIDTH_ESCAPE_HUF:
                hsub = br.get_bit()
                alpha = br.get_bits(10)
                if hsub == NUM_VALUE:
                    base, first = _checked_base(br), 0
                else:
                    first = _checked_base(br)
                    base = _unzigzag(_checked_base(br))
                lens, sing = huffman.load_table(br, alpha)
                fields.append(NumericPlan(KIND_NUMERIC, NUM_HUF, 0, base,
                                          first, hsub=hsub, alpha=alpha,
                                          huf_lens=lens, huf_sing=sing))
                continue
            if mode == NUM_VALUE:
                base, first = _checked_base(br), 0
            else:
                first = _checked_base(br)
                base = _unzigzag(_checked_base(br))
            fields.append(NumericPlan(KIND_NUMERIC, mode, width, base, first))
        else:
            max_len = br.get_bits(16)
            if br.get_bit():
                const_len, len_width = br.get_bits(16), 0
            else:
                const_len, len_width = -1, br.get_bits(5)
            n_trees = br.get_bits(16)
            blk_const = None
            if n_trees == 0xFFFF:  # block-constancy escape (see write side)
                n_trees = br.get_bits(16)
                nB = (R + BLOCK_RECORDS - 1) // BLOCK_RECORDS
                blk_const = np.array(
                    [bool(br.get_bit()) for _ in range(nB)])
            pairs = [huffman.load_table(br, ALPHABET) for _ in range(n_trees)]
            lens = np.stack([q[0] for q in pairs]) if n_trees else np.zeros((0, ALPHABET), np.uint8)
            singles = np.array([q[1] for q in pairs], np.int32)
            fields.append(CharPlan(KIND_CHAR, max_len, const_len, len_width,
                                   lens, singles, blk_const=blk_const))
    n_fixed = br.get_uint(4)
    n_char = br.get_uint(4)
    n_sub = br.get_bits(24)
    w = br.get_bits(6)
    if w > 31:
        raise ValueError(f"corrupt substream-table width {w}")
    sub = get_uint_array(br, n_sub, w).astype(np.int32)
    if int(sub.sum()) > n_char:
        raise ValueError("corrupt title substream table (sum > char words)")
    tok = Tokenized(F, seps, np.zeros((0, F), np.int32), np.zeros((0, F), np.int32))
    return TitlePlan(tok, fields), n_fixed, n_char, sub

# Copied from phyngsc_tpu/ops/huffman.py; imports point at phyngsc_tpu_torch.
"""Length-limited canonical Huffman coding.

Capability equivalent of the reference HuffmanEncoder (huffman.cpp:18-222) with
a TPU-first contract:

- Codes are **length-limited** (<= CodecConfig.max_code_len, default 12) and
  **canonical**. The reference builds unbounded-depth trees and decodes by
  bit-walking node pointers (huffman.h:189-213) — pointer chasing that cannot
  vectorize. Canonical limited codes make device encode a pure table gather
  and device decode a single 2^L-entry LUT lookup (the reference's
  `speedup_tree` idea, huffman.cpp:166-187, taken to its fixed point: the LUT
  covers *every* code, so the bit-walk disappears entirely).
- Tables are serialized as code *lengths only* (canonical codes are derivable),
  replacing the reference's pre-order bit-tree serialization
  (huffman.cpp:88-118) — smaller and trivially parallel to rebuild.
- Everything is a pure function of the histogram: no tree objects, no `static`
  buffers (kills the latent race of huffman.cpp:191-222, SURVEY §5).

Tree construction runs on host (alphabets are <= 256 symbols — tiny); numpy
implementation here, with a batched native C++ fast path in native/ once
profiling warrants it.
"""

from __future__ import annotations

import numpy as np

from phyngsc_tpu_torch.utils.bitio import BitReader, BitWriter


def _package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Exact optimal length-limited code lengths (package-merge,
    Larmore–Hirschberg coin collector). Deterministic: leaves sorted by
    (freq, symbol); on weight ties leaves precede packages and earlier items
    precede later — the native builder (host_runtime.cpp) mirrors this
    ordering exactly so both produce identical tables."""
    freqs = np.asarray(freqs, dtype=np.int64)
    A = freqs.shape[0]
    lens = np.zeros(A, dtype=np.uint8)
    present = np.flatnonzero(freqs)
    n = present.shape[0]
    if n <= 1:
        return lens  # absent or zero-bit singleton
    if n > (1 << max_len):
        raise ValueError(f"alphabet of {n} symbols cannot fit {max_len}-bit codes")
    order = np.lexsort((present, freqs[present]))
    syms = present[order]
    leaf_w = freqs[syms]
    leaf_c = np.eye(n, dtype=np.int32)
    cur_w, cur_c = leaf_w, leaf_c                     # lists[max_len]
    for _ in range(max_len - 1):
        m = (cur_w.shape[0] // 2) * 2
        pkg_w = cur_w[0:m:2] + cur_w[1:m:2]
        pkg_c = cur_c[0:m:2] + cur_c[1:m:2]
        w = np.concatenate([leaf_w, pkg_w])
        flag = np.concatenate([np.zeros(n, np.int8),
                               np.ones(pkg_w.shape[0], np.int8)])
        pos = np.concatenate([np.arange(n), np.arange(pkg_w.shape[0])])
        idx = np.lexsort((pos, flag, w))
        cur_w = w[idx]
        cur_c = np.concatenate([leaf_c, pkg_c])[idx]
    counts = cur_c[: 2 * (n - 1)].sum(axis=0)        # code length per leaf
    lens[syms] = counts.astype(np.uint8)
    return lens


def build_code_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Code length per symbol (0 = absent) from a histogram: exact optimal
    length-limited codes via package-merge (dominates the reference's
    unbounded tree, huffman.cpp:18-85; lengths-only serialization keeps
    the choice of builder out of the format).

    A singleton alphabet yields all-zero lengths (zero-bit code); use
    `singleton_of` to recover which symbol it is.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    return _package_merge_lengths(freqs, max_len)


def build_code_lengths_batch(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """(K, A) histograms -> (K, A) code lengths."""
    freqs = np.asarray(freqs)
    if freqs.shape[0] == 0:
        return np.zeros(freqs.shape, dtype=np.uint8)
    return np.stack([build_code_lengths(f, max_len) for f in freqs])


def singleton_of(freqs: np.ndarray) -> int:
    """The symbol of a single-symbol alphabet, else -1."""
    present = np.flatnonzero(np.asarray(freqs))
    return int(present[0]) if present.shape[0] == 1 else -1


def singleton_of_batch(freqs: np.ndarray) -> np.ndarray:
    return np.array([singleton_of(f) for f in freqs], dtype=np.int32)


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code values from lengths; MSB-first emission order.

    Codes are assigned in (length, symbol) order: shorter codes first,
    ties broken by symbol id — so lengths alone fully determine the
    codebook. Fully vectorized (rows batched) via the prefix-Kraft
    identity: the i-th code in canonical order left-aligns at the running
    Kraft sum of its predecessors, so
        code_i = (Σ_{j<i} 2^(B - len_j)) >> (B - len_i),  B = max len.
    Accepts (A,) or (K, A); the per-symbol Python loop this replaces was
    a measured decode host-parse cost (VERDICT r3 next #4).
    """
    lens = np.asarray(lens, dtype=np.int64)
    one_d = lens.ndim == 1
    l2 = lens[None, :] if one_d else lens
    T, A = l2.shape
    codes = np.zeros((T, A), dtype=np.uint32)
    B = int(l2.max()) if l2.size else 0
    if T and A and B:
        present = l2 > 0
        key = np.where(present, l2 * (A + 1) + np.arange(A)[None, :],
                       np.int64(1) << 40)
        order = np.argsort(key, axis=1, kind="stable")
        slens = np.take_along_axis(l2, order, axis=1)
        w = np.where(slens > 0, np.int64(1) << (B - slens), 0)
        prefix = np.cumsum(w, axis=1) - w              # exclusive
        scodes = prefix >> (B - np.maximum(slens, 1))
        np.put_along_axis(codes, order,
                          np.where(slens > 0, scodes, 0).astype(np.uint32),
                          axis=1)
    return codes[0] if one_d else codes


def _canonical_codes_1d(lens: np.ndarray) -> np.ndarray:
    return canonical_codes(np.asarray(lens))


def decode_lut(lens: np.ndarray, lut_bits: int, singleton: int = -1):
    """Build the full-width decode LUT: window of `lut_bits` -> (symbol, len).

    For a code c of length l, all windows with prefix c decode to that symbol.
    A zero-bit singleton tree fills every entry with (singleton, 0) — the
    decode walk outputs it without consuming bits. Returns
    (sym: (2**lut_bits,) int32, length: (2**lut_bits,) int32); unused windows
    (incomplete codes) get len 0 — hitting one at decode is a stream
    corruption signal.
    """
    lens = np.asarray(lens, dtype=np.int64)
    if lens.size and int(lens.max()) > lut_bits:
        raise ValueError("lut_bits smaller than max code length")
    size = 1 << lut_bits
    sym = np.zeros(size, dtype=np.int32)
    length = np.zeros(size, dtype=np.int32)
    if singleton >= 0:
        sym[:] = singleton
        return sym, length
    codes = _canonical_codes_1d(lens).astype(np.int64)
    present = np.flatnonzero(lens)
    # canonical codes of equal length are consecutive → fill via ranges
    for s in present:
        l = int(lens[s])
        lo = int(codes[s]) << (lut_bits - l)
        hi = lo + (1 << (lut_bits - l))
        sym[lo:hi] = s
        length[lo:hi] = l
    return sym, length


def pair_decode_lut(lensA: np.ndarray, lensB: np.ndarray, lut_bits2: int,
                    singA: int = -1, singB: int = -1) -> np.ndarray:
    """Two-symbol decode LUT: a `lut_bits2`-bit window → packed
    (total_len << 18) | (symB << 9) | symA, decoding one code from tree A
    followed by one from tree B per table hit. Requires
    max_len(A) + max_len(B) <= lut_bits2 so the second code is fully
    determined by the window. Halves the decode walk's steps and gathers
    (the TPU walk is gather-bound — G/lut_bits sweeps measured flat)."""
    symA, lenA = decode_lut(lensA, lut_bits2, singA)
    symB_tab, lenB_tab = decode_lut(lensB, lut_bits2, singB)
    if lensA.size and lensB.size and \
            int(np.asarray(lensA).max()) + int(np.asarray(lensB).max()) > lut_bits2:
        raise ValueError("lut_bits2 smaller than combined max code length")
    w = np.arange(1 << lut_bits2, dtype=np.int64)
    rem = (w << lenA.astype(np.int64)) & ((1 << lut_bits2) - 1)
    symB = symB_tab[rem]
    lenB = lenB_tab[rem]
    # windows whose first code is invalid (len 0 on a non-singleton tree)
    # must not decode a second symbol either — corruption stays len-0
    dead = (lenA == 0) & (symA == 0) if singA < 0 else np.zeros_like(lenA, bool)
    total = np.where(dead, 0, lenA + lenB)
    symB = np.where(dead, 0, symB)
    return ((total << 18) | (symB << 9) | symA).astype(np.int32)


def half_decode_lut(lens: np.ndarray, lut_bits2: int, sing: int = -1
                    ) -> np.ndarray:
    """Pair-format LUT decoding only ONE symbol (the boundary step when a
    substream's symbol count is odd): symB slot is 0 and never observed."""
    symA, lenA = decode_lut(lens, lut_bits2, sing)
    return ((lenA << 18) | symA).astype(np.int32)


def decode_lut_batch(lens: np.ndarray, lut_bits: int, singletons=None):
    if len(lens) == 0:
        z = np.zeros((0, 1 << lut_bits), np.int32)
        return z, z.copy()
    if singletons is None:
        singletons = np.full(len(lens), -1, dtype=np.int32)
    syms, lengths = zip(
        *(decode_lut(l, lut_bits, int(s)) for l, s in zip(lens, singletons))
    )
    return np.stack(syms), np.stack(lengths)


# ---------------------------------------------------------------------------
# Serialization: lengths-only table (replaces huffman.cpp:88-118 bit-tree).
# Layout: [n_present: 16b] then
#   n_present == 0: nothing
#   n_present == 1: [symbol: 16b]                     (zero-bit singleton)
#   else:           [present bitmap: A bits][4b (len-1) per present symbol]
# ---------------------------------------------------------------------------

def store_table(bw: BitWriter, lens: np.ndarray, singleton: int = -1) -> None:
    lens = np.asarray(lens, dtype=np.int64)
    if singleton >= 0:
        bw.put_bits(1, 16)
        bw.put_bits(singleton, 16)
        return
    present = np.flatnonzero(lens)
    if present.shape[0] == 1:
        # a one-symbol table without the singleton flag would deserialize as
        # a zero-bit singleton and corrupt the stream — the builders always
        # collapse such alphabets (build_code_lengths), so this is a misuse
        raise ValueError("one-symbol table must be stored via singleton=sym")
    bw.put_bits(present.shape[0], 16)
    if present.shape[0] == 0:
        return
    mask = np.zeros(lens.shape[0], dtype=np.uint8)
    mask[present] = 1
    bw.put_bits(int.from_bytes(np.packbits(mask).tobytes(), "big"),
                8 * ((lens.shape[0] + 7) // 8))
    nib = (lens[present] - 1).astype(np.uint8)
    n = nib.shape[0]
    if n % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    packed = (nib[0::2] << 4) | nib[1::2]
    bw.put_bits(int.from_bytes(packed.tobytes(), "big") >> (4 * (nib.shape[0] - n)),
                4 * n)


def load_table(br: BitReader, alphabet_size: int):
    """Returns (lens, singleton): singleton >= 0 marks a zero-bit tree."""
    n_present = br.get_bits(16)
    lens = np.zeros(alphabet_size, dtype=np.uint8)
    if n_present == 0:
        return lens, -1
    if n_present == 1:
        return lens, br.get_bits(16)
    nbytes = (alphabet_size + 7) // 8
    mask = np.unpackbits(
        np.frombuffer(br.get_bits(8 * nbytes).to_bytes(nbytes, "big"), np.uint8)
    )[:alphabet_size].astype(bool)
    idx = np.flatnonzero(mask)
    n = idx.shape[0]
    raw = br.get_bits(4 * n)
    pad = n % 2
    nbuf = np.frombuffer(
        (raw << (4 * pad)).to_bytes((n + pad) // 2, "big"), np.uint8)
    nib = np.empty(n + pad, np.uint8)
    nib[0::2] = nbuf >> 4
    nib[1::2] = nbuf & 0xF
    lens[idx] = nib[:n] + 1
    return lens, -1

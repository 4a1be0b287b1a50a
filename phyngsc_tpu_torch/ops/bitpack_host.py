"""Host (numpy) bit-packing twins used by the title codec and the decoders.

Copied verbatim from phyngsc_tpu/ops/bitpack.py:303-432, host code in a
module that imports jax; the port never imports jax, so it keeps the copy.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32


def trim_rows_np(plane: np.ndarray, sub_n_words: np.ndarray) -> np.ndarray:
    """Host compaction of a pack_bits_rows plane: concat row s's first
    sub_n_words[s] words (the dense stream, = pack_bits_scatter output).
    One boolean-mask flatten — row-major selection preserves (row, column)
    order, so no per-substream Python iteration (S can be 1024+)."""
    plane = np.asarray(plane)
    if not plane.shape[0]:
        return np.zeros(0, np.uint32)
    n = np.asarray(sub_n_words).astype(np.int64)
    mask = np.arange(plane.shape[1], dtype=np.int64)[None, :] < n[:, None]
    return plane[mask]


def substream_layout_np(lens2d: np.ndarray, records_per_substream: int):
    R, L = lens2d.shape
    G = records_per_substream
    assert R % G == 0
    S = R // G
    lens = lens2d.astype(np.int64)
    sub_bits = lens.reshape(S, G * L).sum(axis=1)
    sub_n_words = (sub_bits + WORD_BITS - 1) // WORD_BITS
    sub_word_start = np.concatenate([[0], np.cumsum(sub_n_words)[:-1]])
    flat = lens.reshape(S, G * L)
    within = np.cumsum(flat, axis=1) - flat
    bit_offsets = (within + (sub_word_start * WORD_BITS)[:, None]).reshape(R, L)
    total = int(sub_word_start[-1] + sub_n_words[-1]) if S else 0
    return {
        "bit_offsets": bit_offsets.astype(np.int64),
        "sub_n_words": sub_n_words.astype(np.int32),
        "sub_word_start": sub_word_start.astype(np.int64),
        "total_words": total,
    }

def pack_bits_scatter_np(codes: np.ndarray, lens: np.ndarray,
                         bit_offsets: np.ndarray, n_words: int) -> np.ndarray:
    codes = codes.reshape(-1).astype(np.uint64)
    lens = lens.reshape(-1).astype(np.int64)
    off = bit_offsets.reshape(-1).astype(np.int64)
    w = off >> 5
    b = off & 31
    r = 32 - b
    fits = lens <= r
    sh_l = np.maximum(r - lens, 0).astype(np.uint64)
    sh_r = np.maximum(lens - r, 0).astype(np.uint64)
    sh_lo = np.clip(32 - (lens - r), 0, 63).astype(np.uint64)
    hi = np.where(fits, codes << sh_l, codes >> sh_r) & np.uint64(0xFFFFFFFF)
    lo = np.where(fits, np.uint64(0), (codes << sh_lo) & np.uint64(0xFFFFFFFF))
    nz = lens > 0
    words = np.zeros(n_words + 1, np.uint64)
    np.add.at(words, w[nz], hi[nz])
    np.add.at(words, np.minimum(w[nz] + 1, n_words), lo[nz])
    return words[:n_words].astype(np.uint32)


def extract_fixed_width_np(words: np.ndarray, bit_offsets: np.ndarray,
                           widths: np.ndarray) -> np.ndarray:
    words = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    o = bit_offsets.astype(np.int64)
    w = o >> 5
    b = (o & 31).astype(np.uint64)
    n = words.shape[0]
    w1 = words[np.clip(w, 0, n - 1)]
    w2 = words[np.clip(w + 1, 0, n - 1)]
    win = ((w1 << b) | (w2 >> (np.uint64(32) - b))) & np.uint64(0xFFFFFFFF)
    win = np.where(b == 0, w1, win)
    width = widths.astype(np.uint64)
    shifted = win >> (np.uint64(32) - np.maximum(width, 1))
    return np.where(width == 0, 0,
                    shifted & ((np.uint64(1) << width) - np.uint64(1))).astype(np.uint32)


def unpack_substreams_np(words: np.ndarray, sub_word_start: np.ndarray,
                         luts: np.ndarray, tree_ids: np.ndarray,
                         valid: np.ndarray, n_steps: int, lut_bits: int):
    """Host decode walk: native OpenMP twin when available (no per-step
    Python iteration — n_steps is O(title chars/substream) on real variable
    titles), numpy fallback otherwise. Both bit-identical to
    unpack_substreams."""
    from phyngsc_tpu.utils import native

    out = native.unpack_substreams(
        np.concatenate([np.asarray(words, np.uint32),
                        np.zeros(2, np.uint32)]),
        np.asarray(sub_word_start, np.int64), np.asarray(luts),
        np.asarray(tree_ids), np.asarray(valid), n_steps, lut_bits)
    if out is not None:
        return out
    return _unpack_substreams_py(words, sub_word_start, luts, tree_ids,
                                 valid, n_steps, lut_bits)


def _unpack_substreams_py(words: np.ndarray, sub_word_start: np.ndarray,
                          luts: np.ndarray, tree_ids: np.ndarray,
                          valid: np.ndarray, n_steps: int, lut_bits: int):
    """Vectorized-over-substreams numpy fallback (per-step Python loop)."""
    S = sub_word_start.shape[0]
    words = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    n = words.shape[0]
    word_idx = np.zeros(S, np.int64)
    bit_idx = np.zeros(S, np.int64)
    out = np.zeros((S, n_steps), np.int32)
    base0 = sub_word_start.astype(np.int64)
    for t in range(n_steps):
        base = base0 + word_idx
        w1 = words[np.clip(base, 0, n - 1)]
        w2 = words[np.clip(base + 1, 0, n - 1)]
        b = bit_idx.astype(np.uint64)
        win = ((w1 << b) | (w2 >> (np.uint64(32) - b))) & np.uint64(0xFFFFFFFF)
        win = np.where(bit_idx == 0, w1, win)
        idx = (win >> np.uint64(32 - lut_bits)).astype(np.int64)
        entry = luts[tree_ids[:, t], idx]
        out[:, t] = entry & 0x1FF
        l = np.where(valid[:, t], entry >> 9, 0)
        bit_idx = bit_idx + l
        word_idx = word_idx + (bit_idx >> 5)
        bit_idx = bit_idx & 31
    return out


def words_to_bytes(words: np.ndarray) -> bytes:
    """Serialize packed words big-endian (matches BitWriter's MSB-first bytes)."""
    return np.asarray(words, dtype=">u4").tobytes()


def bytes_to_words(data: bytes) -> np.ndarray:
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\x00" * pad
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


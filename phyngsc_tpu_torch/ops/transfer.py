"""Host<->device wire formats (port of phyngsc_tpu/ops/transfer.py).

Encode upload: the host packs the (R, L) sequence and quality planes into
uint32 words, DNA to 2 bits (or 2 bits plus sparse exception words, or 3
bits for ACGTN) and quality to 6 bits where the bytes allow, else raw
bytes; the device unpacks them with shift/mask passes (unpack_seq,
unpack_qual) and one scatter for the exception words. Word layout: `per`
values a word, value j in bits [32 - w(j+1), 32 - wj), so a value never
straddles two words. pack_lanes writes the same layout on the device, at
the widths of the decode's packed fetch.

Decode upload: the walk tables travel as their code lengths (ops/tables.py
lens_wire, 132 bytes a tree), from which the device builds them.

Words travel as int32 tensors holding the uint32 bits. torch's >> on int32
is arithmetic, so every shift is followed by a mask: the masked bits lie
inside the word, where both shifts agree.
"""

from __future__ import annotations

import numpy as np
import torch

# SEQ_* / QUAL_*, _PER, _EXC_MIN_BUCKET, _exc_bucket, _width, n_words,
# _pack_fixed_np, pack_seq_np, seq_alpha_small and pack_qual_np are copied
# from phyngsc_tpu/ops/transfer.py:29-169 (host code in a module that
# imports jax), the native import pointing at phyngsc_tpu_torch.

SEQ_RAW = 0
SEQ_2BIT = 1
SEQ_3BIT = 2
#: 2-bit base plane + sparse exception words `(flat_idx << 8) | raw_byte`
#: appended after it — IUPAC-rich reads (reference ambiguity set,
#: phyNGSC.cpp:184-206) are typically >99% ACGT, so raw bytes (4x upload)
#: for the whole plane just to carry a few ambiguity codes is waste. The
#: device reconstructs with ONE tiny scatter (mode="drop"; padding words
#: carry idx 0xFFFFFF, out of bounds by the f.size <= 0xFFFFFF guard).
SEQ_2BIT_EXC = 3
QUAL_RAW = 0
QUAL_6BIT = 1

_PER = {2: 16, 3: 10, 6: 5, 8: 4}  # width -> values per uint32 word

#: exception-word counts are padded to these buckets so sub-blocks with
#: different ambiguity counts share one compiled _analyze_all executable
_EXC_MIN_BUCKET = 1024


def _exc_bucket(k: int) -> int:
    b = _EXC_MIN_BUCKET
    while b < k:
        b <<= 1
    return b


def _width(kind: str, mode: int) -> int:
    if kind == "seq":
        return {SEQ_2BIT: 2, SEQ_3BIT: 3, SEQ_2BIT_EXC: 2}.get(mode, 8)
    return 6 if mode == QUAL_6BIT else 8


def n_words(n_values: int, kind: str, mode: int) -> int:
    """Word count of the fixed-width plane. For SEQ_2BIT_EXC this is the
    BASE (2-bit) plane only — the data-dependent exception words follow it;
    consumers derive their count from the buffer length."""
    per = _PER[_width(kind, mode)]
    return (n_values + per - 1) // per


def _pack_fixed_np(vals: np.ndarray, w: int) -> np.ndarray:
    per = _PER[w]
    pad = (-vals.size) % per
    v = np.concatenate([vals.reshape(-1).astype(np.uint32),
                        np.zeros(pad, np.uint32)])
    shifts = (32 - w * (np.arange(per) + 1)).astype(np.uint32)
    return np.bitwise_or.reduce(v.reshape(-1, per) << shifts[None, :], axis=1)


def pack_seq_np(seq: np.ndarray):
    """(R, L) uint8 sequence plane (padding 0) → (mode, uint32 words).

    Native fast path: one phyngsc_byte_scan census picks the mode and one
    phyngsc_pack_fixed pass packs with the mode's value map fused in —
    byte-identical to the numpy fallback below (tests/test_transfer.py)."""
    from phyngsc_tpu_torch.utils import native

    f = seq.reshape(-1)
    sc = native.byte_scan(f)
    acgt = None
    if sc is not None:
        n_bad = sc["n_non_acgt"]
        if n_bad == 0:
            return SEQ_2BIT, native.pack_fixed(f, 2, native.PACK_ACGT2)
        all_acgtn = n_bad == sc["n_N"]
    else:
        acgt = (f == 0) | (f == 65) | (f == 67) | (f == 71) | (f == 84)
        n_bad = int(f.size - np.count_nonzero(acgt))
        if n_bad == 0:
            return SEQ_2BIT, _pack_fixed_np((f >> 1) & 3, 2)
        all_acgtn = bool((acgt | (f == 78)).all())
    # sparse non-ACGT (N's, IUPAC ambiguity): 2-bit plane + exception list.
    # The 1/32 cap bounds the device scatter (~3% of cells worst case) and
    # guarantees the word count beats both 3-bit and raw even after the
    # bucket round-up: RL/16 + 2*RL/32 = RL/8 < RL/4 always, and exc mode
    # is preferred over 3-bit only when actually smaller (checked below).
    if f.size <= 0xFFFFFF and n_bad <= f.size // 32:
        n_exc = n_words(f.size, "seq", SEQ_2BIT) + _exc_bucket(n_bad)
        better_3bit = all_acgtn and n_words(f.size, "seq", SEQ_3BIT) <= n_exc
        # tiny planes: the minimum exception bucket can exceed the raw plane
        if n_exc < n_words(f.size, "seq", SEQ_RAW) and not better_3bit:
            exc = native.find_non_acgt(f, n_bad) if sc is not None else None
            if exc is None:
                if acgt is None:
                    acgt = ((f == 0) | (f == 65) | (f == 67) | (f == 71)
                            | (f == 84))
                exc = np.flatnonzero(~acgt)
            base = (native.pack_fixed(f, 2, native.PACK_ACGT2)
                    if sc is not None else _pack_fixed_np((f >> 1) & 3, 2))
            ew = np.full(n_exc - base.shape[0], 0xFFFFFFFF, np.uint32)
            ew[: exc.size] = (exc.astype(np.uint32) << np.uint32(8)) \
                | f[exc].astype(np.uint32)
            return SEQ_2BIT_EXC, np.concatenate([base, ew])
    if all_acgtn:  # ACGTN: N -> code 4
        if sc is not None:
            return SEQ_3BIT, native.pack_fixed(f, 3, native.PACK_ACGTN3)
        v = np.where(f == 78, 4, (f >> 1) & 3).astype(np.uint32)
        return SEQ_3BIT, _pack_fixed_np(v, 3)
    if sc is not None:
        return SEQ_RAW, native.pack_fixed(f, 8, native.PACK_RAW)
    return SEQ_RAW, _pack_fixed_np(f, 8)


def seq_alpha_small(mode: int, seq: np.ndarray) -> bool:
    """True when every sequence byte is < 128, enabling the 128-lane DNA
    histogram (half the one-hot compares of the 256-wide kernel). The 2/3-
    bit planes guarantee it by construction; EXC/RAW scan the plane (one
    SIMD max over ~2 MB)."""
    if mode in (SEQ_2BIT, SEQ_3BIT):
        return True
    return int(seq.max(initial=0)) < 128


def pack_qual_np(qual: np.ndarray):
    """(R, L) uint8 quality plane (padding 0) → (mode, uint32 words)."""
    from phyngsc_tpu_torch.utils import native

    f = qual.reshape(-1)
    sc = native.byte_scan(f)
    if sc is not None:
        if sc["n_non_q6"] == 0:
            return QUAL_6BIT, native.pack_fixed(f, 6, native.PACK_QUAL6)
        return QUAL_RAW, native.pack_fixed(f, 8, native.PACK_RAW)
    ok = (f == 0) | ((f >= 33) & (f <= 96))
    if ok.all():
        v = np.where(f == 0, 0, f.astype(np.int32) - 33).astype(np.uint32)
        return QUAL_6BIT, _pack_fixed_np(v, 6)
    return QUAL_RAW, _pack_fixed_np(f, 8)


# -- device side ------------------------------------------------------------

def _shifts(w: int, device) -> torch.Tensor:
    """(32 // w,) shifts of the values of a word, first value highest."""
    per = 32 // w
    return 32 - w * torch.arange(1, per + 1, dtype=torch.int32,
                                 device=device)


def _unpack_words(words: torch.Tensor, w: int, R: int,
                  L: int) -> torch.Tensor:
    """(n,) int32 words -> (R, L) int32 values of w bits."""
    lanes = (words[:, None] >> _shifts(w, words.device)) & ((1 << w) - 1)
    return lanes.reshape(-1)[: R * L].reshape(R, L)


def unpack_seq(words: torch.Tensor, mode: int, R: int, L: int) -> torch.Tensor:
    """Inverse of pack_seq_np on the device: int32 words (the uint32 bits)
    -> (R, L) uint8 symbols; padding cells of the 2/3-bit modes decode to
    'A', consumers mask by record length. For SEQ_2BIT_EXC the words are
    [base plane | exception words], the exception count taken from their
    length. Exception words whose symbol byte is 0 (zero padding) or whose
    index lies past R * L (the packer's 0xFFFFFFFF padding) write nothing:
    the scatter sends them to a sink cell past the plane."""
    if mode == SEQ_RAW:
        return _unpack_words(words, 8, R, L).to(torch.uint8)
    if mode == SEQ_2BIT_EXC:
        nb = n_words(R * L, "seq", SEQ_2BIT)
        base = unpack_seq(words[:nb], SEQ_2BIT, R, L).reshape(-1)
        return apply_exceptions(base, words[nb:], R * L).reshape(R, L)
    v = _unpack_words(words, 2 if mode == SEQ_2BIT else 3, R, L)
    # inverse of the nucleotide code: 0→'A' 1→'C' 2→'T' 3→'G' (4→'N')
    chars = (65 + torch.where(v == 1, 2, 0) + torch.where(v == 2, 19, 0)
             + torch.where(v == 3, 6, 0) + torch.where(v == 4, 13, 0))
    return chars.to(torch.uint8)


def apply_exceptions(flat: torch.Tensor, ew: torch.Tensor,
                     live) -> torch.Tensor:
    """SEQ_2BIT_EXC's exception words `ew` written into the (n,) uint8
    symbols `flat` (a new tensor): each word's byte at its index, but for
    words whose byte is 0 or whose index is `live` (the cells the live rows
    hold: an int, or a 0-d tensor on the device) or more, which the scatter
    sends to a sink cell past the plane."""
    n = flat.shape[0]
    sym = ew & 0xFF
    idx = ((ew >> 8) & 0xFFFFFF).long()
    idx = torch.where((sym == 0) | (idx >= live), n, idx)
    out = torch.cat([flat, flat.new_zeros(1)])
    out.scatter_(0, idx, sym.to(torch.uint8))
    return out[:n]


def words_at(words: torch.Tensor, start, n: int) -> torch.Tensor:
    """words[start : start + n] for a `start` known on the device only (a
    0-d tensor): one gather, positions past the buffer reading its last
    word."""
    idx = start + torch.arange(n, device=words.device)
    return words[idx.clamp(max=words.shape[0] - 1)]


def unpack_qual(words: torch.Tensor, mode: int, R: int,
                L: int) -> torch.Tensor:
    """Inverse of pack_qual_np on the device (6-bit padding decodes to
    chr(33))."""
    if mode == QUAL_RAW:
        return _unpack_words(words, 8, R, L).to(torch.uint8)
    return (_unpack_words(words, 6, R, L) + 33).to(torch.uint8)


def pack_lanes(vals: torch.Tensor, w: int) -> torch.Tensor:
    """(n,) values < 2^w (w dividing into 32 // w values a word: 2, 3, 4, 5,
    6 or 8 bits) -> (ceil(n / (32 // w)),) int32 words holding the uint32
    bits, in the layout above (phyngsc_tpu/pipeline/subblock.py:298
    _lane_pack_j). The fields are disjoint, so their sum is their OR; it
    is taken in int64 and wrapped to int32."""
    per = 32 // w
    v = vals.reshape(-1).long()
    pad = (-v.shape[0]) % per
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    words = (v.reshape(-1, per) << _shifts(w, v.device).long()).sum(dim=1)
    return words.to(torch.int32)


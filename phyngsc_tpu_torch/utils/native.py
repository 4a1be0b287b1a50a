# Adapted from phyngsc_tpu/utils/native.py: loads the port's own runtime.
"""ctypes loader for the port's host runtime (phyngsc_tpu_torch/native/
host_runtime.cpp).

The library is the one host_runtime.ensure() builds under build/host/, at
the first use from any entry point; a failed build or load raises. Every
wrapper returns None only under `PHYNGSC_NO_NATIVE=1`, which sends its
caller to the numpy version (the runtime's plain version, kept for tests).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from phyngsc_tpu_torch import host_runtime

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _find_lib_path() -> str:
    """The port's library (built on first use; RuntimeError when it
    cannot be)."""
    return host_runtime.ensure()


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("PHYNGSC_NO_NATIVE"):
        return None
    return _load_lib()


def _signatures() -> dict:
    """Each entry point's (restype, argtypes)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return {
        "phyngsc_threads": (ctypes.c_int, []),
        "phyngsc_set_threads": (ctypes.c_int, [ctypes.c_int]),
        "phyngsc_index_records": (
            i64, [vp, i64, i64p, i64p, i64p, i64p, i64p, i64p, i64,
                  ctypes.c_int]),
        "phyngsc_gather": (None, [vp, i64, i64p, i32p, i64, i64, vp]),
        "phyngsc_huffman_lengths": (None, [i64p, i32, i32, i32, vp, i32p]),
        "phyngsc_title_scan": (
            None, [vp, i32p, i64, i64, vp, i32, i32p, i32p, vp, i64p, vp]),
        "phyngsc_fastq_assemble": (
            None, [vp, i32p, i64, vp, vp, i32p, i64, i64p, i64, vp]),
        "phyngsc_title_walk": (
            None, [vp, i64, i64p, i64, i64, i32p, i32, i32, i32p, i32p,
                   i32p, i32p, i64, i64p, i32p, i32p]),
        "phyngsc_title_assemble": (
            None, [i32, i32p, i32p, i64p, i64p, i32p, i64p, i32p, vp, i64,
                   i64, vp]),
        "phyngsc_pack_fixed": (None, [vp, i64, i32, i32, vp]),
        "phyngsc_gather3": (
            i32, [vp, i64, i64p, i32p, i64, i64p, i64p, i32p, i64, i64, vp,
                  vp, vp]),
        "phyngsc_decode_tail": (
            None, [vp, vp, i64, i32, i32, i32, i32, vp, vp, vp, vp]),
        "phyngsc_find_non_acgt": (i64, [vp, i64, i64, vp]),
        "phyngsc_byte_scan": (None, [vp, i64, i64p]),
        "phyngsc_numeric_stats": (
            None, [i64p, i64, i64, i64, i64, i64p, i64p, i64p, i64p, i64p,
                   vp, vp]),
        "phyngsc_unpack_substreams": (
            None, [vp, i64, i64p, i64, i32p, i32, i32p, vp, i64, i32p]),
    }


def _bind(path: str) -> None:
    global _lib
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"the host runtime {path} cannot be loaded: {e}"
                           ) from e
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib


def loaded_path() -> Optional[str]:
    """The loaded library's path; None before the runtime's first use."""
    lib = _lib
    return None if lib is None else lib._name


def threads() -> int:
    """T, the threads each parallel region of the runtime may use."""
    return _load_lib().phyngsc_threads()


def set_threads(t: int) -> int:
    """Sets T (t <= 0: the CPUs the process may use); returns the new T."""
    return _load_lib().phyngsc_set_threads(int(t))


def _load_lib() -> ctypes.CDLL:
    """The library, whatever PHYNGSC_NO_NATIVE says."""
    if _lib is None:
        with _lock:
            if _lib is None:
                _bind(_find_lib_path())
    return _lib


def available() -> bool:
    return _load() is not None


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def index_records(buf: np.ndarray, validate: bool = True):
    """Returns the 6 span arrays, or None if native lib unavailable / invalid
    input (caller falls back to numpy for the error message)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    # minimum valid record is 6 bytes ("@\n\n+\n\n" — empty read); a smaller
    # divisor here silently truncated the index on tiny-record files
    cap = buf.shape[0] // 6 + 2
    outs = [np.empty(cap, np.int64) for _ in range(6)]
    n = lib.phyngsc_index_records(
        buf.ctypes.data, buf.shape[0], *(_i64p(o) for o in outs),
        cap, 1 if validate else 0,
    )
    if n < 0:
        return None  # validation failure → numpy path raises the right error
    if n >= cap:
        return None  # capacity exhausted (cannot happen with 6-byte floor,
        # but never silently truncate)
    return tuple(o[:n].copy() for o in outs)


def gather(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
           width: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    R = starts.shape[0]
    out = np.empty((R, width), np.uint8)
    lib.phyngsc_gather(
        buf.ctypes.data, buf.shape[0], _i64p(starts),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), R, width,
        out.ctypes.data,
    )
    return out


def title_scan(titles: np.ndarray, tlens: np.ndarray, separators: bytes,
               max_seps: int = 31):
    """Single-pass tokenize + numeric parse. Returns dict with nsep (R,),
    sep_pos/sep_chars (R, max_seps), values/numeric_ok (R, max_seps+1),
    or None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    titles = np.ascontiguousarray(titles, dtype=np.uint8)
    tlens = np.ascontiguousarray(tlens, dtype=np.int32)
    R, TL = titles.shape
    sep_tab = np.zeros(256, np.uint8)
    for c in separators:
        sep_tab[c] = 1
    # np.empty, not zeros: consumers only read sep_pos/chars[:, :nsep] and
    # values/numeric_ok[:, :nsep+1], all of which the scan writes (zeroing
    # these (R, 32) planes cost more than the scan itself at 64K records)
    nsep = np.empty(R, np.int32)
    sep_pos = np.empty((R, max_seps), np.int32)
    sep_chars = np.empty((R, max_seps), np.uint8)
    values = np.empty((R, max_seps + 1), np.int64)
    numeric_ok = np.empty((R, max_seps + 1), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.phyngsc_title_scan(
        titles.ctypes.data, tlens.ctypes.data_as(i32p), R, TL,
        sep_tab.ctypes.data, max_seps,
        nsep.ctypes.data_as(i32p), sep_pos.ctypes.data_as(i32p),
        sep_chars.ctypes.data, _i64p(values), numeric_ok.ctypes.data,
    )
    return {"nsep": nsep, "sep_pos": sep_pos, "sep_chars": sep_chars,
            "values": values, "numeric_ok": numeric_ok.astype(bool)}


#: phyngsc_pack_fixed transform codes (ops/transfer pack modes)
PACK_RAW, PACK_ACGT2, PACK_ACGTN3, PACK_QUAL6 = 0, 1, 2, 3


def pack_fixed(src: np.ndarray, w: int, transform: int = 0):
    """One-pass fixed-width MSB-first word pack of a uint8 plane with the
    per-byte transform applied in-kernel (twin of transfer._pack_fixed_np
    composed with the mode's value map). Returns uint32 words or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_pack_fixed"):
        return None
    src = np.ascontiguousarray(src.reshape(-1), dtype=np.uint8)
    per = {2: 16, 3: 10, 4: 8, 5: 6, 6: 5, 8: 4}[w]
    out = np.empty((src.size + per - 1) // per, np.uint32)
    lib.phyngsc_pack_fixed(src.ctypes.data, src.size, w, transform,
                           out.ctypes.data)
    return out


def gather3(buf: np.ndarray, t_start: np.ndarray, t_lens: np.ndarray,
            TW: int, s_start: np.ndarray, q_start: np.ndarray,
            lens: np.ndarray, W: int):
    """Fused title/seq/qual row gather (one pass over records) + max qual
    byte. Returns (titles, seq, qual, qmax) or None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_gather3"):
        return None
    buf = np.ascontiguousarray(buf, np.uint8)
    R = t_start.shape[0]
    t_start = np.ascontiguousarray(t_start, np.int64)
    s_start = np.ascontiguousarray(s_start, np.int64)
    q_start = np.ascontiguousarray(q_start, np.int64)
    t_lens = np.ascontiguousarray(t_lens, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    titles = np.empty((R, max(TW, 1)), np.uint8)
    seq = np.empty((R, max(W, 1)), np.uint8)
    qual = np.empty((R, max(W, 1)), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    qmax = lib.phyngsc_gather3(
        buf.ctypes.data, buf.shape[0], _i64p(t_start),
        t_lens.ctypes.data_as(i32p), max(TW, 1), _i64p(s_start),
        _i64p(q_start), lens.ctypes.data_as(i32p), max(W, 1), R,
        titles.ctypes.data, seq.ctypes.data, qual.ctypes.data)
    return titles, seq, qual, int(qmax)


def decode_tail(sw: np.ndarray, qw: np.ndarray, n: int, w: int,
                qw_bits: int, plus33: bool, qual8: bool,
                alpha: np.ndarray, amb: np.ndarray):
    """Fused output-tail: lane-unpack the index/quality planes + alphabet
    lookup + qual8 ambiguity restore in one pass. Returns (seq, qual) flat
    uint8 arrays of length n, or None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_decode_tail"):
        return None
    sw = np.ascontiguousarray(sw, np.uint32)
    qw = np.ascontiguousarray(qw, np.uint32)
    alpha = np.ascontiguousarray(alpha, np.uint8)
    amb = np.ascontiguousarray(amb, np.uint8)
    seq = np.empty(n, np.uint8)
    qual = np.empty(n, np.uint8)
    lib.phyngsc_decode_tail(
        sw.ctypes.data, qw.ctypes.data, n, w, qw_bits,
        1 if plus33 else 0, 1 if qual8 else 0, alpha.ctypes.data,
        amb.ctypes.data, seq.ctypes.data, qual.ctypes.data)
    return seq, qual


def find_non_acgt(src: np.ndarray, cap: int):
    """Ascending flat indices of non-ACGT/0 bytes (the SEQ_2BIT_EXC
    exception positions), or None when unavailable / count exceeds cap."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_find_non_acgt"):
        return None
    src = np.ascontiguousarray(src.reshape(-1), dtype=np.uint8)
    out = np.empty(max(cap, 1), np.uint32)
    n = lib.phyngsc_find_non_acgt(src.ctypes.data, src.size, cap,
                                  out.ctypes.data)
    if n > cap:
        return None
    return out[:n]


def byte_scan(src: np.ndarray):
    """One-pass census of a uint8 plane: dict with n_non_acgt (excluding 0),
    n_N, n_ge128, n_non_q6 — the counts transfer's pack-mode decisions
    need. Returns None when the native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_byte_scan"):
        return None
    src = np.ascontiguousarray(src.reshape(-1), dtype=np.uint8)
    out = np.empty(4, np.int64)
    lib.phyngsc_byte_scan(src.ctypes.data, src.size, _i64p(out))
    return {"n_non_acgt": int(out[0]), "n_N": int(out[1]),
            "n_ge128": int(out[2]), "n_non_q6": int(out[3])}


def numeric_stats(V: np.ndarray, B: int):
    """One-pass numeric-field planner statistics over the (R, F) title
    value matrix (twin of models/title._numeric_pre's numpy reductions).
    Returns dict or None when unavailable. Requires R >= 2."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_numeric_stats"):
        return None
    V = np.asarray(V, dtype=np.int64)
    R, F = V.shape
    # accept a leading-column SLICE of the title scan's value matrix
    # without copying: the kernel walks rows by an explicit stride
    if V.strides[1] != 8:
        V = np.ascontiguousarray(V)
    stride = V.strides[0] // 8
    nB = (R + B - 1) // B
    vmin = np.empty(F, np.int64)
    vmax = np.empty(F, np.int64)
    dmin = np.empty(F, np.int64)
    dmax = np.empty(F, np.int64)
    first_d = np.empty((nB, F), np.int64)
    bconst = np.empty((nB, F), np.uint8)
    bdconst = np.empty((nB, F), np.uint8)
    lib.phyngsc_numeric_stats(
        _i64p(V), R, F, stride, B, _i64p(vmin), _i64p(vmax), _i64p(dmin),
        _i64p(dmax), _i64p(first_d), bconst.ctypes.data,
        bdconst.ctypes.data,
    )
    return {"vmin": vmin, "vmax": vmax, "dmin": dmin, "dmax": dmax,
            "first_d": first_d, "const": bconst.astype(bool),
            "dconst": bdconst.astype(bool)}


def unpack_substreams(words: np.ndarray, sub_word_start: np.ndarray,
                      luts: np.ndarray, tree_ids: np.ndarray,
                      valid: np.ndarray, n_steps: int, lut_bits: int
                      ) -> Optional[np.ndarray]:
    """Substream-parallel LUT decode walk; bit-identical to
    ops/bitpack.unpack_substreams_np. Returns (S, n_steps) int32, or None
    when the native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_unpack_substreams"):
        return None
    S = int(sub_word_start.shape[0])
    words = np.ascontiguousarray(words, dtype=np.uint32)
    sub_word_start = np.ascontiguousarray(sub_word_start, dtype=np.int64)
    luts = np.ascontiguousarray(luts, dtype=np.int32)
    tree_ids = np.ascontiguousarray(tree_ids, dtype=np.int32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    out = np.empty((S, n_steps), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.phyngsc_unpack_substreams(
        words.ctypes.data, words.shape[0], _i64p(sub_word_start), S,
        luts.ctypes.data_as(i32p), lut_bits,
        tree_ids.ctypes.data_as(i32p), valid.ctypes.data, n_steps,
        out.ctypes.data_as(i32p),
    )
    return out


def fastq_assemble(titles: np.ndarray, tlens: np.ndarray, seq: np.ndarray,
                   qual: np.ndarray, lens: np.ndarray, offs: np.ndarray,
                   total: int) -> Optional[bytes]:
    """Per-record memcpy reassembly of FASTQ text (title\\nseq\\n+\\nqual\\n).
    Twin of the decompressor's numpy scatter. Returns bytes or None when the
    native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_fastq_assemble"):
        return None
    titles = np.ascontiguousarray(titles, dtype=np.uint8)
    tlens = np.ascontiguousarray(tlens, dtype=np.int32)
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    qual = np.ascontiguousarray(qual, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    R = tlens.shape[0]
    out = np.empty(total, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.phyngsc_fastq_assemble(
        titles.ctypes.data, tlens.ctypes.data_as(i32p),
        titles.shape[1] if titles.ndim == 2 else 0,
        seq.ctypes.data, qual.ctypes.data, lens.ctypes.data_as(i32p),
        seq.shape[1] if seq.ndim == 2 else 0,
        _i64p(offs), R, out.ctypes.data,
    )
    return out.tobytes()


def title_walk(words: np.ndarray, sub_word_start: np.ndarray, G: int,
               luts: np.ndarray, lut_bits: int, tree_base: np.ndarray,
               n_trees: np.ndarray, kinds: np.ndarray, steps: np.ndarray,
               R: int, out_w: np.ndarray):
    """Fused title-stream walk: returns a list of per-field (R, out_w[f])
    int32 symbol matrices, or None when the native lib is unavailable.
    kinds: 0 = char field (steps[r,f] symbols), 1 = NUM_HUF (1/record)."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_title_walk"):
        return None
    words = np.concatenate([np.ascontiguousarray(words, np.uint32),
                            np.zeros(2, np.uint32)])
    sub_word_start = np.ascontiguousarray(sub_word_start, np.int64)
    luts = np.ascontiguousarray(luts, np.int32)
    tree_base = np.ascontiguousarray(tree_base, np.int32)
    n_trees = np.ascontiguousarray(n_trees, np.int32)
    kinds = np.ascontiguousarray(kinds, np.int32)
    steps = np.ascontiguousarray(steps, np.int32)
    out_w = np.ascontiguousarray(out_w, np.int32)
    F = int(kinds.shape[0])
    sizes = out_w.astype(np.int64) * R
    out_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.empty(int(sizes.sum()), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.phyngsc_title_walk(
        words.ctypes.data, words.shape[0], _i64p(sub_word_start),
        sub_word_start.shape[0], G, luts.ctypes.data_as(i32p), lut_bits, F,
        tree_base.ctypes.data_as(i32p), n_trees.ctypes.data_as(i32p),
        kinds.ctypes.data_as(i32p), steps.ctypes.data_as(i32p), R,
        _i64p(out_off), out_w.ctypes.data_as(i32p),
        out.ctypes.data_as(i32p),
    )
    return [out[out_off[j] : out_off[j] + sizes[j]].reshape(R, int(out_w[j]))
            for j in range(F)]


def title_assemble(kinds: np.ndarray, field_lens: np.ndarray,
                   nvals: np.ndarray, nval_off: np.ndarray,
                   chars: np.ndarray, char_off: np.ndarray,
                   char_w: np.ndarray, seps: np.ndarray,
                   TL: int) -> Optional[np.ndarray]:
    """Fused title text reassembly → (R, TL) uint8, or None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "phyngsc_title_assemble"):
        return None
    kinds = np.ascontiguousarray(kinds, np.int32)
    field_lens = np.ascontiguousarray(field_lens, np.int32)
    nvals = np.ascontiguousarray(nvals, np.int64)
    nval_off = np.ascontiguousarray(nval_off, np.int64)
    chars = np.ascontiguousarray(chars, np.int32)
    char_off = np.ascontiguousarray(char_off, np.int64)
    char_w = np.ascontiguousarray(char_w, np.int32)
    seps = np.ascontiguousarray(seps, np.uint8)
    R, F = field_lens.shape
    titles = np.empty((R, max(TL, 1)), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.phyngsc_title_assemble(
        F, kinds.ctypes.data_as(i32p), field_lens.ctypes.data_as(i32p),
        _i64p(nvals), _i64p(nval_off), chars.ctypes.data_as(i32p),
        _i64p(char_off), char_w.ctypes.data_as(i32p), seps.ctypes.data,
        R, max(TL, 1), titles.ctypes.data,
    )
    return titles


def huffman_lengths(hist: np.ndarray, max_len: int):
    """(K, A) int64 → (lens (K, A) uint8, singletons (K,) int32), or None."""
    lib = _load()
    if lib is None:
        return None
    hist = np.ascontiguousarray(hist, dtype=np.int64)
    K, A = hist.shape
    n_max = int(np.count_nonzero(hist, axis=1).max()) if K else 0
    if n_max > (1 << max_len):
        # mirror the python builder's error (the C ABI has no error channel)
        raise ValueError(
            f"alphabet of {n_max} symbols cannot fit {max_len}-bit codes")
    lens = np.empty((K, A), np.uint8)
    singles = np.empty(K, np.int32)
    lib.phyngsc_huffman_lengths(
        _i64p(hist), K, A, max_len, lens.ctypes.data,
        singles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return lens, singles

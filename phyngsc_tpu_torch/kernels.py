"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

The sources compile at first use with nvcc into one shared library with a
plain C interface under build/kernels/ (named by a hash of the sources, so a
stale build is never loaded) and bind through ctypes. Each launch goes on
PyTorch's current stream, allocates nothing itself and is checked with
cudaGetLastError; a failed launch raises. LAUNCHES counts the launches of
each kernel; PLAIN_ON_CUDA counts calls of the plain PyTorch versions on CUDA
tensors (the pipeline never makes one: its wrappers take the plain versions
only for CPU tensors).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"k1_histogram": 0, "k2_walk_uniform": 0, "k3_walk_masked": 0,
            "k3_walk_masked/plain2": 0, "k3_walk_masked/huffman": 0,
            "k3_walk_masked/quality": 0, "k4_lookup": 0}
PLAIN_ON_CUDA = {"k1_histogram": 0, "k2_walk_uniform": 0, "k3_walk_masked": 0,
                 "k4_lookup": 0}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "phyngsc_hist": [_P, _P, _I64, _I, _I, _P, _P],
    "phyngsc_walk_uniform": [_P, _I64, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P, _P],
    "phyngsc_walk_masked": [_P, _I64, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _P, _P],
    "phyngsc_lookup": [_P, _P, _I64, _I, _I, _P, _P],
}


def reset_counts() -> None:
    with _lock:
        for d in (LAUNCHES, PLAIN_ON_CUDA):
            for k in d:
                d[k] = 0


def _count(table: dict, *names: str) -> None:
    with _lock:
        for n in names:
            table[n] += 1


def note_plain(name: str, t: torch.Tensor) -> None:
    """Called by each plain version: records a run on a CUDA tensor."""
    if t.is_cuda:
        _count(PLAIN_ON_CUDA, name)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libphyngsc_kernels_{h.hexdigest()[:12]}.so")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def histogram(sym: torch.Tensor, mask: torch.Tensor, A: int) -> torch.Tensor:
    """K1: (R, L) uint8 symbols, (R, L) uint8 mask -> (L, A) int32 counts of
    masked symbols < A."""
    _require(sym, "symbols", torch.uint8)
    _require(mask, "mask", torch.uint8)
    R, L = sym.shape
    if mask.shape != sym.shape or A not in (128, 256) or L > 65535:
        raise ValueError(f"histogram: bad shapes {tuple(sym.shape)} "
                         f"{tuple(mask.shape)} A={A}")
    out = torch.zeros((L, A), dtype=torch.int32, device=sym.device)
    if R == 0 or L == 0:
        return out
    rc = build().phyngsc_hist(sym.data_ptr(), mask.data_ptr(), R, L, A,
                              out.data_ptr(), _stream())
    _check(rc, "k1_histogram")
    _count(LAUNCHES, "k1_histogram")
    return out


def _check_walk(words, word_start, lut_bits):
    _require(words, "words", torch.int32)
    _require(word_start, "word_start", torch.int64)
    if not 1 <= lut_bits <= 16:
        raise ValueError(f"lut_bits {lut_bits} out of range")


def walk_uniform(words: torch.Tensor, word_start: torch.Tensor,
                 totals: torch.Tensor, luts: torch.Tensor,
                 tree_of_pos: torch.Tensor, lut_bits: int, G: int, Lt: int,
                 L: int) -> torch.Tensor:
    """K2: uniform-length walk -> (S*G, L) uint8 symbols (0 past each lane's
    total and at positions >= Lt)."""
    _check_walk(words, word_start, lut_bits)
    _require(totals, "totals", torch.int32)
    _require(luts, "luts", torch.int32)
    _require(tree_of_pos, "tree_of_pos", torch.int32)
    S = word_start.shape[0]
    if (totals.shape != (S,) or luts.ndim != 2
            or luts.shape[1] != 1 << lut_bits or tree_of_pos.shape[0] < Lt
            or Lt > L):
        raise ValueError("walk_uniform: bad shapes")
    out = torch.zeros((S * G, L), dtype=torch.uint8, device=words.device)
    if S == 0:
        return out
    rc = build().phyngsc_walk_uniform(
        words.data_ptr(), words.shape[0], word_start.data_ptr(),
        totals.data_ptr(), luts.data_ptr(), tree_of_pos.data_ptr(), lut_bits,
        S, G, Lt, L, out.data_ptr(), _stream())
    _check(rc, "k2_walk_uniform")
    _count(LAUNCHES, "k2_walk_uniform")
    return out


def walk_masked(words: torch.Tensor, word_start: torch.Tensor,
                totals: torch.Tensor, keep: torch.Tensor, luts, tree_of_pos,
                lut_bits: int, plain2: bool) -> torch.Tensor:
    """K3: masked walk over (S, T) slots -> (S, T) uint8 symbols (0 where
    keep is unset). Slot t takes tree tree_of_pos[t % L] of the
    (n_trees, 2^lut_bits) int32 luts, L = len(tree_of_pos) dividing T; both
    are None for plain2. Counted as the plain2, huffman (one position, the
    DNA stream) or quality (per-position trees) variant."""
    _check_walk(words, word_start, lut_bits)
    _require(totals, "totals", torch.int32)
    _require(keep, "keep", torch.uint8)
    S = word_start.shape[0]
    if keep.ndim != 2 or keep.shape[0] != S or totals.shape != (S,):
        raise ValueError("walk_masked: bad shapes")
    T = keep.shape[1]
    n_trees, L = 1, 1
    if not plain2:
        _require(luts, "luts", torch.int32)
        _require(tree_of_pos, "tree_of_pos", torch.int32)
        n_trees, L = luts.shape[0], tree_of_pos.shape[0]
        if (luts.ndim != 2 or luts.shape[1] != 1 << lut_bits or n_trees < 1
                or tree_of_pos.ndim != 1 or L < 1 or T % L):
            raise ValueError("walk_masked: bad LUT or tree shapes")
    out = torch.zeros((S, T), dtype=torch.uint8, device=words.device)
    if S == 0:
        return out
    rc = build().phyngsc_walk_masked(
        words.data_ptr(), words.shape[0], word_start.data_ptr(),
        totals.data_ptr(), keep.data_ptr(),
        None if plain2 else luts.data_ptr(),
        None if plain2 else tree_of_pos.data_ptr(), n_trees, int(plain2),
        lut_bits, S, T, L, out.data_ptr(), _stream())
    _check(rc, "k3_walk_masked")
    variant = "plain2" if plain2 else "huffman" if L == 1 else "quality"
    _count(LAUNCHES, "k3_walk_masked", f"k3_walk_masked/{variant}")
    return out


def lookup(sym: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """K4: (R, L) uint8 symbols, (L, A) int32 table -> (R, L) int32,
    out[r, p] = tab[p, sym[r, p]], 0 where sym[r, p] >= A."""
    _require(sym, "symbols", torch.uint8)
    _require(tab, "table", torch.int32)
    R, L = sym.shape
    if tab.ndim != 2 or tab.shape[0] != L or not 1 <= tab.shape[1] <= 256:
        raise ValueError(f"lookup: bad shapes {tuple(sym.shape)} "
                         f"{tuple(tab.shape)}")
    out = torch.empty((R, L), dtype=torch.int32, device=sym.device)
    if R == 0 or L == 0:
        return out
    rc = build().phyngsc_lookup(sym.data_ptr(), tab.data_ptr(), R, L,
                                tab.shape[1], out.data_ptr(), _stream())
    _check(rc, "k4_lookup")
    _count(LAUNCHES, "k4_lookup")
    return out

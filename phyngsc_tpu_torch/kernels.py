"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu): K1
histogram, K2/K3 walks, K4 lookup, K5 densify, K6 decode tables.

The sources compile at first use with nvcc into one shared library with a
plain C interface under build/kernels/ (named by a hash of the sources, so a
stale build is never loaded) and bind through ctypes, each entry point's
argument types set once at load; what ptxas reports of each kernel
(registers, shared memory, spills) is kept beside the library (build_log).
The wrappers reach the loaded library without a lock once it is built. Each
launch goes on PyTorch's current stream of its tensors' device, read raw,
with that device current (from any thread), allocates nothing itself and is
checked with cudaGetLastError; a failed launch raises. LAUNCHES
counts the launches of each kernel; PLAIN_ON_CUDA counts calls of the plain
PyTorch versions on CUDA tensors (the pipeline never makes one: its wrappers
take the plain versions only for CPU tensors).
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
#: threads per block of the walks, one lane each (kThreads in csrc/walk.cu)
WALK_THREADS = 64
#: shared memory of each walk lane: its ring of 32 plane words and its 16
#: staged output bytes (kLaneBytes in csrc/walk.cu)
WALK_LANE_BYTES = 4 * 32 + 16


def masked_ids(L: int) -> int:
    """Tree ids a K3 block stages for L positions (masked_ids in
    csrc/walk.cu): L + 15 (slots of a 16-slot group read ids past L without
    a modulo), or 1 for the one-tree variant."""
    return 1 if L == 1 else L + 15


#: dynamic shared memory that one block may hold on an H100 (227 KB)
SMEM_BYTES = 232448


def _walk_smem(n_tables: int, n_ids: int) -> int:
    """Shared memory of a walk block (csrc/walk.cu ring_offset): the tables'
    uint16 entries, the tree ids padded to 8, a lane area per thread."""
    return (2 * n_tables + 2 * (-(-n_ids // 8) * 8)
            + WALK_LANE_BYTES * WALK_THREADS)


def table_budget(n_ids: int) -> int:
    """Bytes left for a walk's tables beside n_ids tree ids and the lanes'
    areas."""
    return SMEM_BYTES - _walk_smem(0, n_ids)


#: threads of a K4 block, and the symbols each of its warps stages in its
#: shared-memory tile (kThreads, kSpan in csrc/lookup.cu)
LOOKUP_THREADS = 512
LOOKUP_SPAN = 512


def lookup_smem(T: int, A: int, n_ids: int) -> int:
    """Shared memory of a K4 block (csrc/lookup.cu): the (T, A) uint16
    table and n_ids tree ids, each padded to 16 bytes, and a tile a warp."""
    return (-(-2 * T * A // 16) * 16 + -(-n_ids // 16) * 16
            + LOOKUP_THREADS // 32 * LOOKUP_SPAN)


LAUNCHES = {"k1_histogram": 0, "k2_walk_uniform": 0, "k3_walk_masked": 0,
            "k3_walk_masked/plain2": 0, "k3_walk_masked/huffman": 0,
            "k3_walk_masked/quality": 0, "k4_lookup": 0, "k5_densify": 0,
            "k6_tables": 0}
PLAIN_ON_CUDA = {"k1_histogram": 0, "k2_walk_uniform": 0, "k3_walk_masked": 0,
                 "k4_lookup": 0, "k5_densify": 0, "k6_tables": 0}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "phyngsc_hist": [_P, _P, _I, _I, _I, _P, _P],
    "phyngsc_walk_uniform": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _I, _P,
                             _I, _I, _I, _I, _P, _P],
    "phyngsc_walk_masked": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I, _I,
                            _P, _I, _I, _I, _I, _P, _P],
    "phyngsc_lookup": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "phyngsc_densify": [_P, _I64, _P, _I, _I, _I, _P, _P],
    "phyngsc_tables": [_I, *[_P, _P, _I, _I, _I, _I, _I, _P, _P] * 2, _P],
    "phyngsc_empty": [_I, _P],
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
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sorted(glob.glob(os.path.join(SRC_DIR, "*"))):  # headers too
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
            with open(f"{path}.log", "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build_log() -> str:
    """nvcc's output for the loaded library (ptxas -v: registers, shared
    memory and spills of each kernel)."""
    build()
    try:
        with open(f"{library_path()}.log") as f:
            return f.read()
    except OSError:
        return ""


def _bound() -> ctypes.CDLL:
    """The loaded library: after the first build a plain read, without
    build()'s lock."""
    lib = _lib
    return lib if lib is not None else build()


def _launch(fn, t: torch.Tensor, *args) -> int:
    """fn(*args, stream), with stream the raw current CUDA stream of t's
    device (what torch.cuda.current_stream(device).cuda_stream gives,
    without building a Stream object per launch) and t's device the current
    one: the launchers size their grids from the current device (csrc/
    device.h), and a thread's current device is its own (a pool's worker
    thread starts on device 0)."""
    dev = t.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if torch.cuda.current_device() == dev:
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


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
    """K1: (R, L) uint8 symbols, (R, L) bool or uint8 mask (a nonzero byte
    counts; a bool mask is read in place) -> (L, A) int32 counts of the
    masked symbols < A, 1 <= A <= 256, R * L < 2^31. The kernel zeroes the
    counts itself, on the stream."""
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    _require(sym, "symbols", torch.uint8)
    _require(mask, "mask", torch.uint8)
    R, L = sym.shape
    if mask.shape != sym.shape or not 1 <= A <= 256 or R * L >= 1 << 31:
        raise ValueError(f"histogram: bad shapes {tuple(sym.shape)} "
                         f"{tuple(mask.shape)} A={A}")
    out = torch.empty((L, A), dtype=torch.int32, device=sym.device)
    if R == 0 or L == 0:
        return out.zero_()
    sym, mask = _aligned16(sym), _aligned16(mask)  # 16-byte loads
    rc = _launch(_bound().phyngsc_hist, out, sym.data_ptr(), mask.data_ptr(),
                 R, L, A, out.data_ptr())
    _check(rc, "k1_histogram")
    _count(LAUNCHES, "k1_histogram")
    return out


def _check_plane(plane: torch.Tensor, S: int) -> None:
    _require(plane, "plane", torch.int32)
    if plane.ndim != 2 or S > plane.shape[1]:
        raise ValueError(f"walk: plane {tuple(plane.shape)} has fewer than "
                         f"{S} lanes")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on a 16-byte boundary (the walks load
    and store 16 bytes at a time), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tables(luts, n_ids: int):
    """(packed table, the launch arguments of a walk's WalkLuts
    (ops/bitpack.py): packed table, its length, k, n_primary, full LUTs,
    n_trees, lut_bits). k = 0 and no entries: the kernel reads the full
    LUTs alone. The caller holds the table until the launch."""
    _require(luts.full, "luts", torch.int32)
    _require(luts.packed, "packed luts", torch.int16)
    n_trees, V = luts.full.shape
    n = luts.packed.shape[0]
    bits, k = luts.lut_bits, luts.k
    if (not 0 <= k <= bits or not 1 <= bits <= 16 or V != 1 << bits
            or n_trees < 1 or luts.n_primary != (n_trees << k if k else 0)
            or n % 8 or n < luts.n_primary or (k == 0) != (n == 0)
            or _walk_smem(n, n_ids) > SMEM_BYTES):
        raise ValueError(f"walk: bad tables k={k} lut_bits={bits} "
                         f"n_trees={n_trees} entries={n}")
    packed = _aligned16(luts.packed)
    return packed, (packed.data_ptr() if n else None, n, k, luts.n_primary,
                    luts.full.data_ptr(), n_trees, bits)


def walk_uniform(plane: torch.Tensor, totals: torch.Tensor, luts,
                 tree_of_pos: torch.Tensor, G: int, Lt: int,
                 L: int) -> torch.Tensor:
    """K2: uniform-length walk of the S = len(totals) lanes of the (Wmax, Sp)
    word plane with the WalkLuts `luts` (ops/bitpack.py walk_luts) ->
    (S*G, L) uint8 symbols (0 past each lane's total and at positions >=
    Lt)."""
    _require(totals, "totals", torch.int32)
    S = totals.shape[0]
    _check_plane(plane, S)
    _require(tree_of_pos, "tree_of_pos", torch.int32)
    if totals.ndim != 1 or tree_of_pos.shape[0] < Lt or Lt > L:
        raise ValueError("walk_uniform: bad shapes")
    packed, tables = _tables(luts, Lt)
    out = torch.zeros((S * G, L), dtype=torch.uint8, device=plane.device)
    if S == 0:
        return out
    rc = _launch(
        _bound().phyngsc_walk_uniform, out, plane.data_ptr(), plane.shape[0],
        plane.shape[1], totals.data_ptr(), *tables, tree_of_pos.data_ptr(), S,
        G, Lt, L, out.data_ptr())
    _check(rc, "k2_walk_uniform")
    _count(LAUNCHES, "k2_walk_uniform")
    return out


def walk_masked(plane: torch.Tensor, totals: torch.Tensor,
                keep: torch.Tensor, luts, tree_of_pos,
                plain2: bool) -> torch.Tensor:
    """K3: masked walk of the S = len(keep) lanes of the (Wmax, Sp) word
    plane over (S, T) slots -> (S, T) uint8 symbols (0 where keep is unset).
    Slot t takes tree tree_of_pos[t % L] of the WalkLuts `luts`, L =
    len(tree_of_pos) dividing T; both are None for plain2. Counted as the
    plain2, huffman (one position, the DNA stream) or quality (per-position
    trees) variant."""
    _require(totals, "totals", torch.int32)
    _require(keep, "keep", torch.uint8)
    if keep.ndim != 2 or totals.shape != keep.shape[:1]:
        raise ValueError("walk_masked: bad shapes")
    S, T = keep.shape
    _check_plane(plane, S)
    L, packed, tables = 1, None, (None, 0, 0, 0, None, 1, 2)
    if not plain2:
        _require(tree_of_pos, "tree_of_pos", torch.int32)
        L = tree_of_pos.shape[0]
        if tree_of_pos.ndim != 1 or L < 1 or T % L:
            raise ValueError("walk_masked: bad tree shapes")
        packed, tables = _tables(luts, masked_ids(L))
    keep = _aligned16(keep)
    out = torch.zeros((S, T), dtype=torch.uint8, device=plane.device)
    if S == 0:
        return out
    rc = _launch(
        _bound().phyngsc_walk_masked, out, plane.data_ptr(), plane.shape[0],
        plane.shape[1], totals.data_ptr(), keep.data_ptr(), *tables,
        None if plain2 else tree_of_pos.data_ptr(), int(plain2), S, T, L,
        out.data_ptr())
    _check(rc, "k3_walk_masked")
    variant = "plain2" if plain2 else "huffman" if L == 1 else "quality"
    _count(LAUNCHES, "k3_walk_masked", f"k3_walk_masked/{variant}")
    return out


def lookup(sym: torch.Tensor, tab: torch.Tensor,
           tree: torch.Tensor | None = None) -> torch.Tensor:
    """K4: (R, L) uint8 symbols, (T, A) int16 table holding uint16 fused
    entries, (L,) uint8 tree ids (None when T == 1; ignored then) -> (R, L)
    int32, out[r, p] = tab[tree[p], sym[r, p]] & 0xFFFF, 0 where sym[r, p]
    >= A; an id >= T reads tree T - 1. 1 <= T, A <= 256, R * L < 2^31, and
    the table and the ids fit one block's shared memory beside its warps'
    tiles (lookup_smem)."""
    _require(sym, "symbols", torch.uint8)
    _require(tab, "table", torch.int16)
    R, L = sym.shape
    T, A = tab.shape if tab.ndim == 2 else (0, 0)
    if T == 1:
        tree = None
    elif tree is not None:
        _require(tree, "tree ids", torch.uint8)
    if (not 1 <= T <= 256 or not 1 <= A <= 256 or R * L >= 1 << 31
            or (T > 1 and (tree is None or tree.shape != (L,)))
            or lookup_smem(T, A, L if T > 1 else 0) > SMEM_BYTES):
        raise ValueError(f"lookup: bad shapes {tuple(sym.shape)} "
                         f"{tuple(tab.shape)} tree="
                         f"{None if tree is None else tuple(tree.shape)}")
    out = torch.empty((R, L), dtype=torch.int32, device=sym.device)
    if R == 0 or L == 0:
        return out
    sym, tab = _aligned16(sym), _aligned16(tab)  # 16-byte loads
    if tree is not None:
        tree = _aligned16(tree)
    rc = _launch(_bound().phyngsc_lookup, out, sym.data_ptr(), tab.data_ptr(),
                 None if tree is None else tree.data_ptr(), R * L, L, A, T,
                 out.data_ptr())
    _check(rc, "k4_lookup")
    _count(LAUNCHES, "k4_lookup")
    return out


def densify(words: torch.Tensor, lanes: torch.Tensor, Wmax: int,
            Sp: int) -> torch.Tensor:
    """K5: (N,) int32 linear words (uint32 bits) and the (2, S) int64 lane
    table (ops/bitpack.py lane_table: row 0 each lane's first word, row 1
    its word count) -> (Wmax, Sp) int32 plane, out[w, s] = words[start[s] +
    w] for w < count[s], else 0 (pad lanes s >= S and reads outside the
    words included). Only the checks that keep the launch inside its
    buffers run here: the kernel bounds every index."""
    _require(words, "words", torch.int32)
    _require(lanes, "lanes", torch.int64)
    S = lanes.shape[1] if lanes.ndim == 2 else -1
    if (words.ndim != 1 or S < 0 or lanes.shape[0] != 2 or S > Sp
            or lanes.get_device() != words.get_device()
            or not 0 < Wmax < 1 << 31 or not 0 < Sp < 1 << 31):
        raise ValueError(f"densify: bad shapes lanes={tuple(lanes.shape)} "
                         f"Wmax={Wmax} Sp={Sp}")
    out = words.new_empty((Wmax, Sp))
    rc = _launch(_bound().phyngsc_densify, out, words.data_ptr(),
                 words.shape[0], lanes.data_ptr(), S, Wmax, Sp,
                 out.data_ptr())
    _check(rc, "k5_densify")
    _count(LAUNCHES, "k5_densify")
    return out


#: the launch arguments of K6's absent second stream
_NO_STREAM = (None, None, 0, 0, 0, 0, 0, None, None)


def decode_tables(lut_bits: int, streams) -> list:
    """K6: the walk tables of one or two streams of a sub-block (quality,
    then Huffman DNA) in one launch. Each stream is (words, n_trees,
    layout, k, own, n_blocks, n): its (n_trees * 33,) int32 lens4 words
    (ops/bitpack_host.py pack_lens4_np) and the host's ops/tables.py Layout
    of the same lengths, layout its (3, n_trees) int32 per-tree rows (None
    and n = 0 when k = 0) -> a (full, packed) pair a stream: full
    (n_trees, 2^lut_bits) int32 LUTs of (len << 9) | sym, packed (n,)
    int16 holding the uint16 two-level table of ops/bitpack.py
    two_level_luts; all views of one allocation."""
    if not (0 < len(streams) <= 2 and 0 < lut_bits <= 16):
        raise ValueError(f"decode_tables: {len(streams)} streams, "
                         f"lut_bits={lut_bits}")
    V = 1 << lut_bits
    dev = streams[0][0].get_device()
    n_full = n_packed = 0
    for words, n_trees, layout, k, own, n_blocks, n in streams:
        _require(words, "lens words", torch.int32)
        if k:
            _require(layout, "layout", torch.int32)
            ok = (0 < k <= lut_bits and layout.shape == (3, n_trees)
                  and layout.get_device() == dev
                  and 0 <= own <= n_blocks <= own + 1
                  and n == ((n_trees << k) + (n_blocks << lut_bits - k) + 7)
                  // 8 * 8)
        else:
            ok = n == own == n_blocks == 0 and layout is None
        if not (ok and words.shape == (33 * n_trees,)
                and words.get_device() == dev and 0 < n_trees < 1 << 16
                and n_trees * V < 1 << 31 and n < 1 << 31):
            raise ValueError(f"decode_tables: {tuple(words.shape)} words for "
                             f"{n_trees} trees, lut_bits={lut_bits} k={k} "
                             f"own={own} blocks={n_blocks} entries={n}")
        n_full += n_trees * V
        n_packed += n // 2
    buf = torch.empty(n_full + n_packed, dtype=torch.int32,
                      device=streams[0][0].device)
    base, at, packed_at = buf.data_ptr(), 0, n_full
    out, args = [], []
    for words, n_trees, layout, k, own, n_blocks, n in streams:
        out.append((buf.as_strided((n_trees, V), (V, 1), at), buf.as_strided(
            (n // 2,), (1,), packed_at).view(torch.int16)))
        args += [words.data_ptr(),
                 None if layout is None else layout.data_ptr(), n_trees, k,
                 own, n_blocks, n, base + 4 * at,
                 base + 4 * packed_at if n else None]
        at += n_trees * V
        packed_at += n // 2
    if len(streams) == 1:
        args += _NO_STREAM
    rc = _launch(_bound().phyngsc_tables, buf, lut_bits, *args)
    _check(rc, "k6_tables")
    _count(LAUNCHES, "k6_tables")
    return out


def empty_launch(device, blocks: int) -> None:
    """An empty kernel of `blocks` blocks of 256 threads on the device's
    current stream: the device time of a launch alone (chip_smoke's floor
    under K5 and K6). Not a kernel of the path, and not counted."""
    t = torch.empty(0, device=device)
    _check(_launch(_bound().phyngsc_empty, t, blocks), "empty")

"""The port's own host runtime (phyngsc_tpu_torch/native/host_runtime.cpp on
the std::thread pool of host_threads.h, built by host_runtime.py into
build/host/) against the JAX package's OpenMP build of
native/host_runtime.cpp (through phyngsc_tpu.utils.native) and against the
port's numpy versions.

Each of the 12 entry points that the JAX package's runtime shares is
reached through the port's code that calls it (a stage: the gathers, the
wire's packers, the table build, the title decode, the decode's tail, the
reassembly), on seeded inputs of 0, 1, 127
and 65,537 items and on one ERR005195 sub-block's: the stage's output at 1,
2, 3 and 8 threads equals its output under PHYNGSC_NO_NATIVE=1 (the numpy
versions), and every call the stage made into the port's runtime gives
what the same call gives in the JAX package's. Then: concurrent callers,
where the library lives, what a run writes, the first build from a fresh
tree (by the multi-process compress), a failed build, and no OpenMP in the
port."""

import contextlib
import dataclasses
import functools
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from phyngsc_tpu.utils import native as jnative
from phyngsc_tpu_torch import host_runtime
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import quality, title
from phyngsc_tpu_torch.ops import transfer
from phyngsc_tpu_torch.pipeline import compress, subblock
from phyngsc_tpu_torch.utils import fastq
from phyngsc_tpu_torch.utils import native

from torch_time_limit import time_limit

_limit = time_limit(60)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = (1, 2, 3, 8)
SIZES = [0, 1, 127, 65537, "ERR"]
CFG = CodecConfig()
NO_NATIVE = "PHYNGSC_NO_NATIVE"


@functools.lru_cache(maxsize=None)
def _err_subblock() -> bytes:
    """The first sub-block of the ERR005195 36 bp corpus as compress_bytes
    cuts it."""
    data = fastq.synthesize_fastq(70000, read_len=36, seed=1)
    buf = np.frombuffer(data, np.uint8)
    cfg = compress.resolve_substream(buf, CodecConfig())
    regions = compress.partition_regions(buf, 1, cfg)
    _, idx = next(compress.iter_subblock_tasks(buf, regions, cfg))
    return data[int(idx.title_start[0]):int(idx.qual_end[-1]) + 1]


@contextlib.contextmanager
def _no_native():
    """The port's numpy versions, as PHYNGSC_NO_NATIVE=1 selects them."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv(NO_NATIVE, "1")
        yield


class Scenario:
    """The inputs of every stage at one size: `size` records (or one ERR
    sub-block) of FASTQ, its index, planes and titles, flat sequence and
    quality planes of `size` bytes (or the sub-block's planes), quality
    histograms of `size` symbols, and the sub-block's encoded titles."""

    def __init__(self, size):
        rng = np.random.default_rng(0 if size == "ERR" else 1000 + size)
        data = (_err_subblock() if size == "ERR" else fastq.synthesize_fastq(
            size, read_len=36, seed=size, ambiguity_rate=0.01))
        self.buf = np.frombuffer(data, np.uint8)
        with _no_native():
            self.idx = fastq.index_records(self.buf)
        idx = self.idx
        self.R = R = idx.title_start.shape[0]
        self.lens = (idx.seq_end - idx.seq_start).astype(np.int32)
        self.tlens = (idx.title_end - idx.title_start).astype(np.int32)
        self.L = int(self.lens.max()) if R else 1
        self.TL = int(self.tlens.max()) if R else 1
        with _no_native():
            self.seq = subblock._gather_matrix(
                self.buf, idx.seq_start, self.lens.astype(np.int64), self.L)
            self.qual = subblock._gather_matrix(
                self.buf, idx.qual_start, self.lens.astype(np.int64), self.L)
            self.titles = subblock._gather_matrix(
                self.buf, idx.title_start, self.tlens.astype(np.int64),
                self.TL)
        n = self.seq.size if size == "ERR" else size
        acgt = np.frombuffer(b"ACGT", np.uint8)
        pure = acgt[rng.integers(0, 4, size=n)]
        pure[n - n // 10:] = 0  # padding
        planes = []
        for rate, alphabet in ((0.01, b"NRYKM"), (0.1, b"N"), (0.1, b"RYN")):
            p = pure.copy()
            hit = rng.random(n) < rate
            p[hit] = np.frombuffer(alphabet, np.uint8)[
                rng.integers(0, len(alphabet), size=int(hit.sum()))]
            planes.append(p)
        self.seq_planes = [pure, *planes]
        q6 = rng.integers(33, 97, size=n).astype(np.uint8)
        q6[n - n // 10:] = 0
        self.qual_planes = [q6, rng.integers(33, 127, size=n).astype(np.uint8)]
        if size == "ERR":  # its planes, its per-position quality histogram
            self.seq_planes.append(self.seq.reshape(-1))
            self.qual_planes.append(self.qual.reshape(-1))
            pos = np.broadcast_to(np.arange(self.L), self.qual.shape)
            self.hist = np.zeros((self.L, 256), np.int64)
            np.add.at(self.hist, (pos.reshape(-1), self.qual.reshape(-1)), 1)
        else:  # `size` Zipf symbols over 36 trees of 64 symbols
            self.hist = np.zeros((36, 64), np.int64)
            sym = np.minimum(rng.zipf(1.4, size=size) - 1, 63)
            np.add.at(self.hist, (rng.integers(0, 36, size=size), sym), 1)
        with _no_native():
            self.enc = title.encode(self.titles, self.tlens, CFG) if R else None


@functools.lru_cache(maxsize=None)
def _scenario(size) -> Scenario:
    return Scenario(size)


# -- the stages: the port's code that reaches each entry point ---------------

def st_index_records(sc):
    ix = fastq.index_records(sc.buf)
    return [getattr(ix, f.name) for f in dataclasses.fields(ix)]


def st_gather(sc):
    return [subblock._gather_matrix(sc.buf, sc.idx.seq_start,
                                    sc.lens.astype(np.int64), sc.L),
            subblock._gather_matrix(sc.buf, sc.idx.title_start,
                                    sc.tlens.astype(np.int64), sc.TL)]


def st_gather3(sc):
    """stage A's gather (subblock.stage_a: gather3, else three
    _gather_matrix and the quality plane's max)."""
    idx = sc.idx
    g3 = native.gather3(sc.buf, idx.title_start, sc.tlens, sc.TL,
                        idx.seq_start, idx.qual_start, sc.lens, sc.L)
    if g3 is not None:
        return list(g3)
    planes = [subblock._gather_matrix(sc.buf, s, n.astype(np.int64), w)
              for s, n, w in ((idx.title_start, sc.tlens, sc.TL),
                              (idx.seq_start, sc.lens, sc.L),
                              (idx.qual_start, sc.lens, sc.L))]
    return planes + [int(planes[2].max()) if sc.R else 0]


def st_huffman_lengths(sc):
    t = quality.build_tables(sc.hist, CFG)
    return [t.lens, t.singletons, t.codes]


def _titles_out(sc):
    enc = sc.enc
    if enc is None:
        return []
    return list(title.decode(enc.plan, enc.fixed_words, enc.char_words,
                             enc.char_sub_n_words, sc.R, CFG))


def st_unpack_substreams(sc):
    """The title decode's walk through unpack_substreams (title_walk
    off)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "title_walk", lambda *a, **k: None)
        return _titles_out(sc)


def st_packers(sc):
    """ops/transfer's packers (byte_scan, pack_fixed, find_non_acgt) on
    plain 2-bit, sparse-IUPAC, ACGTN and IUPAC-heavy planes and 6-bit and
    high quality planes."""
    return ([transfer.pack_seq_np(p) for p in sc.seq_planes]
            + [transfer.pack_qual_np(p) for p in sc.qual_planes])


def st_pack_fixed(sc):
    """Every transform, beside the packers (the numpy version: the value
    map of transfer.pack_seq_np / pack_qual_np, then _pack_fixed_np)."""
    f, q = sc.seq_planes[2], sc.qual_planes[0]
    maps = [(sc.seq_planes[0], 2, native.PACK_ACGT2, lambda v: (v >> 1) & 3),
            (f, 3, native.PACK_ACGTN3,
             lambda v: np.where(v == 78, 4, (v >> 1) & 3).astype(np.uint32)),
            (q, 6, native.PACK_QUAL6, lambda v: np.where(
                v == 0, 0, v.astype(np.int32) - 33).astype(np.uint32)),
            (sc.seq_planes[3], 8, native.PACK_RAW, lambda v: v)]
    out = []
    for src, w, tr, value in maps:
        words = native.pack_fixed(src, w, tr)
        out.append(transfer._pack_fixed_np(value(src), w) if words is None
                   else words)
    return out + st_packers(sc)


def st_find_non_acgt(sc):
    """pack_seq_np's exception list (find_non_acgt, else np.flatnonzero),
    also where the count passes the cap."""
    out = []
    for f in sc.seq_planes:
        acgt = (f == 0) | (f == 65) | (f == 67) | (f == 71) | (f == 84)
        n_bad = int(f.size - np.count_nonzero(acgt))
        exc = native.find_non_acgt(f, n_bad)
        out.append(np.flatnonzero(~acgt) if exc is None else exc)
        if n_bad:
            out.append(native.find_non_acgt(f, n_bad - 1))
    return out + st_packers(sc)


def _out_meta(alpha, w, q6, qual8):
    meta = object.__new__(subblock._OutMeta)
    meta.alpha, meta.w, meta.q6, meta.qual8 = alpha, w, q6, qual8
    return meta


def st_decode_tail(sc):
    """subblock._unpack_out of seeded fetch words of R x L cells: qual8 at
    w = 2, restored symbols at w = 3 with 6-bit quality, and w = 5 with
    8-bit quality (alphabets of 2^w symbols, so that every index names
    one)."""
    rng = np.random.default_rng(sc.R)
    out = []
    for alpha, w, q6, qual8 in ((np.frombuffer(b"ACGT", np.uint8), 2, False,
                                 True),
                                (np.frombuffer(b"ACGTNRYK", np.uint8), 3,
                                 True, False),
                                (np.arange(65, 97, dtype=np.uint8), 5, False,
                                 False)):
        n_sw, n_qw = subblock._out_fetch_words(sc.R * sc.L, w, q6)
        words = rng.integers(0, 1 << 32, size=n_sw + n_qw, dtype=np.uint64
                             ).astype(np.uint32)
        out += list(subblock._unpack_out(words, _out_meta(alpha, w, q6, qual8),
                                         sc.R, sc.L))
    return out


def st_fastq_assemble(sc):
    out = subblock._reassemble(sc.R, sc.lens, sc.titles, sc.tlens, sc.seq,
                               sc.qual)
    assert out == sc.buf.tobytes()
    return [out]


STAGES = {
    "index_records": st_index_records, "gather": st_gather,
    "gather3": st_gather3, "huffman_lengths": st_huffman_lengths,
    "unpack_substreams": st_unpack_substreams,
    "pack_fixed": st_pack_fixed, "decode_tail": st_decode_tail,
    "find_non_acgt": st_find_non_acgt, "byte_scan": st_packers,
    "fastq_assemble": st_fastq_assemble,
    "title_walk": _titles_out, "title_assemble": _titles_out,
}


def _direct_call(name, sc):
    """The entry point's arguments where its caller does not reach it: at
    no items."""
    if sc.R:
        return None
    u8, i32, i64 = (np.zeros(0, t) for t in (np.uint8, np.int32, np.int64))
    one = np.zeros(1, np.int32)
    return {
        "gather": (u8, i64, i32, 1),
        "gather3": (u8, i64, i32, 1, i64, i64, i32, 1),
        "unpack_substreams": (np.zeros(2, np.uint32), i64,
                              np.zeros((1, 4096), np.int32),
                              np.zeros((0, 3), np.int32),
                              np.zeros((0, 3), np.uint8), 3, 12),
        "fastq_assemble": (np.zeros((0, 1), np.uint8), i32,
                           np.zeros((0, 1), np.uint8),
                           np.zeros((0, 1), np.uint8), i32, i64, 0),
        "title_walk": (np.zeros(0, np.uint32), i64, 64,
                       np.zeros((1, 4096), np.int32), 12, one, one + 1, one,
                       np.zeros((0, 1), np.int32), 0, one + 1),
        "title_assemble": (one, np.zeros((0, 1), np.int32), i64,
                           np.zeros(1, np.int64), i32, np.zeros(1, np.int64),
                           one + 1, u8, 1),
    }.get(name)


def _same(a, b, exact=True) -> bool:
    """Equal values and shapes, and (exact) the same dtypes."""
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y, exact) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k], exact) for k in a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and (not exact or a.dtype == b.dtype)
                and np.array_equal(a, b))
    return a == b


@pytest.fixture
def threads():
    """native.set_threads, put back to the CPUs the process may use."""
    yield native.set_threads
    native.set_threads(0)


def _recorded(name, fn, *args):
    """fn(*args) and the calls it made to the port's wrapper `name`:
    [(args, kwargs, result)]."""
    calls = []
    wrapper = getattr(native, name)

    def spy(*a, **k):
        res = wrapper(*a, **k)
        calls.append((a, k, res))
        return res

    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, name, spy)
        return fn(*args), calls


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(STAGES))
def test_runtime_is_the_jax_runtime_and_the_numpy_versions(threads, name,
                                                           size):
    assert jnative.available(), "the JAX package's runtime did not build"
    sc = _scenario(size)
    stage = STAGES[name]
    with _no_native():
        want = stage(sc)
    calls = []
    for t in THREADS:
        assert threads(t) == t
        got, made = _recorded(name, stage, sc)
        assert _same(got, want, exact=False), f"{name} at {t} threads"
        calls += made
    direct = _direct_call(name, sc)
    if direct is not None:
        calls.append((direct, {}, getattr(native, name)(*direct)))
    assert calls, f"the stage never reached {name}"
    assert all(res is not None for _, _, res in calls
               if name != "find_non_acgt"), f"{name} answered None"
    for args, kwargs, res in calls:
        want = getattr(jnative, name)(*args, **kwargs)
        assert _same(res, want), name


def _concurrent_work(sc, i):
    """pack_fixed, gather3 and decode_tail on inputs of their own (seed
    100 + i)."""
    rng = np.random.default_rng(100 + i)
    idx = sc.idx
    plane = np.roll(sc.seq_planes[1], 4099 * i)
    words = rng.integers(0, 1 << 32, size=12500,
                         dtype=np.uint64).astype(np.uint32)
    return [native.pack_fixed(plane, 2, native.PACK_ACGT2),
            *native.gather3(sc.buf, idx.title_start[i:], sc.tlens[i:],
                            sc.TL, idx.seq_start[i:], idx.qual_start[i:],
                            sc.lens[i:], sc.L),
            *native.decode_tail(words[:2500], words[2500:], 40000 - 1000 * i,
                                2, 8, False, True,
                                np.arange(65, 97, dtype=np.uint8),
                                np.arange(17, dtype=np.uint8))]


def test_concurrent_callers_get_the_serial_bytes(threads):
    """Eight Python threads call pack_fixed, gather3 and decode_tail at once
    (ctypes drops the GIL), six times each, on the pool of 8 threads."""
    threads(8)
    sc = _scenario(65537)
    serial = [_concurrent_work(sc, i) for i in range(8)]
    results = [None] * 8
    barrier = threading.Barrier(8)

    def run(i):
        barrier.wait(timeout=30)
        results[i] = [_concurrent_work(sc, i) for _ in range(6)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=45)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    for i in range(8):
        assert results[i] is not None, f"thread {i} did not finish"
        for out in results[i]:
            assert _same(out, serial[i]), f"thread {i}"


def test_a_forked_child_makes_its_own_pool(tmp_path):
    """A child forked after the pool exists (its workers are not copied)
    splits its calls over a pool of its own and gets the parent's bytes;
    its calls do not wait forever on the parent's workers."""
    code = """
import os, sys, time
import numpy as np
from phyngsc_tpu_torch.utils import native
native.set_threads(4)
src = np.random.default_rng(1).integers(0, 256, 1 << 20).astype(np.uint8)
want = native.pack_fixed(src, 8, native.PACK_RAW)  # the pool exists now
pid = os.fork()
if pid == 0:
    ok = all(np.array_equal(native.pack_fixed(src, 8, native.PACK_RAW), want)
             for _ in range(20))
    os._exit(0 if ok else 3)
for _ in range(400):
    done, status = os.waitpid(pid, os.WNOHANG)
    if done:
        sys.exit(os.waitstatus_to_exitcode(status))
    time.sleep(0.05)
os.kill(pid, 9)
sys.exit(4)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=50)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])


def test_library_is_the_ports_own_build():
    native.byte_scan(np.zeros(3, np.uint8))  # loads it
    path = native._lib._name
    assert path == host_runtime.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "host")
    assert re.fullmatch(r"libphyngsc_host_[0-9a-f]{12}\.so",
                        os.path.basename(path))
    assert native.threads() == len(os.sched_getaffinity(0))


def _fresh_tree(tmp_path):
    """tmp_path holding a copy of the port and of the repo's native/ and
    phyngsc_tpu/ (no builds, no caches): its build/host/ is empty."""
    skip = shutil.ignore_patterns("__pycache__", "*.so", "*.o")
    for d in ("phyngsc_tpu_torch", "native", "phyngsc_tpu"):
        shutil.copytree(os.path.join(ROOT, d), tmp_path / d, ignore=skip)
    (tmp_path / "home").mkdir()
    return dict(os.environ, PYTHONPATH=str(tmp_path),
                HOME=str(tmp_path / "home"),
                XDG_CACHE_HOME=str(tmp_path / "home" / ".cache"),
                PYTHONDONTWRITEBYTECODE="1")


def _files(root):
    """{path: (size, mtime)} of every file under root."""
    return {os.path.join(d, f): (os.stat(os.path.join(d, f)).st_size,
                                 os.stat(os.path.join(d, f)).st_mtime_ns)
            for d, _, fs in os.walk(root) for f in fs}


_CHILD = """
import sys
sys.modules["jax"] = sys.modules["phyngsc_tpu"] = None
"""


def test_a_run_writes_nothing_beside_the_jax_package(tmp_path):
    """compress_bytes(..., device="cpu") in a child process writes nothing
    under native/, phyngsc_tpu/ or the home directory's cache."""
    env = _fresh_tree(tmp_path)
    watched = [tmp_path / "native", tmp_path / "phyngsc_tpu",
               tmp_path / "home"]
    before = [_files(w) for w in watched]
    code = _CHILD + """
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch.utils import native
data = synthesize_fastq(400, read_len=36, seed=3)
assert decompress_bytes(compress_bytes(data, device="cpu"),
                        device="cpu") == data
print(native._lib._name)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.path.dirname(res.stdout.strip()) == str(tmp_path / "build" /
                                                      "host")
    assert [_files(w) for w in watched] == before


def test_distributed_compress_builds_the_runtime_first(tmp_path):
    """compress_file_distributed, the first use of the runtime in a fresh
    process of a fresh tree, builds and loads the port's library (no numpy
    versions) and writes the single-process container."""
    env = _fresh_tree(tmp_path)
    data = fastq.synthesize_fastq(600, read_len=36, seed=4)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    code = _CHILD + """
import os, socket
import torch.distributed as dist
from phyngsc_tpu_torch.parallel.distributed import compress_file_distributed
from phyngsc_tpu_torch.utils import native
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=1, rank=0)
assert native._lib is None
compress_file_distributed(sys.argv[1], sys.argv[2], device="cpu")
dist.destroy_process_group()
print(native._lib._name if native._lib is not None else "numpy")
"""
    out = tmp_path / "out.ngsct"
    res = subprocess.run([sys.executable, "-c", code, str(src), str(out)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=50)
    assert res.returncode == 0, res.stderr[-3000:]
    lib = res.stdout.strip().splitlines()[-1]
    assert os.path.dirname(lib) == str(tmp_path / "build" / "host"), lib
    assert os.path.exists(lib)
    assert f"host runtime {lib}" in res.stderr
    assert out.read_bytes() == compress.compress_bytes(data, None, 1,
                                                       device="cpu")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: ensure() raises with the cause, and so does the first
    call into the runtime; nothing falls back to numpy."""
    monkeypatch.setattr(host_runtime, "COMMAND",
                        [str(tmp_path / "no-such-g++"),
                         *host_runtime.COMMAND[1:]])
    monkeypatch.setattr(host_runtime, "BUILD_DIR", str(tmp_path / "host"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        host_runtime.ensure()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.byte_scan(np.zeros(4, np.uint8))
    with pytest.raises(RuntimeError, match="cannot be built"):
        transfer.pack_qual_np(np.zeros(4, np.uint8))
    assert native._lib is None


def test_a_failed_compile_raises_with_the_compilers_output(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(host_runtime, "COMMAND",
                        [*host_runtime.COMMAND, "-fno-such-option"])
    monkeypatch.setattr(host_runtime, "BUILD_DIR", str(tmp_path / "host"))
    with pytest.raises(RuntimeError, match="no-such-option"):
        host_runtime.ensure()
    assert os.listdir(tmp_path / "host") == []


def test_the_port_has_no_openmp():
    pattern = re.compile(r"#\s*pragma\s+omp|\bomp_|-fopenmp|<omp\.h>")
    found = []
    for d, _, fs in os.walk(os.path.join(ROOT, "phyngsc_tpu_torch")):
        for f in fs:
            if f.endswith((".py", ".cpp", ".h", ".cu")):
                with open(os.path.join(d, f), encoding="utf-8") as fh:
                    if pattern.search(fh.read()):
                        found.append(f)
    assert found == []
    assert "-fopenmp" not in host_runtime.COMMAND
    assert "-pthread" in host_runtime.COMMAND

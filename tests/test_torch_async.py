"""The port's asynchronous host<->device execution (phyngsc_tpu_torch/
device.py) on the CPU: upload / Staging / fetch_async / Pending return
arrays bit for bit at any dtype, each piece at a 16-byte offset; a CUDA
device never falls back to pageable memory; the stages leave their fetches
pending; the drivers hand each task its streams from their ring in task
order (None on the CPU) and the stages that issue device work enter them;
the port's
encode_subblock / decode_subblock write and read the JAX package's bytes;
and the card's widened-race corpora keep the JAX package's containers."""

import contextlib
import hashlib
import sys
import threading

import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.utils.fastq import index_records as jax_index_records
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import (Pending, Staging, StreamRing,
                                      fetch_async, task_streams, upload,
                                      use_streams)
from phyngsc_tpu_torch.pipeline import compress, decompress, subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils.fastq import index_records, synthesize_fastq
from test_torch_pipeline import _solid_input
from torch_race_corpora import CORPORA as RACE, SHA256 as RACE_SHA256
from torch_time_limit import time_limit

_limit = time_limit(60)
CPU = torch.device("cpu")
KW = dict(subblock_input_bytes=32 << 10, records_per_substream=16)
DTYPES = [np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
          np.int64, np.float32, np.float64, np.bool_]


def _arrays(rng, shapes, dtypes):
    out = []
    for shape, dt in zip(shapes, dtypes):
        raw = rng.integers(0, 256, size=int(np.prod(shape)) * np.dtype(
            dt).itemsize, dtype=np.uint8)
        a = raw.view(dt).reshape(shape)
        out.append(a != 0 if dt is np.bool_ else a)
    return out


@pytest.mark.parametrize("dt", DTYPES)
def test_upload_and_fetch_are_bit_exact(dt):
    """Every dtype, shapes from empty to 2-D, several pieces in one upload
    after a piece of odd length: each comes back bit for bit, as a tensor
    of its dtype starting on a 16-byte boundary."""
    rng = np.random.default_rng(np.dtype(dt).num)
    shapes = [(0,), (1,), (7,), (3, 5), (33,), (2, 17)]
    arrays = [rng.integers(0, 256, size=3, dtype=np.uint8)] + _arrays(
        rng, shapes, [dt] * len(shapes))
    got = upload(arrays, CPU)
    for a, t in zip(arrays, got):
        assert t.device == CPU and tuple(t.shape) == a.shape
        assert t.dtype == torch.from_numpy(a[:0]).dtype
        assert t.data_ptr() % 16 == 0
        back = fetch_async(t).result()
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back.view(np.uint8),
                                      np.ascontiguousarray(a).view(np.uint8))


def test_staging_layout():
    """Pieces at multiples of `align` bytes, zero padding between them,
    nbytes the padded total; a view written after send() leaves the sent
    copy alone."""
    a = np.arange(5, dtype=np.uint8)
    b = np.arange(3, dtype=np.int64) - 7
    st = Staging.of([a, b], CPU)
    assert st.nbytes == 16 + 32
    base = st.views[0].__array_interface__["data"][0]
    assert st.views[1].__array_interface__["data"][0] - base == 16
    ta, tb = st.send()
    st.views[1][:] = 0
    assert tb.tolist() == [-7, -6, -5] and ta.tolist() == [0, 1, 2, 3, 4]
    words = Staging([((3,), np.int32)], CPU, align=4)
    assert words.nbytes == 12
    one = Staging.of([np.ones(5, np.uint8)], CPU)
    assert one.nbytes == 16
    host = one._host.numpy()
    assert host[:5].tolist() == [1] * 5 and not host[5:].any()


def test_pending_on_the_cpu_holds_its_array():
    t = torch.arange(10, dtype=torch.int32)
    p = fetch_async(t)
    assert isinstance(p, Pending) and p._event is None
    np.testing.assert_array_equal(p.result(), np.arange(10))
    np.testing.assert_array_equal(p.result(), np.arange(10))


def test_no_fall_back_from_the_card():
    """Without a card, each primitive asked for CUDA raises: nothing
    drops to pageable memory or to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the primitives pin and stream")
    with pytest.raises(RuntimeError):
        upload([np.zeros(4, np.uint8)], torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        task_streams([torch.device("cuda")])
    with pytest.raises((RuntimeError, AssertionError)):
        compress_bytes(b"@a\nACGT\n+\nIIII\n", None, 1, device="cuda")


def test_stream_ring_on_the_cpu():
    ring = StreamRing([CPU, CPU], 3)
    assert [ring.take() for _ in range(7)] == [None] * 7
    assert task_streams([CPU, "cpu"]) is None
    with use_streams(None):
        assert torch.ones(2).sum().item() == 2


@pytest.fixture(scope="module")
def err():
    return synthesize_fastq(1500, read_len=36, seed=101, ambiguity_rate=0.01)


def test_stages_hold_pending_fetches(err):
    """stage_a leaves the counts' fetch pending, stage_b one blob fetch a
    shard, decode_stage_a one a shard; the stages' bytes are the
    driver's."""
    cfg = CodecConfig(**KW)
    buf = np.frombuffer(err, np.uint8)
    idx = index_records(buf)
    a = subblock.stage_a(buf, idx, cfg, CPU)
    assert isinstance(a.counts_blob, Pending) and a.streams is None
    b = subblock.stage_b(a, cfg)
    assert len(b.blobs) == 1 and isinstance(b.blobs[0], Pending)
    payload = subblock.stage_c(b, cfg)
    assert payload == subblock.encode_subblock(buf, idx, cfg, CPU)
    d = subblock.decode_stage_a(payload, cfg, CPU)
    assert len(d.blobs) == 1 and isinstance(d.blobs[0], Pending)
    assert subblock.decode_stage_b(d) == err
    two = CodecConfig(data_shards=2, **KW)
    codec = compress.codec_for("cpu", two)[1]
    a2 = subblock.stage_a(buf, idx, two, CPU, codec=codec)
    assert isinstance(a2.counts_blob, Pending)
    b2 = subblock.stage_b(a2, two, codec)
    assert [isinstance(x, Pending) for x in b2.blobs] == [True, True]
    d2 = subblock.decode_stage_a(subblock.stage_c(b2, two), two, CPU,
                                 codec=codec)
    assert [isinstance(x, Pending) for x in d2.blobs] == [True, True]
    assert subblock.decode_stage_b(d2) == err


class _NumberedRing:
    """A StreamRing whose tasks' streams are 0, 1, 2, ... in hand-out
    order."""

    made = []

    def __init__(self, devices, n):
        self.made.append((list(devices), n))
        self._next = 0

    def take(self):
        self._next += 1
        return self._next - 1


@pytest.mark.parametrize("shards", [1, 2])
def test_drivers_hand_out_streams_in_task_order(monkeypatch, shards):
    """Each sub-block's stage A (and decode stage A) gets the ring's next
    task streams on the calling thread in task order, whichever pool thread
    runs it; stage A and B of the task (decode stage A) enter those
    streams and no other;
    the ring holds pipeline_depth + 1 tasks over the shards' devices."""
    data = synthesize_fastq(3000, read_len=36, seed=102, ambiguity_rate=0.01)
    cfg = CodecConfig(data_shards=shards, **KW)
    want = compress_bytes(data, cfg, 2, device="cpu")
    entered, seen_a, seen_d = [], [], []
    lock = threading.Lock()

    def use(streams):
        with lock:
            entered.append(streams)
        return contextlib.nullcontext()

    stage_a, decode_stage_a = subblock.stage_a, subblock.decode_stage_a

    def spy_a(buf, idx, *args):
        seen_a.append((int(idx.title_start[0]), args[-1]))
        return stage_a(buf, idx, *args)

    def spy_d(payload, *args, **kw):
        seen_d.append(args[-1])
        return decode_stage_a(payload, *args, **kw)

    _NumberedRing.made.clear()
    monkeypatch.setattr(compress, "StreamRing", _NumberedRing)
    monkeypatch.setattr(decompress, "StreamRing", _NumberedRing)
    monkeypatch.setattr(subblock, "use_streams", use)
    monkeypatch.setattr(subblock, "stage_a", spy_a)
    monkeypatch.setattr(subblock, "decode_stage_a", spy_d)
    blob = compress_bytes(data, cfg, 2, device="cpu")
    n = len(seen_a)
    assert blob == want and n >= 8
    assert [t for _, t in sorted(seen_a)] == list(range(n))
    # stage A and B of each task, on its streams
    assert sorted(entered) == sorted(list(range(n)) * 2)
    entered.clear()
    assert decompress_bytes(blob, cfg, device="cpu") == data
    assert seen_d == list(range(n))
    assert sorted(entered) == list(range(n))
    assert _NumberedRing.made == [([CPU] * shards,
                                   cfg.pipeline_depth + 1)] * 2


SUBBLOCK_CORPORA = {
    "ERR005195": lambda: synthesize_fastq(600, read_len=36, seed=103,
                                          ambiguity_rate=0.01),
    "variable-length": lambda: synthesize_fastq(300, read_len=100, seed=104,
                                                variable_length=True),
    "SOLiD": lambda: _solid_input(400, seed=105),
}


@pytest.mark.parametrize("corpus", list(SUBBLOCK_CORPORA))
def test_encode_decode_subblock_match_jax(corpus):
    """The port's single-shot encode_subblock / decode_subblock (one task
    on its own streams) write the JAX package's bytes and read them back."""
    data = SUBBLOCK_CORPORA[corpus]()
    buf = np.frombuffer(data, np.uint8)
    kw = dict(records_per_substream=16)
    got = subblock.encode_subblock(buf, index_records(buf), CodecConfig(**kw),
                                   device="cpu")
    want = jsubblock.encode_subblock(buf, jax_index_records(buf),
                                     JaxConfig(**kw))
    assert got == want
    assert subblock.decode_subblock(want, CodecConfig(**kw), "cpu") == data
    assert jsubblock.decode_subblock(got, JaxConfig(**kw)) == data


@pytest.mark.parametrize("name", list(RACE))
def test_race_corpora_keep_the_jax_containers(name):
    """The SHA-256 the card's widened-race test holds its containers to
    are the JAX package's (and the port's on the CPU)."""
    make, kw = RACE[name]
    data = make()
    want = jax_compress(data, JaxConfig(**kw), 1)
    assert hashlib.sha256(want).hexdigest() == RACE_SHA256[name]
    assert compress_bytes(data, CodecConfig(**kw), 1, device="cpu") == want


def test_upload_and_fetch_from_many_threads():
    """Sixteen threads, more than the cores, upload and fetch random arrays
    at once with a short switch interval: every array comes back equal."""
    errors, done = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                dts = [DTYPES[i] for i in rng.integers(0, len(DTYPES), 3)]
                shapes = [(int(rng.integers(0, 300)),) for _ in dts]
                arrays = _arrays(rng, shapes, dts)
                for a, t in zip(arrays, upload(arrays, CPU)):
                    back = fetch_async(t).result()
                    if not np.array_equal(back.view(np.uint8),
                                          a.view(np.uint8)):
                        errors.append(seed)
            done.append(seed)
        except Exception as e:  # reported below, with the seed
            errors.append((seed, repr(e)))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=50)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and sorted(done) == list(range(16))

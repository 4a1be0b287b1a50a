"""PHYNGSC_TIMING in the port's drivers against phyngsc_tpu's: the output
bytes do not change with timing on, the stage labels are the JAX package's
for every stage (compress: stage_a/b/c and their sub-steps; decode:
parse, dispatch, fetch, reassembly), the host<->device byte counters are
positive, each driver logs one line, concurrent updates of the sink lose
nothing, and utils.logging.trace writes a torch.profiler trace."""

import json
import sys
import threading

import pytest

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.pipeline.decompress import decompress_bytes as jax_decompress
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils import logging as tlog
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from torch_time_limit import time_limit

_limit = time_limit(60)
KW = dict(subblock_input_bytes=32 << 10, records_per_substream=16)


@pytest.fixture(scope="module")
def data():
    return synthesize_fastq(800, read_len=36, seed=93, ambiguity_rate=0.01)


@pytest.mark.parametrize("shards", [1, 2])
def test_timing_keeps_the_bytes_and_the_jax_labels(monkeypatch, caplog,
                                                   data, shards):
    cfg = CodecConfig(data_shards=shards, **KW)
    monkeypatch.delenv("PHYNGSC_TIMING", raising=False)
    plain = compress_bytes(data, cfg, 2, device="cpu")
    assert subblock.TIMING is None
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with caplog.at_level("INFO", logger="phyngsc_tpu_torch"):
        timed = compress_bytes(data, cfg, 2, device="cpu")
        enc = dict(subblock.TIMING)
        back = decompress_bytes(timed, cfg, device="cpu")
        dec = dict(subblock.TIMING)
    assert timed == plain
    assert back == data
    jax_cfg = JaxConfig(data_shards=shards, **KW)
    assert jax_compress(data, jax_cfg, 2) == timed
    jax_enc = set(jsubblock.TIMING)
    assert jax_decompress(timed, jax_cfg) == data
    jax_dec = set(jsubblock.TIMING)
    assert set(enc) == jax_enc == {
        "stage_a", "stage_b", "stage_c", "b.counts_fetch", "b.tables",
        "b.encode_dispatch", "b.title", "c.fetch", "h2d_bytes", "d2h_bytes"}
    assert set(dec) == jax_dec == {
        "d.parse", "d.device_dispatch", "d.fetch", "d.reassemble",
        "h2d_bytes", "d2h_bytes"}
    for sink in (enc, dec):
        assert sink["h2d_bytes"] > 0 and sink["d2h_bytes"] > 0
        assert all(v >= 0 for v in sink.values())
    lines = [r.getMessage() for r in caplog.records
             if r.name == "phyngsc_tpu_torch"]
    assert sum(m.startswith("[I] pipeline timing: ") for m in lines) == 1
    assert sum(m.startswith("[I] decode timing: ") for m in lines) == 1
    line = next(m for m in lines if "pipeline timing" in m)
    assert "stage_a=" in line and "tasks=" in line and "total=" in line
    assert f"h2d_bytes={int(enc['h2d_bytes'])}" in line


def test_sink_updates_are_not_lost(monkeypatch):
    """_tick / _acct from many threads at a short switch interval: every
    update lands (the JAX package's unguarded read-modify-write can lose
    some)."""
    monkeypatch.setattr(subblock, "TIMING", {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                subblock._acct("h2d_bytes", 1)
                subblock._tick("b.tables", 0.0)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert subblock.TIMING["h2d_bytes"] == 16 * 2000


def test_timing_off_reads_no_clock(monkeypatch):
    monkeypatch.setattr(subblock, "TIMING", None)
    assert subblock._tick("c.fetch", 12.5) == 12.5
    subblock._acct("d2h_bytes", 10)
    assert subblock.TIMING is None


def test_trace_writes_a_profile(tmp_path):
    import torch

    with tlog.trace(str(tmp_path / "t"), torch.device("cpu")):
        torch.arange(1000).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with tlog.trace(None):  # no directory: nothing is profiled
        pass


def test_log_prefixes_and_timed(caplog, monkeypatch):
    """The reference's [D]/[I]/[!]/[E] prefixes on the port's logger, and
    the span recorder adding a scope's seconds to a sink (`done`) and
    recording it in its call."""
    with caplog.at_level("DEBUG", logger="phyngsc_tpu_torch"):
        tlog.debug("a %d", 1)
        tlog.info("b %s", "x")
        tlog.warn("c")
        tlog.error("d")
    assert [r.getMessage() for r in caplog.records
            if r.name == "phyngsc_tpu_torch"] == ["[D] a 1", "[I] b x",
                                                  "[!] c", "[E] d"]
    sink = {}

    def done(label, seconds):
        sink[label] = sink.get(label, 0.0) + seconds

    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with tlog.call("compress"):
        for _ in range(2):
            with tlog.span("scope", done=done):
                pass
    assert set(sink) == {"scope"} and sink["scope"] >= 0
    spans = tlog.recorded_calls()[-1].spans
    assert [s.name for s in spans] == ["scope", "scope", "compress"]
    assert sum(s.t1 - s.t0 for s in spans[:2]) * 1e-9 == \
        pytest.approx(sink["scope"])

"""The metric arithmetic on a small synthetic trace with known intervals
and known bytes. Run: python -m pytest portbench/"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import Call, Run, _breakdown, _busy  # noqa: E402
from portbench.metrics import (_peaks, _trace, device, host, host_clock,  # noqa: E402
                               kernels_roofline, wire)


def _event(cat, name, ts_us, dur_us, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": device, "tid": 7, "args": {"device": device}}


@pytest.fixture
def run(tmp_path):
    """Two calls on the trace clock (offset 100 s from perf_counter):
    compress [100, 102) s, decompress [103, 104) s. Device work: in the
    compress, kernels [100.2, 100.5) and [100.4, 100.7) (overlapping, union
    0.5 s) and a copy [101.0, 101.1); in the decompress a kernel [103.0,
    103.25) and a memset outside every call."""
    events = [
        _event("kernel", "k_a", 100.2e6, 0.3e6),
        _event("kernel", "k_b", 100.4e6, 0.3e6),
        _event("gpu_memcpy", "Memcpy HtoD", 101.0e6, 0.1e6),
        _event("kernel", "k_a", 103.0e6, 0.25e6),
        _event("gpu_memset", "Memset", 110.0e6, 1e6),
        _event("cuda_runtime", "cudaLaunchKernel", 100.1e6, 10),
        _event("user_annotation", "portbench.round_trip", 100.0e6, 4e6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = Run({"name": "x", "chips": 1}, {}, {}, 1, "cuda")
    r.trace, r.trace_offset = _trace.load(str(path)), 100.0
    r.calls = [Call("compress", 0, 0.0, 2.0, 1_000_000_000, 1_000_000_000,
                    b"c" * 250_000_000, None),
               Call("decompress", 0, 3.0, 4.0, 1_000_000_000, 250_000_000,
                    b"", None)]
    r.calling_thread = 1
    r.spans = [("stage_b", 1, 0.1, 0.9), ("b.tables", 1, 0.1, 0.6),
               ("stage_a", 2, 0.0, 0.5), ("stage_a", 3, 0.2, 1.2),
               ("d.parse", 1, 3.3, 3.8), ("d.reassemble", 2, 3.5, 3.9),
               ("stage_c", 2, 5.0, 5.5)]  # after every call: not counted
    r.counts = [("h2d_bytes", 300e6, 0.5), ("d2h_bytes", 100e6, 1.5),
                ("h2d_bytes", 50e6, 3.5), ("h2d_bytes", 7e6, 9.0)]
    r.setup_s, r.cold_roundtrip_s = 12.5, 3.25
    r.graph_cold = {"capture_s": 0.4}
    return r


def test_union_of_overlapping_and_nested_intervals():
    assert _trace.union([(0, 2), (1, 3), (5, 6), (5.2, 5.5)]) == 4
    assert _trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert _trace.clipped([(0, 2), (3, 4)], 1, 3.5) == [(1, 2), (3, 3.5)]


def test_trace_load_keeps_device_work_and_ranges(run):
    assert sorted(c for c, *_ in run.trace["device"]) == [
        "gpu_memcpy", "gpu_memset", "kernel", "kernel", "kernel"]
    assert run.trace["ranges"]["portbench.round_trip"] == [(100.0, 104.0)]


def test_idle_share_is_the_union_of_work_over_the_calls(run):
    # compress: busy 0.5 (kernels) + 0.1 (copy) of 2 s; decompress 0.25 of 1
    assert device.read("device.idle_share.compress", run) == \
        pytest.approx(70.0)
    assert device.read("device.idle_share.decompress", run) == \
        pytest.approx(75.0)


def test_roofline_is_bytes_at_hbm_over_kernel_time(run):
    # compress: 1 GB in + 0.25 GB out at 3.35 TB/s over 0.5 s of kernels
    want = 100 * 1.25e9 / 3.35e12 / 0.5
    assert kernels_roofline.read("kernels_roofline.compress", run) == \
        pytest.approx(want)
    want = 100 * 1.25e9 / 3.35e12 / 0.25
    assert kernels_roofline.read("kernels_roofline.decompress", run) == \
        pytest.approx(want)
    assert _peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert _peaks.bound_s(0, 67e12) == pytest.approx(1.0)


def test_host_seconds_by_thread_per_gb(run):
    # calling thread: stage_b [0.1, 0.9] holds b.tables: 0.8 s per 1 GB
    assert host.read("host.calling_s_per_GB.compress", run) == \
        pytest.approx(0.8)
    # pool: thread 2 0.5 s, thread 3 1.0 s
    assert host.read("host.pool_s_per_GB.compress", run) == \
        pytest.approx(1.5)
    assert host.read("host.calling_s_per_GB.decompress", run) == \
        pytest.approx(0.5)
    assert host.read("host.pool_s_per_GB.decompress", run) == \
        pytest.approx(0.4)


def test_wire_bytes_per_fastq_byte(run):
    assert wire.read("wire.bytes_per_byte.compress", run) == \
        pytest.approx(0.4)
    assert wire.read("wire.bytes_per_byte.decompress", run) == \
        pytest.approx(0.05)


def test_host_clock_metrics(run):
    assert host_clock.read("compress_MBps", run) == pytest.approx(500.0)
    assert host_clock.read("decompress_MBps", run) == pytest.approx(1000.0)
    assert host_clock.read("setup_s", run) == 12.5
    # a 250 MB container of 1 GB of FASTQ
    assert host_clock.read("stored_bytes_per_byte", run) == \
        pytest.approx(0.25)


def test_per_card_groups_by_device_and_category(run):
    run.trace["device"].append(("kernel", "k_c", 1, 100.0, 100.1))
    cards = _trace.per_card(run.trace, ("kernel",))
    assert sorted(cards) == [0, 1]
    assert [a for a, _ in cards[0]] == pytest.approx([100.2, 100.4, 103.0])
    assert cards[1] == [(100.0, 100.1)]
    assert _trace.per_card(None, _trace.DEVICE_WORK) == {}


def test_readers_find_nothing_without_a_trace(run):
    run.trace, run.spans, run.counts = None, None, None
    for mod, name in [(device, "device.idle_share.compress"),
                      (kernels_roofline, "kernels_roofline.compress"),
                      (host, "host.pool_s_per_GB.compress"),
                      (wire, "wire.bytes_per_byte.compress")]:
        assert mod.read(name, run) is None


def test_busy_and_breakdown(run):
    busy = _busy(run, (0.0, 4.0))
    assert busy["window_s"] == pytest.approx(4.0)
    assert busy["busy_s"] == pytest.approx(0.85)
    bd = _breakdown(run)
    ops = dict((k, v) for k, v in bd["device_ops"])
    assert ops["k_a"] == pytest.approx(0.55)
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    # compress idle: [100, 100.2) (b.tables around 100.1), [100.7, 101.0)
    # (stage_b around 100.85), [101.1, 102) (nothing around 101.55)
    assert gaps["compress/b.tables"] == pytest.approx(0.2)
    assert gaps["compress/stage_b"] == pytest.approx(0.3)
    assert gaps["compress/-"] == pytest.approx(0.9)
    assert gaps["decompress/d.parse"] == pytest.approx(0.75)

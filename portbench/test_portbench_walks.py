"""The execution and walk metrics (metrics/capture.py, metrics/walks.py)
on synthetic recorded calls with known g.capture / g.evict spans and walk
counts, and a synthetic Chrome trace with known walk-kernel intervals:
each reads its hand-computed value; None where the program records or
counts nothing; a chain share above 100 % is refused. Run: python -m
pytest portbench/"""

import json
import os
import sys
import types
from typing import NamedTuple

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import Call, Run  # noqa: E402
from portbench.metrics import _trace, calling, capture, walks  # noqa: E402


class Span(NamedTuple):  # the fields the readers use of the program's
    name: str
    id: int
    parent: int
    thread: int
    t0: int
    t1: int
    counts: dict | None = None


class OldSpan(NamedTuple):  # a recorder that has no counts
    name: str
    id: int
    parent: int
    thread: int
    t0: int
    t1: int


def _span(name, id_, parent, thread, a, b, counts=None, cls=Span):
    extra = () if cls is OldSpan else (counts,)
    return cls(name, id_, parent, thread, round(a * 1e9), round(b * 1e9),
               *extra)


def _call(kind, spans):
    return types.SimpleNamespace(kind=kind, spans=spans)


#: steps of the two decoded sub-blocks' walks: floors 1000, 3000 (quality)
#: and 500, 1500 (DNA) steps at 30 / 1.98e9 s
STEPS = 1000 + 3000 + 500 + 1500


def _recorded(cls=Span, counts=True):
    def c(q, d):
        return {"walk.q.lanes": 70, "walk.q.longest": q,
                "walk.d.lanes": 70, "walk.d.longest": d} if counts else None
    return [
        # before the window: matches no call
        _call("decompress", [_span("decompress", 90, 0, 1, 5.0, 6.0,
                                   cls=cls),
                             _span("g.capture", 91, 90, 1, 5.1, 5.9,
                                   cls=cls)]),
        _call("compress", [
            _span("compress", 1, 0, 1, 10.1, 11.9, cls=cls),
            _span("g.capture", 2, 1, 2, 10.2, 10.5, cls=cls),  # pool
            _span("g.capture", 3, 1, 1, 10.6, 10.7, cls=cls),
            _span("g.evict", 4, 1, 1, 10.65, 10.8, cls=cls),  # 0.05 over
            _span("stage_b", 5, 1, 1, 10.8, 11.0, cls=cls),
        ]),
        _call("decompress", [
            _span("decompress", 20, 0, 1, 13.1, 13.9, cls=cls),
            _span("d.launch", 21, 20, 1, 13.2, 13.3, c(1000, 500), cls=cls),
            _span("g.evict", 22, 21, 1, 13.22, 13.24, cls=cls),
            _span("d.launch", 23, 20, 1, 13.5, 13.6, c(3000, 1500),
                  cls=cls),
        ]),
    ]


def _event(cat, name, ts_us, dur_us, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": device, "tid": 7, "args": {"device": device}}


#: the trace's clock is perf_counter + 100 s: the compress is [110, 112),
#: the decompress [113, 114). Walk kernels in the decompress: a K3 of
#: 100 us and, overlapping it, a K2 of 50 us (union 120 us), and a K3 of
#: 80 us; another kernel, a walk in the compress and one after every call
EVENTS = [
    _event("kernel", "void phyngsc::walk_masked_kernel<(Variant)2, true>",
           113.30e6, 100),
    _event("kernel", "void phyngsc::walk_uniform_kernel<true>",
           113.30e6 + 70, 50),
    _event("kernel", "void phyngsc::walk_masked_kernel<(Variant)0, true>",
           113.60e6, 80),
    _event("kernel", "void phyngsc::densify_kernel", 113.40e6, 1000),
    _event("kernel", "void phyngsc::walk_masked_kernel<(Variant)0, true>",
           110.50e6, 400),
    _event("kernel", "void phyngsc::walk_masked_kernel<(Variant)0, true>",
           120.00e6, 400),
]


def _run(tmp_path, events=EVENTS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = Run({"name": "x", "chips": 1}, {}, {}, 1, "cuda")
    r.trace, r.trace_offset = _trace.load(str(path)), 100.0
    r.calls = [Call("compress", 0, 10.0, 12.0, 1_000_000_000, 1_000_000_000,
                    b"c" * 10, None),
               Call("decompress", 0, 13.0, 14.0, 500_000_000, 10, b"",
                    None)]
    return r


@pytest.fixture
def run(monkeypatch, tmp_path):
    monkeypatch.setattr(calling, "recorded_calls", _recorded)
    return _run(tmp_path)


def test_capture_reads_the_union_of_its_spans_per_gb(run):
    # compress: 0.3 s on the pool thread, [10.6, 10.8) on the calling one
    assert capture.read("capture.s_per_GB.compress", run) == \
        pytest.approx(0.5)
    # decompress: 0.02 s in 0.5 GB
    assert capture.read("capture.s_per_GB.decompress", run) == \
        pytest.approx(0.04)


def test_capture_reads_zero_where_nothing_is_captured(monkeypatch, run):
    monkeypatch.setattr(calling, "recorded_calls", lambda: [
        _call("compress", [_span("compress", 1, 0, 1, 10.1, 11.9)])])
    assert capture.read("capture.s_per_GB.compress", run) == 0.0
    assert capture.read("capture.s_per_GB.decompress", run) is None


@pytest.mark.parametrize("name", ["capture.s_per_GB.compress",
                                  "walks.chain_share.decompress"])
def test_none_without_a_recorder(monkeypatch, run, name):
    monkeypatch.setattr(calling, "recorded_calls", lambda: [])
    assert (capture if name.startswith("capture") else walks).read(
        name, run) is None
    assert capture.read("capture.s_per_GB.verify", run) is None


def test_walk_device_seconds_per_gb(monkeypatch, tmp_path):
    monkeypatch.setattr(calling, "recorded_calls", _recorded)
    r = _run(tmp_path)
    # union 120 us + 80 us in the decompress [113, 114), 0.5 GB
    assert walks.read("walks.device_s_per_GB.decompress", r) == \
        pytest.approx(200e-6 / 0.5)
    # the compress holds one walk of 400 us, 1 GB
    assert walks.read("walks.device_s_per_GB.compress", r) == \
        pytest.approx(400e-6)


def test_chain_share_is_the_floor_over_the_walks(monkeypatch, tmp_path):
    monkeypatch.setattr(calling, "recorded_calls", _recorded)
    r = _run(tmp_path)
    floor = STEPS * 30 / 1.98e9
    assert floor == pytest.approx(90.909e-6, rel=1e-4)
    assert walks.read("walks.chain_share.decompress", r) == \
        pytest.approx(100 * floor / 200e-6)


def test_chain_share_none_without_counts(monkeypatch, tmp_path):
    r = _run(tmp_path)
    monkeypatch.setattr(calling, "recorded_calls",
                        lambda: _recorded(counts=False))
    assert walks.read("walks.chain_share.decompress", r) is None
    monkeypatch.setattr(calling, "recorded_calls",
                        lambda: _recorded(cls=OldSpan))
    assert walks.read("walks.chain_share.decompress", r) is None
    assert capture.read("capture.s_per_GB.decompress", r) == \
        pytest.approx(0.04)
    # without a walk in the trace the device time reads None
    r.trace = {"device": [], "ranges": {}}
    assert walks.read("walks.device_s_per_GB.decompress", r) is None


def test_chain_share_above_100_is_refused(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(calling, "recorded_calls", _recorded)
    # the walks took 60 us, less than their 90.9 us floor
    r = _run(tmp_path, [_event(
        "kernel", "void phyngsc::walk_masked_kernel<(Variant)0, true>",
        113.30e6, 60)])
    assert walks.read("walks.chain_share.decompress", r) is None
    assert "refused" in capsys.readouterr().err


def test_the_long_read_cell_runs_traced_on_the_cpu():
    """ont_na12878_long.roundtrip at a small size on the CPU, traced: a
    sound run, and its execution metrics read (nothing is captured on
    the CPU: 0); the walks, which run on the card only, read nothing."""
    from portbench import harness

    out = harness.run_cell(
        "ont_na12878_long.roundtrip", 2**31 + 77, 0.0, True, device="cpu",
        overrides={"params": {"reads_per_file": 12, "mu": 6.5}})
    assert out["correct"] is True and out["failed"] == 0
    m = out["metrics"]
    assert m["capture.s_per_GB.compress"]["value"] == 0.0
    assert m["capture.s_per_GB.decompress"]["value"] == 0.0
    assert "walks.chain_share.decompress" not in m
    assert "walks.device_s_per_GB.decompress" not in m

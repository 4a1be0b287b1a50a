"""The six span metrics (metrics/calling.py, metrics/pool.py) on a
synthetic list of the program's recorded calls with known wall, CPU and
wait intervals; and None where the program records nothing or has no
recorder. Run: python -m pytest portbench/"""

import os
import sys
import types
from typing import NamedTuple

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import Call, Run  # noqa: E402
from portbench.metrics import calling, pool  # noqa: E402


class Span(NamedTuple):  # the fields the readers use of the program's
    name: str
    id: int
    parent: int
    thread: int
    t0: int
    t1: int
    cpu: int
    wait: bool


def _span(name, id_, parent, thread, a, b, cpu=0.0, wait=False):
    return Span(name, id_, parent, thread, round(a * 1e9), round(b * 1e9),
                round(cpu * 1e9), wait)


def _call(kind, spans):
    return types.SimpleNamespace(kind=kind, spans=spans)


#: calling thread 1, pool threads 2 and 3; seconds on time.perf_counter
RECORDED = [
    # before the window: matches no call
    _call("compress", [_span("compress", 90, 0, 1, 5.0, 6.0, cpu=0.1)]),
    _call("compress", [
        _span("compress", 1, 0, 1, 10.1, 11.9, cpu=0.8),   # 1.0 s off
        _span("drv.wait_a", 2, 1, 1, 10.2, 10.5, wait=True),
        _span("stage_b", 4, 1, 1, 10.55, 11.0, cpu=0.4),
        _span("b.counts_fetch", 3, 4, 1, 10.6, 10.8, wait=True),
        _span("drv.wait_c", 5, 1, 1, 11.5, 11.7, wait=True),
        _span("stage_a", 10, 1, 2, 10.15, 10.45, cpu=0.1),  # 0.2 s off
        _span("a.gather", 11, 10, 2, 10.16, 10.3, cpu=0.01),  # not outermost
        _span("t.encode", 12, 10, 3, 10.2, 10.6, cpu=0.3),  # 0.1 s off
        _span("stage_c", 13, 1, 2, 11.0, 11.4, cpu=0.1),  # 0.3 s off
        _span("c.fetch", 14, 13, 2, 11.0, 11.2, wait=True),  # a pool wait
    ]),
    _call("decompress", [
        _span("decompress", 20, 0, 1, 13.1, 13.9, cpu=0.5),  # 0.3 s off
        _span("drv.wait_b", 21, 20, 1, 13.2, 13.3, wait=True),
        _span("decode_stage_b", 22, 20, 2, 13.15, 13.5, cpu=0.2),  # 0.15
        # ends after its call: not counted
        _span("decode_stage_b", 23, 20, 3, 13.8, 13.95),
    ]),
]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(calling, "recorded_calls", lambda: RECORDED)
    r = Run({"name": "x", "chips": 1}, {}, {}, 1, "cuda")
    r.calls = [Call("compress", 0, 10.0, 12.0, 1_000_000_000, 1_000_000_000,
                    b"c" * 10, None),
               Call("decompress", 0, 13.0, 14.0, 1_000_000_000, 10, b"",
                    None)]
    return r


@pytest.mark.parametrize("name, want", [
    ("calling.offcpu_s_per_GB.compress", 1.0),
    ("calling.offcpu_s_per_GB.decompress", 0.3),
    ("calling.wait_s_per_GB.compress", 0.7),
    ("calling.wait_s_per_GB.decompress", 0.1),
    ("pool.offcpu_s_per_GB.compress", 0.6),
    ("pool.offcpu_s_per_GB.decompress", 0.15),
])
def test_each_metric_reads_the_hand_computed_value(run, name, want):
    mod = calling if name.startswith("calling.") else pool
    assert mod.read(name, run) == pytest.approx(want)


def test_per_gb_divides_by_the_matched_calls_bytes(run):
    run.calls[0].fastq_bytes = 500_000_000
    assert calling.read("calling.offcpu_s_per_GB.compress", run) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("name", [
    "calling.offcpu_s_per_GB.compress", "calling.wait_s_per_GB.decompress",
    "pool.offcpu_s_per_GB.compress", "pool.offcpu_s_per_GB.decompress"])
def test_none_without_spans(monkeypatch, run, name):
    mod = calling if name.startswith("calling.") else pool
    monkeypatch.setattr(calling, "recorded_calls", lambda: [])
    assert mod.read(name, run) is None
    monkeypatch.setattr(calling, "recorded_calls", lambda: RECORDED[:1])
    assert mod.read(name, run) is None  # outside every call of the window
    assert mod.read(name.rsplit(".", 1)[0] + ".verify", run) is None


def test_a_program_without_the_recorder_has_no_calls(monkeypatch):
    monkeypatch.setitem(sys.modules, "portbench.system",
                        types.SimpleNamespace(
                            subblock=types.SimpleNamespace(TIMING=None)))
    assert calling.recorded_calls() == []
    monkeypatch.setitem(sys.modules, "portbench.system",
                        types.SimpleNamespace(subblock=types.SimpleNamespace(
                            recorded_calls=lambda: RECORDED)))
    assert calling.recorded_calls() == RECORDED

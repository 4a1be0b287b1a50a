"""The span recorder (utils/logging.py, entered through pipeline/subblock.py)
on the CPU device: the bytes do not change with it on; off, it records
nothing and reads no clock; on, every driver call is one call of nested
spans whose parents resolve, the pool's spans carry their sub-block and a
parent chain back to the calling thread, every stage named appears, the
calling thread's spans cover its call, TIMING's sums are the JAX labels'
spans, CPU time stays within wall time; and under torch.profiler the
calling thread's spans are user_annotation ranges."""

import concurrent.futures as cf
import json
import time

import pytest

from phyngsc_tpu_torch import graphs
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils import logging as tlog
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from test_torch_graph_steps import StubBackend
from torch_time_limit import time_limit

_limit = time_limit(60)
CFG = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=16)

#: the spans each call must hold (the drivers', the stages', the pool's)
NAMES = {
    "compress": {
        "compress", "drv.setup", "drv.index", "drv.submit", "drv.wait_a",
        "stage_b", "b.counts_fetch", "b.tables", "b.tables.quality",
        "b.tables.dna", "b.tables.fuse", "b.encode_dispatch", "b.title",
        "drv.wait_c", "drv.sink", "drv.close", "drv.finish", "drv.output",
        "stage_a", "a.gather", "a.crc", "a.pack", "a.upload_analyze",
        "t.encode", "stage_c", "c.fetch", "c.assemble", "g.capture"},
    "decompress": {
        "decompress", "drv.footer", "drv.setup", "drv.split",
        "decode_stage_a", "d.parse", "d.parse.meta", "d.parse.title",
        "d.parse.quality", "d.parse.dna", "d.parse.words",
        "d.parse.alphabets", "d.device_dispatch", "d.wires", "d.inputs",
        "d.launch", "drv.wait_b", "drv.write", "drv.close", "drv.assemble",
        "decode_stage_b", "d.fetch", "d.reassemble", "d.unpack",
        "d.title_wait", "d.fastq", "d.crc", "t.decode", "g.capture"},
}
JAX_LABELS = {"compress": {"stage_a", "stage_b", "stage_c", "b.counts_fetch",
                           "b.tables", "b.encode_dispatch", "b.title",
                           "c.fetch"},
              "decompress": {"d.parse", "d.device_dispatch", "d.fetch",
                             "d.reassemble"}}
WAITS = {"drv.wait_a", "drv.wait_c", "drv.wait_b", "b.counts_fetch",
         "b.title", "c.fetch", "d.fetch", "d.title_wait"}


@pytest.fixture(scope="module")
def data():
    return synthesize_fastq(6000, read_len=36, seed=95, ambiguity_rate=0.01)


@pytest.fixture(scope="module")
def recorded(data):
    """One compress and one decompress with PHYNGSC_TIMING set, through a
    graphs.Runner with a stand-in capture backend (so captures happen):
    {kind: (Call, TIMING after it)} and the container."""
    mp = pytest.MonkeyPatch()
    mp.setattr(graphs, "CPU_RUNNER", graphs.Runner(StubBackend()))
    mp.setenv("PHYNGSC_TIMING", "1")
    try:
        last = _last_id()
        blob = compress_bytes(data, CFG, 1, device="cpu")
        enc = dict(subblock.TIMING)
        back = decompress_bytes(blob, CFG, device="cpu")
        dec = dict(subblock.TIMING)
        calls = _since(last)
    finally:
        mp.undo()
    assert back == data
    assert [c.kind for c in calls] == ["compress", "decompress"]
    return {"compress": (calls[0], enc), "decompress": (calls[1], dec),
            "blob": blob}


def _last_id() -> int:
    calls = subblock.recorded_calls()
    return calls[-1].id if calls else 0


def _since(last: int) -> list:
    """The calls recorded after the call `last`."""
    return [c for c in subblock.recorded_calls() if c.id > last]


def _root(call):
    roots = [s for s in call.spans if s.parent == 0]
    assert len(roots) == 1
    return roots[0]


def _union(spans) -> int:
    total, end = 0, None
    for a, b in sorted(spans):
        a = a if end is None else max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


@pytest.mark.parametrize("shards", [1, 2])
def test_bytes_are_the_same_with_the_recorder_on_and_off(monkeypatch, data,
                                                          shards):
    cfg = CodecConfig(data_shards=shards, subblock_input_bytes=64 << 10,
                      records_per_substream=16)
    monkeypatch.delenv("PHYNGSC_TIMING", raising=False)
    plain = compress_bytes(data, cfg, 2, device="cpu")
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    last = _last_id()
    on = compress_bytes(data, cfg, 2, device="cpu")
    assert on == plain
    assert decompress_bytes(on, cfg, device="cpu") == data
    assert [c.kind for c in _since(last)] == ["compress", "decompress"]


def test_off_records_nothing_and_reads_no_clock(monkeypatch, data):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"the recorder read time.{name} while off")

    monkeypatch.delenv("PHYNGSC_TIMING", raising=False)
    monkeypatch.setattr(tlog, "time", NoClock())
    last = _last_id()
    blob = compress_bytes(data, CFG, 1, device="cpu")
    assert decompress_bytes(blob, CFG, device="cpu") == data
    assert _since(last) == []
    # one shared no-op for every span, and pool tasks go in unwrapped
    assert tlog.span("a") is tlog.span("b", wait=True, sub=3)
    assert tlog.task(len, "t") is len


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_a_call_is_one_tree_of_nested_spans(recorded, kind):
    call, _ = recorded[kind]
    root = _root(call)
    assert root.name == kind and root.call == call.id
    assert all(s.call == call.id for s in call.spans)
    ids = {s.id for s in call.spans}
    assert len(ids) == len(call.spans)
    assert all(s.parent in ids for s in call.spans if s is not root)
    assert all(s.t0 >= root.t0 and s.t1 <= root.t1 for s in call.spans)
    by_thread = {}
    for s in call.spans:
        by_thread.setdefault(s.thread, []).append(s)
    for spans in by_thread.values():
        spans.sort(key=lambda s: (s.t0, -s.t1))
        open_ = []  # the stack of enclosing spans
        for s in spans:
            while open_ and open_[-1].t1 <= s.t0:
                open_.pop()
            if open_:  # nested in the innermost, not overlapping it
                assert s.t1 <= open_[-1].t1, (open_[-1], s)
            open_.append(s)


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_pool_spans_carry_their_sub_block_and_a_calling_parent(recorded,
                                                               kind):
    call, _ = recorded[kind]
    root = _root(call)
    by_id = {s.id: s for s in call.spans}
    pool = [s for s in call.spans if s.thread != root.thread]
    assert pool
    for s in pool:
        assert s.sub >= 0, s
        up = s
        while up.thread != root.thread:
            up = by_id[up.parent]
            assert up.sub in (s.sub, -1), s
    outermost = [s for s in pool if by_id[s.parent].thread != s.thread]
    assert {s.name for s in outermost} == (
        {"stage_a", "stage_c", "t.encode"} if kind == "compress"
        else {"decode_stage_b", "t.decode"})
    n_sub = len({s.sub for s in pool})
    assert n_sub > 1
    assert sum(s.name == ("stage_a" if kind == "compress"
                          else "decode_stage_b") for s in pool) == n_sub


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_every_stage_appears_and_waits_are_flagged(recorded, kind):
    call, _ = recorded[kind]
    names = {s.name for s in call.spans}
    assert NAMES[kind] <= names, NAMES[kind] - names
    for s in call.spans:
        if s.name in WAITS - {"b.title"}:
            assert s.wait, s
        elif s.name != "b.title":
            assert not s.wait, s
    caps = [s for s in call.spans if s.name == "g.capture"]
    stages = {"compress": ("analyze_all", "encode_all"),
              "decompress": ("decode_walk_fused",)}[kind]
    assert caps and all(s.tag.split(" ")[0] in stages for s in caps)


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_the_calling_thread_is_covered(recorded, kind):
    call, _ = recorded[kind]
    root = _root(call)
    mine = [(s.t0, s.t1) for s in call.spans
            if s.thread == root.thread and s is not root]
    assert _union(mine) >= 0.99 * (root.t1 - root.t0)


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_timing_sums_are_the_jax_label_spans(recorded, kind):
    call, timing = recorded[kind]
    sums = {}
    for s in call.spans:
        sums[s.name] = sums.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-9
    seconds = {k: v for k, v in timing.items() if not k.endswith("_bytes")}
    assert set(seconds) == JAX_LABELS[kind]
    for label, v in seconds.items():
        assert v == pytest.approx(sums[label], rel=1e-9, abs=1e-12), label


@pytest.mark.parametrize("kind", ["compress", "decompress"])
def test_cpu_time_is_within_wall_time(recorded, kind):
    call, _ = recorded[kind]
    res = 2 * max(time.get_clock_info(c).resolution * 1e9
                  for c in ("thread_time", "perf_counter"))
    for s in call.spans:
        assert 0 <= s.cpu <= s.t1 - s.t0 + res, s


def test_the_recorder_keeps_the_last_calls(monkeypatch):
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    for _ in range(tlog.KEEP_CALLS + 5):
        with tlog.call("compress"):
            with tlog.span("drv.setup"):
                pass
    calls = subblock.recorded_calls()
    assert len(calls) == tlog.KEEP_CALLS
    assert [c.id for c in calls] == sorted(c.id for c in calls)
    assert [s.name for s in calls[-1].spans] == ["drv.setup", "compress"]


def test_a_task_runs_under_its_submitters_span(monkeypatch):
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with cf.ThreadPoolExecutor(2) as ex:
        with tlog.call("decompress"):
            with tlog.span("outer", sub=7) as outer:
                fut = ex.submit(tlog.task(lambda: 5, "inner"))
                assert fut.result() == 5
            with tlog.span("drv.submit", sub=2):
                ex.submit(tlog.task(lambda: None, "other")).result()
        # outside every call a task goes in unwrapped, and a pool thread
        # keeps no call behind it
        assert tlog.task(len, "t") is len
        assert ex.submit(lambda: tlog._HERE.call).result() is None
    call = subblock.recorded_calls()[-1]
    by_name = {s.name: s for s in call.spans}
    inner, other = by_name["inner"], by_name["other"]
    assert inner.parent == outer.id and inner.sub == 7
    assert inner.thread != by_name["outer"].thread
    assert other.parent == by_name["drv.submit"].id and other.sub == 2


def test_calling_spans_are_profiler_ranges(monkeypatch, tmp_path):
    """Under a CPU torch.profiler the calling thread's spans are
    user_annotation ranges on the calling thread, nested in the call's
    own; trace() records the call's spans without PHYNGSC_TIMING."""
    from torch.profiler import ProfilerActivity, profile

    data = synthesize_fastq(1200, read_len=36, seed=96)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = compress_bytes(data, CFG, 1, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    root = next(e for e in events if e["name"] == "compress")
    call = subblock.recorded_calls()[-1]
    calling = {s.name for s in call.spans if s.thread == _root(call).thread}
    ranges = {e["name"] for e in events if e["tid"] == root["tid"]}
    assert calling <= ranges, calling - ranges
    for e in events:
        if e["tid"] == root["tid"] and e["name"] in calling:
            assert root["ts"] <= e["ts"] <= root["ts"] + root["dur"]

    monkeypatch.delenv("PHYNGSC_TIMING")
    last = _last_id()
    with tlog.trace(str(tmp_path / "t"), "cpu"):
        assert decompress_bytes(blob, CFG, device="cpu") == data
    assert [c.kind for c in _since(last)] == ["decompress"]
    names = {e["name"] for e in json.loads(
        (tmp_path / "t" / "trace.json").read_text())["traceEvents"]
        if e.get("cat") == "user_annotation"}
    assert {"decompress", "d.parse", "drv.wait_b"} <= names
    if tlog._all_threads():  # this torch records every thread's ranges
        assert {"decode_stage_b", "d.fetch"} <= names


def test_spans_from_many_threads_are_not_lost(monkeypatch):
    """32 pool threads record into one call at a short switch interval:
    every span lands, with its own id, under its task's parent."""
    import sys

    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(200):
            with tlog.span("leaf"):
                pass

    try:
        with cf.ThreadPoolExecutor(32) as ex, tlog.call("compress"):
            futs = [ex.submit(tlog.task(work, "t")) for _ in range(32)]
            done, _ = cf.wait(futs, timeout=30)
            assert len(done) == 32
            for f in futs:
                f.result()
    finally:
        sys.setswitchinterval(interval)
    call = subblock.recorded_calls()[-1]
    leaves = [s for s in call.spans if s.name == "leaf"]
    assert len(leaves) == 32 * 200
    assert len({s.id for s in call.spans}) == len(call.spans)
    tasks = {s.id for s in call.spans if s.name == "t"}
    assert len(tasks) == 32 and all(s.parent in tasks for s in leaves)

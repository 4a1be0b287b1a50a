#!/usr/bin/env python3
"""One traced run of a benchmark cell, and what the port's span recorder
and the profiler's trace say about its calls.

    python3 tools/torch_span_report.py --workload err005195_ga36.roundtrip \
        --seed N [--seconds 51] [--out FILE]

Runs portbench's harness with --trace 1 in this process (the same run as
`portbench/run.py --trace 1`), keeps the trace's user_annotation ranges
with their threads, and prints its result line, then one JSON line of:

- coverage: per kind, the share of the recorded calls' wall that the
  calling thread's spans (its own span left out) cover (all the calls,
  and the least and the median of the calls);
- recorder_gaps, trace_gaps: per kind, the seconds of the calls that the
  calling thread's spans (ranges) leave uncovered, by the names of the
  spans before and after each stretch;
- idle_unnamed: per kind, the card's idle seconds inside the calls (the
  calls as the trace's own `compress` / `decompress` ranges) and the share
  of them under no other range of the calling thread;
- idle_by_range: per kind, idle seconds by the calling thread's innermost
  trace range around each idle stretch's middle;
- stages: per kind and span name, over the window's recorded calls: the
  count, wall, CPU, off-CPU (wall less CPU) and wait seconds, per GB of
  FASTQ and in all;
- counters: per kind, over the same calls: the sub-blocks (stage_b
  spans) and the sums of the program's event counts (subblock._count:
  q_tables.native, q_tables.candidates, t_encode.native).

--out also writes that JSON to FILE. Needs a CUDA card for the device
numbers; on the CPU (--device cpu, --tiny) it runs at a small size.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.metrics import _trace  # noqa: E402

TINY = {"params": {"records_per_file": 20000},
        "codec": {"subblock_input_bytes": 1 << 18}}


def _merged_len(spans) -> float:
    return sum(b - a for a, b in _trace.merged(spans))


def _minus(lo: float, hi: float, cover) -> list:
    """[lo, hi) less the union of `cover`, as intervals."""
    out, at = [], lo
    for a, b in _trace.merged(_trace.clipped(cover, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def _gaps(lo: float, hi: float, items, into: dict) -> None:
    """Adds each stretch of [lo, hi) that no (start, end, name) of `items`
    covers to into["previous -> next"], by the names of the item that
    ends last before it and the one that starts after it."""
    end, prev = lo, "start"
    for a, b, n in sorted(items):
        if a > end:
            key = f"{prev} -> {n}"
            into[key] = into.get(key, 0.0) + (a - end)
        if b > end:
            end, prev = b, n
    if hi > end:
        key = f"{prev} -> end"
        into[key] = into.get(key, 0.0) + (hi - end)


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def trace_report(tr: dict, ranges: list) -> dict:
    """The idle stretches of the calls in the trace, by the calling
    thread's ranges. ranges: [(name, tid, start, end)] in seconds."""
    root = next((r for r in ranges if r[0] == "portbench.round_trip"), None)
    if root is None:
        return {}
    tid = root[1]
    # by start, and of ranges that start together the outer first
    mine = sorted(((a, b, n) for n, t, a, b in ranges
                   if t == tid and n != "portbench.round_trip"),
                  key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in mine]
    busy = _trace.merged(a for v in _trace.per_card(
        tr, _trace.DEVICE_WORK).values() for a in v)

    def innermost(t: float, kind: str) -> str:
        # ranges of one thread nest: the latest to start before t that
        # ends after it
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0:
            a, b, n = mine[k]
            if b > t:
                return "-" if n == kind else n
            k -= 1
        return "-"

    out, by_range, gaps = {}, {}, {}
    for kind in ("compress", "decompress"):
        idle_s = unnamed = 0.0
        for lo, hi, _ in (s for s in mine if s[2] == kind):
            k0 = bisect.bisect_left(starts, lo)
            k1 = bisect.bisect_left(starts, hi)
            inner = [s for s in mine[k0:k1] if s[2] != kind]
            _gaps(lo, hi, inner, gaps.setdefault(kind, {}))
            inner = [(a, b) for a, b, _ in inner]
            inside = _trace.clipped(busy, lo, hi)
            idle_s += (hi - lo) - _merged_len(inside)
            unnamed += (hi - lo) - _merged_len(inside + inner)
            for a, b in _minus(lo, hi, inside):
                key = f"{kind}/{innermost((a + b) / 2, kind)}"
                by_range[key] = by_range.get(key, 0.0) + (b - a)
        out[kind] = {"idle_s": idle_s, "unnamed_s": unnamed,
                     "unnamed_share": unnamed / idle_s if idle_s else None}
    return {"idle_unnamed": out, "idle_by_range": _top(by_range, 16),
            "trace_gaps": {k: _top(v) for k, v in gaps.items()}}


def recorder_report(run, counted: list) -> dict:
    """counted: the program's event counts as (key, n, perf_counter)."""
    from portbench.metrics.calling import matched

    cover, stages, gaps, counters = {}, {}, {}, {}
    for kind in ("compress", "decompress"):
        pairs = matched(run, kind)
        if not pairs:
            continue
        gb = sum(c.fastq_bytes for c, _, _ in pairs) / 1e9
        shares, per, where_gaps = [], {}, {}
        covered = wall = 0.0
        for _, rec, root in pairs:
            mine = [(s.t0 * 1e-9, s.t1 * 1e-9, s.name) for s in rec.spans
                    if s.thread == root.thread and s is not root]
            c, w = (_merged_len((a, b) for a, b, _ in mine),
                    (root.t1 - root.t0) * 1e-9)
            shares.append(c / w)
            covered, wall = covered + c, wall + w
            _gaps(root.t0 * 1e-9, root.t1 * 1e-9, mine, where_gaps)
            for s in rec.spans:
                where = "calling" if s.thread == root.thread else "pool"
                p = per.setdefault(f"{where}/{s.name}",
                                   [0, 0.0, 0.0, 0.0, s.wait])
                p[0] += 1
                p[1] += (s.t1 - s.t0) * 1e-9
                p[2] += s.cpu * 1e-9
                p[3] += (s.t1 - s.t0 - s.cpu) * 1e-9
        mine = counters[kind] = {"sub_blocks": sum(
            s.name == "stage_b" for _, rec, _ in pairs for s in rec.spans)}
        for key, n, t in counted:
            if any(c.t0 <= t <= c.t1 for c, _, _ in pairs):
                mine[key] = mine.get(key, 0) + n
        cover[kind] = {"calls": len(pairs), "all": covered / wall,
                       "min": min(shares),
                       "median": statistics.median(shares)}
        gaps[kind] = _top(where_gaps)
        stages[kind] = {
            k: {"n": v[0], "wall_s": v[1], "cpu_s": v[2], "offcpu_s": v[3],
                "wait": v[4], "wall_s_per_GB": v[1] / gb,
                "cpu_s_per_GB": v[2] / gb, "offcpu_s_per_GB": v[3] / gb}
            for k, v in sorted(per.items(), key=lambda kv: -kv[1][1])}
    return {"coverage": cover, "recorder_gaps": gaps, "stages": stages,
            "counters": counters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--device", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    seen, runs = {}, []
    load, run_cls = _trace.load, harness.Run

    def load_keeping_threads(path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        seen["ranges"] = [
            (e.get("name", ""), e.get("tid"), float(e["ts"]) * 1e-6,
             (float(e["ts"]) + float(e["dur"])) * 1e-6)
            for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") == "user_annotation"]
        seen["trace"] = load(path)
        return seen["trace"]

    def keep_run(*args, **kwargs):
        r = run_cls(*args, **kwargs)
        runs.append(r)
        return r

    from phyngsc_tpu_torch.pipeline import subblock

    counted, count = [], subblock._count

    def count_keeping_times(key, n):
        counted.append((key, n, time.perf_counter()))
        count(key, n)

    _trace.load, harness.Run = load_keeping_threads, keep_run
    subblock._count = count_keeping_times
    try:
        out = harness.run_cell(a.workload, a.seed, a.seconds, True,
                               t_start=T_START, device=a.device,
                               overrides=TINY if a.tiny else None)
    finally:
        _trace.load, harness.Run = load, run_cls
        subblock._count = count
    print(json.dumps(out), flush=True)
    report = {"workload": a.workload, "seed": a.seed,
              **recorder_report(runs[0], counted),
              **trace_report(seen.get("trace"), seen.get("ranges", []))}
    print(json.dumps(report), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"result": out, "report": report}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

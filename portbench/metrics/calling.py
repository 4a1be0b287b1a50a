"""calling.offcpu_s_per_GB.<kind> and calling.wait_s_per_GB.<kind>: the
program's recorded calls of that kind (pipeline/subblock.py
recorded_calls, the span recorder that PHYNGSC_TIMING turns on) whose own
span lies inside one of the window's calls of that kind, on
time.perf_counter. offcpu: the calling thread's seconds off its CPU, its
call span's wall less its CPU time, summed; wait: the union of the
calling thread's spans in which it only waits on a future or an event
(the recorder's wait flag); each per GB (10^9 bytes) of those calls'
FASTQ. A program without the recorder reads None."""

from __future__ import annotations

import bisect
import sys

from portbench.metrics._trace import clipped, union


def recorded_calls() -> list:
    """The program's recorded calls, or [] where it has no recorder."""
    system = sys.modules.get("portbench.system")
    get = getattr(getattr(system, "subblock", None), "recorded_calls", None)
    return list(get()) if callable(get) else []


def matched(run, kind: str) -> list:
    """[(the window's call, the recorded call, its own span)] of `kind`."""
    calls = sorted(run.calls_of(kind), key=lambda c: c.t0)
    starts = [c.t0 for c in calls]
    out = []
    for rec in recorded_calls():
        root = next((s for s in rec.spans if s.parent == 0), None)
        if rec.kind != kind or root is None:
            continue
        k = bisect.bisect_right(starts, root.t0 * 1e-9) - 1
        if k >= 0 and root.t1 * 1e-9 <= calls[k].t1:
            out.append((calls[k], rec, root))
    return out


def per_gb(seconds: float, pairs: list) -> float:
    return seconds / (sum(c.fastq_bytes for c, _, _ in pairs) / 1e9)


def _offcpu(pairs) -> float:
    return sum(root.t1 - root.t0 - root.cpu for _, _, root in pairs) * 1e-9


def _wait(pairs) -> float:
    total = 0
    for _, rec, root in pairs:
        waits = [(s.t0, s.t1) for s in rec.spans
                 if s.wait and s.thread == root.thread]
        total += union(clipped(waits, root.t0, root.t1))
    return total * 1e-9


READ = {"offcpu_s_per_GB": _offcpu, "wait_s_per_GB": _wait}


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] not in READ:
        return None
    pairs = matched(run, parts[2])
    if not pairs:
        return None
    return per_gb(READ[parts[1]](pairs), pairs)

"""host.calling_s_per_GB.<kind> and host.pool_s_per_GB.<kind>: the
program's stage spans (pipeline/subblock.py's labels, made spans by
system.StageSpans) that end inside the window's calls of that kind, on the
calling thread or on the others (the drivers' pool), as the union of each
thread's spans (a stage's sub-steps lie inside it) summed over the
threads, in seconds per GB (10^9 bytes) of FASTQ."""

from __future__ import annotations

import bisect

from portbench.metrics._trace import union

WHICH = {"calling_s_per_GB": True, "pool_s_per_GB": False}


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] not in WHICH or run.spans is None:
        return None
    calls = sorted(run.calls_of(parts[2]), key=lambda c: c.t0)
    if not calls:
        return None
    starts = [c.t0 for c in calls]
    per_thread = {}
    for label, tid, a, b in run.spans:
        k = bisect.bisect_right(starts, b) - 1
        if k < 0 or b > calls[k].t1:
            continue
        if (tid == run.calling_thread) == WHICH[parts[1]]:
            per_thread.setdefault(tid, []).append((a, b))
    if not per_thread:
        return None
    seconds = sum(union(v) for v in per_thread.values())
    return seconds / (sum(c.fastq_bytes for c in calls) / 1e9)

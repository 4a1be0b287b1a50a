"""pool.offcpu_s_per_GB.<kind>: the seconds the drivers' pool threads
spent off their CPUs in the window's calls of that kind: over the
recorded calls that calling.py matches to them, each pool thread's
outermost spans (a span whose parent is on another thread: stage_a,
stage_c, decode_stage_b, the title tasks) that end inside the call, their
wall less their CPU time, summed, per GB (10^9 bytes) of FASTQ."""

from __future__ import annotations

from portbench.metrics.calling import matched, per_gb


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] != "offcpu_s_per_GB":
        return None
    pairs = matched(run, parts[2])
    if not pairs:
        return None
    total = 0
    for _, rec, root in pairs:
        thread = {s.id: s.thread for s in rec.spans}
        total += sum(s.t1 - s.t0 - s.cpu for s in rec.spans
                     if s.thread != root.thread
                     and thread.get(s.parent, s.thread) != s.thread
                     and root.t0 <= s.t1 <= root.t1)
    return per_gb(total * 1e-9, pairs)

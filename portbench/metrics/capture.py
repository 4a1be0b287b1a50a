"""capture.s_per_GB.<kind>: the seconds the program spent capturing and
evicting its CUDA graphs inside the window's calls of that kind: over the
recorded calls that calling.py matches to them, the spans named g.capture
and g.evict on any thread (the union of each thread's, inside the call),
per GB (10^9 bytes) of those calls' FASTQ. A warm process that has seen
every shape of its inputs reads 0. A program without the recorder reads
None."""

from __future__ import annotations

from portbench.metrics._trace import clipped, union
from portbench.metrics.calling import matched, per_gb

NAMES = ("g.capture", "g.evict")


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] != "s_per_GB":
        return None
    pairs = matched(run, parts[2])
    if not pairs:
        return None
    total = 0
    for _, rec, root in pairs:
        by_thread = {}
        for s in rec.spans:
            if s.name in NAMES:
                by_thread.setdefault(s.thread, []).append((s.t0, s.t1))
        total += sum(union(clipped(v, root.t0, root.t1))
                     for v in by_thread.values())
    return per_gb(total * 1e-9, pairs)

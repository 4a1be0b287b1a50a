"""wire.bytes_per_byte.<kind>: the bytes that the window's calls of that
kind moved between host and card (the program's h2d_bytes and d2h_bytes
counts) per byte of FASTQ."""

from __future__ import annotations

import bisect


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] != "bytes_per_byte" or run.counts is None:
        return None
    calls = sorted(run.calls_of(parts[2]), key=lambda c: c.t0)
    if not calls:
        return None
    starts = [c.t0 for c in calls]
    moved = 0.0
    for key, n, t in run.counts:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= calls[k].t1:
            moved += n
    if not moved:
        return None
    return moved / sum(c.fastq_bytes for c in calls)

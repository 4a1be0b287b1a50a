"""kernels_roofline.<kind>: the least time the card could take for
the window's calls of that kind, over the time its kernels took in them.
The work is the FASTQ bytes and the container bytes of each call, each
read or written once, at the HBM's bandwidth (_peaks.py); the benchmark
counts them from the inputs it made and the containers it got back,
whatever the program moves. The time is the union of the kernel intervals
(no copies) inside the calls, per card, summed over the cards."""

from __future__ import annotations

from portbench.metrics._peaks import bound_s
from portbench.metrics._trace import clipped, per_card, union


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 2 or not run.trace:
        return None
    cards = per_card(run.trace, ("kernel",))
    ranges = run.trace_ranges(parts[1])
    kernel_s = sum(union(clipped(v, a, b)) for v in cards.values()
                   for a, b in ranges)
    if kernel_s <= 0:
        return None
    work = sum(c.fastq_bytes + run.container_bytes(c)
               for c in run.calls_of(parts[1]))
    return 100.0 * bound_s(work) / kernel_s

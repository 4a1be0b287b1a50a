"""device.idle_share.<kind>: 100 less the card's busy share over the
window's calls of that kind: busy is the union of the kernel, copy and
memset intervals of the profiler's trace inside the calls, over the sum
of the calls' wall seconds; on several cards, the mean over the cards."""

from __future__ import annotations

from portbench.metrics._trace import DEVICE_WORK, clipped, per_card, union


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] != "idle_share" or not run.trace:
        return None
    cards = per_card(run.trace, DEVICE_WORK)
    ranges = run.trace_ranges(parts[2])
    wall = sum(b - a for a, b in ranges)
    if not cards or wall <= 0:
        return None
    n = max(int(run.workload["chips"]), len(cards))
    busy = sum(union(clipped(v, a, b)) for v in cards.values()
               for a, b in ranges) / n
    return 100.0 * (1.0 - busy / wall)

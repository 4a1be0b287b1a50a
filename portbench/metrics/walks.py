"""The decode's walks: the kernels K2 (walk_uniform_kernel) and K3
(walk_masked_kernel) of the program's csrc/walk.cu, by their names in the
profiler's trace.

walks.device_s_per_GB.<kind>: the union of the walk kernels' intervals
inside the window's calls of that kind, per card, summed over the cards,
per GB (10^9 bytes) of those calls' FASTQ.

walks.chain_share.<kind>: the walks' chain floor over their time, in %.
Each walk launch's chain floor is its longest lane's steps at 30 cycles a
step (a table load and a shift that the next step waits on) of the H100's
1.98 GHz clock: steps x 30 / 1.98e9 s, 15.15 ns a step (the program's
chip check, chip_smoke.py STEP_S). The program counts each decoded
sub-block's two launches on its span d.launch (utils/logging.py count:
walk.q.longest, the quality walk's longest lane, walk.d.longest, the DNA
walk's). Over the recorded calls that calling.py matches to the window's
calls of that kind, the floors are summed and divided by the union of the
walk kernels' intervals inside those calls, x 100. A program that counts
nothing reads None; so does a reading above 100, which would mean the
steps are counted too high or the kernels' time misses some of the walks
(the reader refuses it, on standard error)."""

from __future__ import annotations

import sys

from portbench.metrics._trace import clipped, union
from portbench.metrics.calling import matched

#: the kernel names of the walks (substrings of the trace's names)
KERNELS = ("walk_uniform_kernel", "walk_masked_kernel")
#: one step of a walk's dependent chain: 30 cycles at 1.98 GHz
STEP_S = 30 / 1.98e9
#: the counts of each walk launch's longest lane, on the span d.launch
LONGEST = ("walk.q.longest", "walk.d.longest")


def _walk_seconds(run, ranges) -> float | None:
    """The union of the walk kernels' intervals inside `ranges` (trace
    clock), per card, summed; None without a trace or a walk in it."""
    if not run.trace:
        return None
    cards = {}
    for cat, nm, dev, a, b in run.trace.get("device", ()):
        if cat == "kernel" and any(k in nm for k in KERNELS):
            cards.setdefault(dev, []).append((a, b))
    seconds = sum(union(clipped(v, a, b)) for v in cards.values()
                  for a, b in ranges)
    return seconds if seconds > 0 else None


def _device_s(run, kind: str):
    calls = run.calls_of(kind)
    seconds = _walk_seconds(run, run.trace_ranges(kind))
    if seconds is None:
        return None
    return seconds / (sum(c.fastq_bytes for c in calls) / 1e9)


def _chain_share(run, kind: str):
    pairs = matched(run, kind)
    steps, counted = 0, False
    for _, rec, _ in pairs:
        for s in rec.spans:
            counts = getattr(s, "counts", None) or {}
            for k in LONGEST:
                if k in counts:
                    steps += counts[k]
                    counted = True
    if not counted:
        return None
    seconds = _walk_seconds(run, [(c.t0 + run.trace_offset,
                                   c.t1 + run.trace_offset)
                                  for c, _, _ in pairs])
    if seconds is None:
        return None
    share = 100.0 * steps * STEP_S / seconds
    if share > 100.0:
        print(f"walks.chain_share.{kind}: {share} % refused: the floor "
              f"({steps} steps) exceeds the walks' {seconds} s",
              file=sys.stderr)
        return None
    return share


READ = {"device_s_per_GB": _device_s, "chain_share": _chain_share}


def read(name: str, run):
    parts = name.split(".")
    if len(parts) != 3 or parts[1] not in READ:
        return None
    return READ[parts[1]](run, parts[2])

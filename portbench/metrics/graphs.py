"""graphs.capture_s.cold: the seconds the program's CUDA graph captures
took in the cold round trip (graphs.stats() after it)."""

from __future__ import annotations


def read(name: str, run):
    if name != "graphs.capture_s.cold" or "capture_s" not in run.graph_cold:
        return None
    return float(run.graph_cold["capture_s"])

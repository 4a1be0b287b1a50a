"""Reading a torch.profiler Chrome trace: the card's work as intervals,
and their union. The categories and the union are copied from the port's
utils/logging.py device_activity, so that a change to the program cannot
move them."""

from __future__ import annotations

import json

#: the trace categories of the card's own work (its other rows, the
#: "cuda_sync" waits and the "gpu_user_annotation" spans, are not work)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def merged(spans) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def clipped(spans, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def per_card(trace: dict | None, cats) -> dict:
    """{device: [(start, end)]} of the trace's device intervals whose
    category is one of `cats`."""
    cards = {}
    for cat, _, dev, a, b in (trace or {}).get("device", ()):
        if cat in cats:
            cards.setdefault(dev, []).append((a, b))
    return cards


def load(path: str) -> dict:
    """The trace's complete events, in seconds: "device" [(category, name,
    device, start, end)], "ranges" {user_annotation name: [(start, end)]}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, ranges = [], {}
    for e in events:
        if e.get("ph") != "X" or "ts" not in e or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        cat = e.get("cat")
        if cat in DEVICE_WORK:
            dev = (e.get("args") or {}).get("device", e.get("pid"))
            device.append((cat, e.get("name", ""), dev, a, b))
        elif cat == "user_annotation":
            ranges.setdefault(e.get("name", ""), []).append((a, b))
    return {"device": device, "ranges": ranges}

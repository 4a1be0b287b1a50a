"""The card's busy share and the host's waits on it in one torch.profiler
run, read from its Chrome trace: device_activity(prof, scope, path).

chip_smoke.py (phase 5b) and tools/torch_wire_ab.py load this file by its
path; it needs only the standard library.
"""

from __future__ import annotations

import json

#: the CUDA runtime calls in which a host thread waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
#: the trace categories of the card's own work (the trace's other device
#: rows, "cuda_sync" waits and "gpu_user_annotation" spans, are not work)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def device_activity(prof, scope: str, trace_path: str) -> dict:
    """What a torch.profiler run (CPU and CUDA activities) saw inside the
    record_function `scope`, read from its Chrome trace (written to
    trace_path): wall_s; busy_s, the union of the card's kernel, copy and
    memset intervals in it, and busy_share = busy_s / wall_s; calling_op_s,
    the union of the scope thread's CPU ops (the rest of its wall is
    Python between ops, native host work and waits for the GIL or a
    core); for each of SYNC_CALLS, the seconds its calls took, keyed
    "thread/enclosing op" ("calling" for the scope's thread; e.g.
    aten::copy_ for a blocking copy). torch.profiler traces the CPU ops of
    the thread that profiles only, and the runtime calls and the card's
    work of every thread."""
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e and "dur" in e]
    top = next(e for e in events if e.get("name") == scope
               and e.get("cat") == "user_annotation")
    lo, hi, me = top["ts"], top["ts"] + top["dur"], str(top["tid"])
    busy, cpu_ops, sync = [], {}, {}
    for e in events:
        cat, a, b = e.get("cat"), e["ts"], e["ts"] + e["dur"]
        if cat in DEVICE_WORK:
            busy.append((max(a, lo), min(b, hi)))
        elif cat == "cpu_op":
            cpu_ops.setdefault(str(e.get("tid")), []).append(e)
    ops = [(o["ts"], min(o["ts"] + o["dur"], hi))
           for o in cpu_ops.get(me, ()) if lo <= o["ts"] < hi]
    for e in events:
        if (e.get("cat") != "cuda_runtime" or e.get("name") not in SYNC_CALLS
                or not lo <= e["ts"] < hi):
            continue
        tid, a, b = str(e.get("tid")), e["ts"], e["ts"] + e["dur"]
        around = [o for o in cpu_ops.get(tid, ())
                  if o["ts"] <= a and o["ts"] + o["dur"] >= b]
        parent = (min(around, key=lambda o: o["dur"])["name"]
                  if around else "-")
        key = f"{'calling' if tid == me else tid}/{parent}"
        per = sync.setdefault(e["name"], {})
        per[key] = per.get(key, 0.0) + e["dur"] * 1e-6
    wall = (hi - lo) * 1e-6
    busy_s = _union(busy) * 1e-6
    return {"wall_s": wall, "busy_s": busy_s,
            "busy_share": busy_s / wall if wall > 0 else 0.0,
            "calling_op_s": _union(ops) * 1e-6, "sync_s": sync}

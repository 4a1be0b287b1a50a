"""Structured logging + profiling hooks (port of phyngsc_tpu/utils/logging.py).

The reference's observability is printf with [I]/[E]/[!] prefixes and a
per-rank exit table (SURVEY §5, phyNGSC.cpp:108,63,323,1066). Here the same
prefixes feed Python logging (machine-parseable, level-filtered; the level
comes from PHYNGSC_LOG, default INFO), and `trace()` wraps a scope in a
torch.profiler trace: host activity always, the card's kernels on a CUDA
device, written as a Chrome trace (trace_dir/trace.json);
`device_activity()` reads the card's busy share and the host's waits on
the device from such a run.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time

_logger = logging.getLogger("phyngsc_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(os.environ.get("PHYNGSC_LOG", "INFO").upper())


def debug(msg: str, *args) -> None:
    _logger.debug("[D] " + msg, *args)


def info(msg: str, *args) -> None:
    _logger.info("[I] " + msg, *args)


def warn(msg: str, *args) -> None:
    _logger.warning("[!] " + msg, *args)


def error(msg: str, *args) -> None:
    _logger.error("[E] " + msg, *args)


@contextlib.contextmanager
def trace(trace_dir: str | None, device=None):
    """Profile a scope with torch.profiler when trace_dir is set: host
    activity, and CUDA activity when `device` is a CUDA device; the trace is
    written to trace_dir/trace.json (chrome://tracing, Perfetto). No-op
    otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    info("profiler trace written to %s", path)


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


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt

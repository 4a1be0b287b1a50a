"""The benchmark's harness: one run of one cell.

Everything is found by name. The cell is an entry of BENCHMARK.json's
"workloads"; it names a configuration (configs/<name>.json: the
generator, its parameters, the codec's fields, the writers and the
device) and a traffic mix (traffic/<name>.json: the loop). The generator
is generators/<name>.py (generate(params, seed, index) -> FASTQ bytes).
A metric NAME is read by metrics/<NAME up to its first dot>.py, or, where
there is no such file, by metrics/<its source>.py: read(name, run)
returns a number, or None where the run holds nothing to read it from.
So a later configuration, mix, cell or metric is new files and entries.

A run: set-up (load the program, make the cell's inputs from the seed,
time the cold round trip, one warm round trip), then the window, a
closed loop of round trips (compress, then decompress of that container)
over the inputs in turn for the given seconds, then the checks that
decide `correct` (check.py), then the metrics.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import json
import os
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules the process must not hold when the window has closed, compared
#: by whole top-level name (the port's name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "phyngsc_tpu")


class SetupError(RuntimeError):
    """The run cannot be made here (no card, too few, or a broken cell);
    the run prints no result."""


@dataclasses.dataclass
class Call:
    kind: str           # "compress" | "decompress"
    index: int          # which input
    t0: float           # time.perf_counter at entry and return
    t1: float
    fastq_bytes: int    # the input's size
    in_bytes: int       # the size of what it was given
    out: bytes | None   # what the call returned
    error: str | None   # what it raised


@dataclasses.dataclass
class Run:
    """What one run saw; the metric readers read it."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    setup_s: float = 0.0
    cold_roundtrip_s: float = 0.0
    graph_cold: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)
    #: traced runs: the program's stage spans (label, thread, start, end)
    #: and byte counts (key, bytes, time) on time.perf_counter, the
    #: calling thread's id, and the profiler's trace (_trace.load) with
    #: the offset from time.perf_counter to its clock
    spans: list | None = None
    counts: list | None = None
    calling_thread: int = 0
    trace: dict | None = None
    trace_offset: float = 0.0

    def calls_of(self, kind: str) -> list:
        return [c for c in self.calls if c.kind == kind and c.error is None]

    def container_bytes(self, c: Call) -> int:
        """The container's size of a compress or decompress call."""
        return len(c.out) if c.kind == "compress" else c.in_bytes

    def trace_ranges(self, kind: str) -> list:
        return [(c.t0 + self.trace_offset, c.t1 + self.trace_offset)
                for c in self.calls_of(kind)]


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> tuple:
    """(workload, configuration file, traffic file, [end-to-end metric],
    [per-layer metric]) of the cell `name`; metrics that name other cells
    under "workloads" are left out."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT, entry["file"])
    traffic = load_json(HERE, "traffic", w["traffic"] + ".json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return (w, config, traffic, mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def reader(metric: dict):
    """The read() of a metric's module (see the module docstring)."""
    for mod in (metric["name"].split(".")[0], metric["source"]):
        if os.path.exists(os.path.join(HERE, "metrics", mod + ".py")):
            return importlib.import_module(f"portbench.metrics.{mod}").read
    raise SetupError(f"no reader for metric {metric['name']!r}")


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def check_chips(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _call(run: Run, system, kind: str, index: int, arg: bytes, cfg, nbytes):
    t0 = time.perf_counter()
    out = err = None
    try:
        if kind == "compress":
            out = system.compress(arg, cfg, run.config["n_writers"],
                                  run.device)
        else:
            out = system.decompress(arg, cfg, run.device)
    except Exception as e:  # the call failed: counted, the loop goes on
        err = f"{type(e).__name__}: {e}"
    return Call(kind, index, t0, time.perf_counter(), nbytes, len(arg), out,
                err)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float | None = None, device: str | None = None,
             overrides: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line's object. device:
    the configuration's unless given (the CPU tests pass "cpu", which
    skips the look for a card). overrides: merged into the configuration
    file (the CPU tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    w, config, traffic, e2e, layers = cell(benchmark(), name)
    config = _merge(config, overrides)
    device = device or config["device"]
    if device.startswith("cuda"):
        check_chips(int(w["chips"]))
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise SetupError("the harness drives one closed-loop client")
    from portbench import system  # the program, and torch with it
    run = Run(w, config, traffic, seed, device)
    system.load(device)
    gen = importlib.import_module(f"portbench.generators.{config['generator']}")
    inputs = [gen.generate(config["params"], seed, i)
              for i in range(int(traffic["inputs"]))]
    cfg = system.codec_config(config["codec"])

    def round_trip(i: int) -> list:
        c = _call(run, system, "compress", i, inputs[i], cfg, len(inputs[i]))
        if c.error is not None:
            return [c]
        return [c, _call(run, system, "decompress", i, c.out, cfg,
                         len(inputs[i]))]

    cold = round_trip(0)
    run.cold_roundtrip_s = cold[-1].t1 - cold[0].t0
    run.graph_cold = system.graph_stats()
    warm = round_trip(1 % len(inputs))
    for c in cold + warm:
        if c.error is not None:
            raise SetupError(f"set-up {c.kind} raised {c.error}")
    del cold, warm
    prof = spans = None
    if trace:
        spans = system.StageSpans().__enter__()
        prof = _profiler(device)
        prof.__enter__()
    run.calling_thread = threading.get_ident()
    run.setup_s = time.perf_counter() - t_start
    deadline = time.perf_counter() + seconds
    i = 0
    # round trips until the deadline, and at least one of every input
    while time.perf_counter() < deadline or i < len(inputs):
        k = i % len(inputs)
        for c in _annotated(round_trip, k, trace):
            run.calls.append(c)
        i += 1
    window = (run.calls[0].t0, run.calls[-1].t1)
    _synchronize(device)
    if trace:
        prof.__exit__(None, None, None)
        spans.__exit__(None, None, None)
        run.spans, run.counts = spans.spans, spans.counts
        run.trace, run.trace_offset = _read_trace(prof, run)
    dev = _device_entry(device, int(w["chips"]))
    found = forbidden_modules()
    if found:
        raise SetupError(f"modules loaded that must not be: {found}")
    from portbench import check
    t_check = time.perf_counter()
    checks, failed_calls = check.judge(run, inputs)
    for c in run.calls:
        print(f"call {c.kind} input {c.index}: {c.t1 - c.t0:.4f} s"
              + (f" raised {c.error}" if c.error else ""), file=sys.stderr)
    print(f"set-up {run.setup_s:.3f} s, its cold round trip "
          f"{run.cold_roundtrip_s:.3f} s", file=sys.stderr)
    print(f"window {window[1] - window[0]:.3f} s, {len(run.calls)} calls; "
          f"reference and checks {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    metrics = {}
    for m in (layers if trace else e2e):
        v = reader(m)(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(run.calls), "failed": failed_calls,
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(_busy(run, window))
        out["breakdown"] = _breakdown(run)
    out["checks"] = checks
    for k, v in checks.items():  # the last lines of standard error
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    return out


def _annotated(round_trip, k: int, trace: bool) -> list:
    if not trace:
        return round_trip(k)
    from torch.profiler import record_function
    with record_function("portbench.round_trip"):
        return round_trip(k)


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _synchronize(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _read_trace(prof, run: Run) -> tuple:
    """The profiler's trace (written to TMPDIR and removed), and the offset
    from time.perf_counter to its clock, from the round trips' ranges."""
    from portbench.metrics import _trace
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = _trace.load(path)
    finally:
        os.remove(path)
    starts = sorted(a for a, _ in tr["ranges"].get("portbench.round_trip",
                                                   []))
    firsts = [c.t0 for c in run.calls if c.kind == "compress"]
    offs = sorted(a - t for a, t in zip(starts, firsts))
    return tr, (offs[len(offs) // 2] if offs else 0.0)


def _device_entry(device: str, chips: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def _busy(run: Run, window: tuple) -> dict:
    from portbench.metrics import _trace
    lo, hi = (t + run.trace_offset for t in window)
    cards = _trace.per_card(run.trace, _trace.DEVICE_WORK)
    n = max(int(run.workload["chips"]), len(cards), 1)
    busy = sum(_trace.union(_trace.clipped(v, lo, hi))
               for v in cards.values()) / n
    return {"busy_s": busy, "window_s": hi - lo}


def _breakdown(run: Run) -> dict:
    """The device operations that took most time, and the idle time inside
    the calls by what the calling thread was in: the innermost stage span
    of that thread around each idle gap's middle, else "-"."""
    from portbench.metrics import _trace
    ops = {}
    for cat, nm, _, a, b in (run.trace or {}).get("device", ()):
        ops[nm] = ops.get(nm, 0.0) + (b - a)
    # by start, and of spans that start together the outer first
    mine = sorted(((a + run.trace_offset, b + run.trace_offset, label)
                   for label, tid, a, b in run.spans or ()
                   if tid == run.calling_thread),
                  key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in mine]

    def innermost(t: float) -> str:
        # spans of one thread nest or do not meet: the innermost around t
        # is the latest to start before t that ends after it
        k = bisect.bisect_right(starts, t) - 1
        for s in mine[max(k - 16, 0):k + 1][::-1]:
            if s[1] >= t:
                return s[2]
        return "-"
    busy = _trace.merged(a for v in _trace.per_card(
        run.trace, _trace.DEVICE_WORK).values() for a in v)
    gaps = {}
    for kind in ("compress", "decompress"):
        for lo, hi in run.trace_ranges(kind):
            inside = _trace.clipped(busy, lo, hi)
            edges = [lo] + [x for ab in inside for x in ab] + [hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b <= a:
                    continue
                key = f"{kind}/{innermost((a + b) / 2)}"
                gaps[key] = gaps.get(key, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}

"""CUDA graphs of the sub-block stages: the port of phyngsc_tpu's one
compiled executable a device stage (pipeline/subblock.py _analyze_all,
_encode_all and _decode_walk_fused under jax.jit), shared by every
sub-block whose static shapes match.

A stage's step (subblock.analyze_all, encode_all, decode_walk_fused) is a
function of tensors of static shapes plus a static key: the JAX package's
static arguments and bucketed sizes. The Runner maps (device, stage, key)
to instances, each a torch.cuda.CUDAGraph with its own static input buffer
and the static outputs of its capture:

- Capture rule. The first sight of a key on a device runs the step eagerly
  on the task's stream (it warms the kernels' launch caches and the
  allocator, and makes the constant tables); every later sight replays an
  instance. A stage whose outputs a child reads (stage A, lease(...,
  paired=True)) warms eagerly at its first sight and then captures and
  replays, so that every stage B finds static outputs to be captured on,
  whichever pool thread leased a key first. If every instance of
  the key is leased, a new one is captured (on a stream of the capturing
  thread's own, capture_error_mode "thread_local", so that the other
  threads' event waits and pinned allocations stay legal) and replayed for
  that same sub-block. A failed capture raises; nothing falls back to the
  eager step.
- Leases. An instance is leased to one task from its upload into the static
  input until its outputs' fetches are queued (Lease.release: for encode,
  from stage A's upload to stage B's fetch). The release records an event
  on the holder's stream, and the next holder's stream waits on it (no host
  wait), so an instance passes between task streams and concurrent driver
  calls never share one's buffers at once.
- Pairs. A stage-B instance reads a stage-A instance's static outputs, so
  it is the A instance's child (Lease.child): captured into the same
  memory pool, leased and evicted with it.
- Memory. Instances live for the process, as JAX's executables do, within
  BUDGET_BYTES of graph pool and input memory: a capture past it evicts
  the least recently released instances (after their last replay's event),
  counted in stats()["evictions"].
- Launch counts. A capture launches nothing: kernels.recording notes the
  wrappers' launches and each replay adds them to kernels.LAUNCHES.
- Spans. A capture is the span g.capture (utils/logging.py span), tagged
  with its stage and key, so that a capture inside a measured window shows.

On the CPU the drivers call the steps directly (runner_for gives None, and
lease() a plain buffer), unless a Runner is installed as CPU_RUNNER (the
CPU tests do, with a stand-in capture backend). direct() makes the calling
thread bypass the runner on any device; measuring code uses it to keep a
stage's tensors out of graph buffers that a later replay overwrites.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.utils.logging import span

#: graph pool and static input bytes the CUDA runner keeps at most
BUDGET_BYTES = 16 << 30

#: a Runner used for CPU devices, or None: the steps run directly there
CPU_RUNNER = None

_RUNNER = None
_RUNNER_LOCK = threading.Lock()
_direct = threading.local()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class CudaBackend:
    """Capture, replay and order CUDA graphs for a Runner.

    A capture runs on a stream no other work uses: torch.cuda.Stream()
    hands out the streams of a fixed pool in turn, so a new stream of the
    default priority may be another task's stream, whose work would then
    join the capture. Capture streams come from the high-priority pool
    (the task streams take the default one), each a distinct CUDA stream,
    leased to one capture at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle = {}     # device -> [capture stream not in use]
        self._handles = set()

    def _take_stream(self, device) -> torch.cuda.Stream:
        with self._lock:
            idle = self._idle.setdefault(device, [])
            if idle:
                return idle.pop()
            for _ in range(64):
                s = torch.cuda.Stream(device, priority=-1)
                if s.cuda_stream not in self._handles:
                    self._handles.add(s.cuda_stream)
                    return s
        raise RuntimeError(f"no capture stream of its own left on {device}")

    def capture(self, fn, device, pool):
        """(graph, fn()'s outputs as captured, the launches it recorded)."""
        graph = torch.cuda.CUDAGraph()
        stream = self._take_stream(device)
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream), \
                    kernels.recording() as names:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            with self._lock:
                self._idle[device].append(stream)
        return graph, out, list(names)

    def replay(self, graph) -> None:
        graph.replay()

    def pool(self, graph):
        return graph.pool()

    def pool_bytes(self, device, pool) -> int:
        """Bytes the caching allocator holds in `pool` on `device`."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == device.index
                   and tuple(seg["segment_pool_id"]) == tuple(pool))

    def record(self, device):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return event

    def wait(self, event, device) -> None:
        torch.cuda.current_stream(device).wait_event(event)

    def synchronize(self, event) -> None:
        event.synchronize()


class _Instance:
    __slots__ = ("dkey", "inputs", "graph", "outputs", "launches", "children",
                 "parent", "event", "nbytes", "broken")

    def __init__(self, dkey, parent=None):
        self.dkey, self.parent = dkey, parent
        self.inputs = self.graph = self.outputs = self.event = None
        self.launches, self.children = [], {}
        self.nbytes, self.broken = 0, False


class Lease:
    """One task's hold on a stage's static input buffer (`inputs`, uint8)
    and, but for an eager first sight or a direct run, on an instance.
    run(fn) computes the stage: fn reads the inputs and returns its
    outputs."""

    __slots__ = ("_runner", "_dkey", "_inst", "inputs", "eager", "_done",
                 "_children", "_warmup")

    def __init__(self, runner, dkey, inst, inputs, eager, warmup=False):
        self._runner, self._dkey, self._inst = runner, dkey, inst
        self.inputs, self.eager, self._warmup = inputs, eager, warmup
        self._done, self._children = False, []

    def run(self, fn):
        if self._runner is None:
            return fn()
        return self._runner._run(self, fn)

    def child(self, stage: str, key, nbytes: int) -> "Lease":
        """The lease of a stage that reads this one's outputs (stage B of
        stage A's instance), released with this one."""
        if self._runner is None:
            return lease(self._dkey[0], stage, key, nbytes)
        return self._runner._child(self, stage, key, nbytes)

    def release(self, ok: bool = True) -> None:
        """Call once the fetches of the outputs are queued (ok), or after a
        failure (not ok: the instance is dropped)."""
        if self._runner is not None and not self._done:
            self._done = True
            self._runner._release(self, ok)


class Runner:
    """Instances of the stages' graphs by (device, stage, key); see the
    module's docstring. backend: CudaBackend, or a stand-in with the same
    methods."""

    def __init__(self, backend=None, budget: int | None = None):
        self.backend = backend if backend is not None else CudaBackend()
        self.budget = BUDGET_BYTES if budget is None else budget
        self._lock = threading.Lock()
        self._seen = {}    # dkey -> threading.Event set once its eager run ends
        self._free = {}                        # dkey -> [unleased instance]
        self._lru = collections.OrderedDict()  # unleased roots, oldest first
        self._leased = set()
        self._kept = []    # instances of failed stages whose last use is unknown
        self._bytes = 0
        self.reset_stats()

    # -- statistics ---------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self._stats = {"capture_s": 0.0, "evictions": 0}
            self._stages = {}

    def _stage(self, stage: str, key) -> dict:
        st = self._stages.setdefault(stage, {"eager": 0, "captures": 0,
                                             "replays": 0, "keys": set()})
        st["keys"].add(key)
        return st

    def stats(self) -> dict:
        """Since reset_stats: per stage the eager runs, captures, replays
        and distinct keys used; the seconds the captures took, the
        evictions; now: the instances and their bytes."""
        with self._lock:
            out = {s: {**{k: v for k, v in d.items() if k != "keys"},
                       "keys": len(d["keys"])}
                   for s, d in sorted(self._stages.items())}
            out.update(self._stats)
            out["instances"] = len(self._lru) + len(self._leased)
            out["graph_bytes"] = self._bytes
            return out

    # -- leases -------------------------------------------------------------

    def lease(self, device, stage: str, key, nbytes: int,
              paired: bool = False) -> Lease:
        device = _device(device)
        dkey = (device, stage, key)
        with self._lock:
            self._stage(stage, key)
            warm = self._seen.get(dkey)
            if warm is None:
                self._seen[dkey] = threading.Event()
                inst = None
                if paired:
                    inst = _Instance(dkey)
                    self._leased.add(inst)
            else:
                free = self._free.get(dkey)
                inst = free.pop() if free else _Instance(dkey)
                self._lru.pop(id(inst), None)
                self._leased.add(inst)
        if warm is None:
            if inst is None:
                return Lease(self, dkey, None, _buffer(nbytes, device), True)
            inst.inputs = _buffer(nbytes, device)
            return Lease(self, dkey, inst, inst.inputs, False, warmup=True)
        warm.wait()  # the key's eager first run has made what it makes once
        if inst.inputs is None:
            inst.inputs = _buffer(nbytes, device)
        elif inst.event is not None:
            self.backend.wait(inst.event, device)
        return Lease(self, dkey, inst, inst.inputs, False)

    def _child(self, parent: Lease, stage: str, key, nbytes: int) -> Lease:
        device = parent._dkey[0]
        dkey = (device, stage, key)
        with self._lock:
            self._stage(stage, key)
            warm = self._seen.get(dkey)
            first = warm is None
            if first:
                self._seen[dkey] = threading.Event()
            inst = None
            if not (parent.eager or first):
                inst = parent._inst.children.get(key)
                if inst is None:
                    inst = parent._inst.children[key] = _Instance(
                        dkey, parent._inst)
        if inst is None:
            out = Lease(self, dkey, None, _buffer(nbytes, device), True)
        else:
            warm.wait()
            if inst.inputs is None:
                inst.inputs = _buffer(nbytes, device)
            out = Lease(self, dkey, inst, inst.inputs, False)
        out._done = True  # released with its parent
        parent._children.append(out)
        return out

    def _run(self, ls: Lease, fn):
        stage = ls._dkey[1]
        if ls.eager:
            try:
                out = fn()
            finally:
                self._seen[ls._dkey].set()
            with self._lock:
                self._stage(stage, ls._dkey[2])["eager"] += 1
            return out
        inst = ls._inst
        if ls._warmup:
            try:
                fn()
            finally:
                self._seen[ls._dkey].set()
            with self._lock:
                self._stage(stage, ls._dkey[2])["eager"] += 1
        if inst.graph is None:
            root = inst.parent or inst
            pool = (self.backend.pool(root.graph) if inst.parent is not None
                    else None)
            t0 = time.perf_counter()
            try:
                with span("g.capture", tag=f"{stage} {ls._dkey[2]}"):
                    inst.graph, inst.outputs, inst.launches = \
                        self.backend.capture(fn, ls._dkey[0], pool)
            except BaseException:
                inst.broken = True
                raise
            nbytes = sum(i.inputs.numel() for i in (root,
                                                    *root.children.values())
                         if i.inputs is not None)
            if hasattr(self.backend, "pool_bytes"):
                nbytes += self.backend.pool_bytes(
                    ls._dkey[0], self.backend.pool(root.graph))
            with self._lock:
                self._bytes += nbytes - root.nbytes
                root.nbytes = nbytes
                self._stats["capture_s"] += time.perf_counter() - t0
                self._stage(stage, ls._dkey[2])["captures"] += 1
        self.backend.replay(inst.graph)
        kernels.add_launches(inst.launches)
        with self._lock:
            self._stage(stage, ls._dkey[2])["replays"] += 1
        return inst.outputs

    def _release(self, ls: Lease, ok: bool) -> None:
        for x in (ls, *ls._children):  # a first sight that never ran
            self._seen[x._dkey].set()
        inst = ls._inst
        if inst is None:
            return
        event = self.backend.record(ls._dkey[0])
        evict = []
        with self._lock:
            self._leased.discard(inst)
            broken = (not ok or inst.broken or inst.graph is None
                      or any(c._inst is not None and c._inst.broken
                             for c in ls._children))
            if broken:
                self._bytes -= inst.nbytes
                evict.append((inst, event))
            else:
                inst.event = event
                for c in ls._children:
                    if c._inst is not None:
                        c._inst.event = event
                self._free.setdefault(inst.dkey, []).append(inst)
                self._lru[id(inst)] = inst
            while self._bytes > self.budget and self._lru:
                _, old = self._lru.popitem(last=False)
                self._free[old.dkey].remove(old)
                self._bytes -= old.nbytes
                self._stats["evictions"] += 1
                evict.append((old, old.event))
        for old, ev in evict:  # the last replay done before the memory goes
            try:
                if ev is not None:
                    self.backend.synchronize(ev)
            except Exception:  # a failed stage's stream: keep its memory
                self._kept.append(old)
                continue
            old.children.clear()
            old.graph = old.outputs = old.inputs = None


def _buffer(nbytes: int, device) -> torch.Tensor:
    return torch.empty(max(nbytes, 16), dtype=torch.uint8, device=device)


def runner_for(device):
    """The Runner of `device`'s stages: the process's CUDA runner for a
    card, CPU_RUNNER for the CPU; None (the steps run directly) under
    direct()."""
    if getattr(_direct, "on", False):
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_RUNNER
    global _RUNNER
    if _RUNNER is None:
        with _RUNNER_LOCK:
            if _RUNNER is None:
                _RUNNER = Runner()
    return _RUNNER


def lease(device, stage: str, key, nbytes: int,
          paired: bool = False) -> Lease:
    """A task's lease of `stage` at `key` on `device` with a static input
    buffer of `nbytes` (runner_for's runner; without one a plain buffer,
    and run() calls the step). paired: a child stage reads its outputs."""
    runner = runner_for(device)
    if runner is None:
        return Lease(None, (torch.device(device), stage, key),
                     None, _buffer(nbytes, device), False)
    return runner.lease(device, stage, key, nbytes, paired)


def stats() -> dict:
    """The CUDA runner's statistics (Runner.stats; empty before its first
    use)."""
    return _RUNNER.stats() if _RUNNER is not None else {}


def reset_stats() -> None:
    if _RUNNER is not None:
        _RUNNER.reset_stats()


@contextlib.contextmanager
def direct():
    """Context in which this thread's stages call their steps directly,
    without graphs (for code that keeps a stage's outputs)."""
    before = getattr(_direct, "on", False)
    _direct.on = True
    try:
        yield
    finally:
        _direct.on = before

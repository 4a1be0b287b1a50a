"""CUDA graphs of the sub-block stages: the port of phyngsc_tpu's one
compiled executable a device stage (pipeline/subblock.py _analyze_all,
_encode_all and _decode_walk_fused under jax.jit), shared by every
sub-block whose static shapes match.

A stage's step (subblock.analyze_all, encode_all, decode_walk_fused) is a
function of tensors of static shapes plus a static key: the JAX package's
static arguments and bucketed sizes. The Runner maps (device, stage, key)
to instances, each a torch.cuda.CUDAGraph with its own static input
buffer and the static outputs of its capture:

- Capture rule. The first sight of a key on a device runs the step eagerly
  on the task's stream (it warms the kernels' launch caches and the
  allocator, and makes the constant tables), then captures an instance
  and replays it; every later sight replays an instance. If every
  instance of the key is leased, a new one is captured, but for a shared
  key (below), which has one. A capture runs on a stream of the
  capturing thread's own,
  capture_error_mode "thread_local", so that the other threads' event
  waits and pinned allocations stay legal. A failed capture raises;
  nothing falls back to the eager step.
- Leases. An instance is leased to one task from its upload into the
  static input until its outputs are copied out or their fetches queued
  (Lease.release; a lease holds no other lease and waits for no other
  task, so a task that waits for a shared key's instance waits for a
  step's dispatch). The release records an event on the holder's stream,
  and the next holder's stream waits on it (no host wait), so an
  instance passes between task streams and concurrent driver calls never
  share its buffers at once.
- Pools. An instance has a memory pool of its own, but the instances of
  a stage's shared keys (lease(..., shared=True): the drivers share the
  keys of long variable-length sub-blocks, whose steps take gigabytes of
  int64 planes) share one: a later capture reuses what an earlier one
  freed (the step's intermediates), so the stage holds about one step's
  scratch, not one an instance, and a shared key has one instance (a
  task waits for it). Each keeps its static input (outside the pool) and
  outputs, but a replay of another instance of the pool may write over
  them. So a pool is used in turns: a lease takes its turn at its replay
  and gives it back at its release, once its outputs are copied out or
  their fetches queued, and the next replay's stream waits for that (an
  event; no host wait; the turn is held for a step's dispatch).
- Memory. Instances live for the process, as JAX's executables do, within
  the runner's budget of pool and static input memory, counted as the
  allocator holds it after each capture (on a card: half of the card's
  free memory when the runner is made). A release past the budget evicts
  the least recently released instances: once an instance's last
  replay's event is done its graph and tensors go, and a pool that no
  instance uses any more is given back to the card (the span g.evict,
  tagged like g.capture), as is a broken instance's. stats() counts the
  evictions, the bytes given back (freed_bytes) and the most the
  instances held (peak_bytes). The allocator returns no memory to the
  card while a capture is underway, so a capture first gives back what
  the cache holds free, and captures and give-backs take turns.
- Launch counts. A capture launches nothing: kernels.recording notes the
  wrappers' launches and each replay adds them to kernels.LAUNCHES.
- Spans. A capture is the span g.capture (utils/logging.py span), tagged
  with its stage and key, so that a capture inside a measured window shows;
  an eviction is g.evict.

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

#: the share of the card's free memory, when the CUDA runner is made, that
#: its instances may hold: the rest is the eager steps', the fetches' and
#: the caching allocator's (one 65,532 bp sub-block's eager step holds
#: gigabytes)
BUDGET_SHARE = 0.5

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

    def budget(self) -> int:
        """BUDGET_SHARE of the current card's free memory."""
        free, _ = torch.cuda.mem_get_info()
        return int(free * BUDGET_SHARE)

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
        # the allocator frees nothing while a capture is underway: what
        # the cache holds free goes back to the card first
        torch.cuda.empty_cache()
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

    def held_bytes(self, device, pools, tensors=()) -> list:
        """The bytes the caching allocator holds on `device` in each of
        `pools`, and last in the blocks of `tensors`."""
        want = {tuple(p): i for i, p in enumerate(pools)}
        ptrs = {t.data_ptr() for t in tensors}
        out = [0] * (len(pools) + 1)
        for seg in torch.cuda.memory_snapshot():
            if seg["device"] != device.index:
                continue
            at = want.get(tuple(seg["segment_pool_id"]))
            if at is not None:
                out[at] += seg["total_size"]
            if ptrs:
                out[-1] += sum(b["size"] for b in seg["blocks"]
                               if b["address"] in ptrs)
        return out

    def give_back(self) -> None:
        """The cached blocks no tensor holds, freed pools' included, back
        to the card."""
        torch.cuda.empty_cache()

    def record(self, device):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return event

    def wait(self, event, device) -> None:
        torch.cuda.current_stream(device).wait_event(event)

    def synchronize(self, event) -> None:
        event.synchronize()


class _Instance:
    __slots__ = ("dkey", "inputs", "graph", "outputs", "launches", "event",
                 "nbytes", "broken", "leased", "pool", "shared")

    def __init__(self, dkey, shared):
        self.dkey, self.shared = dkey, shared
        self.inputs = self.graph = self.outputs = self.event = None
        self.launches, self.pool = [], None
        self.nbytes, self.broken, self.leased = 0, False, True


class _Pool:
    """A stage's memory pool on a device: its handle, its instances, the
    bytes the allocator holds in it, and its last replay's event (taken
    and replaced under its lock)."""

    __slots__ = ("handle", "users", "nbytes", "event", "lock")

    def __init__(self, handle):
        self.handle, self.users, self.nbytes = handle, 0, 0
        self.event, self.lock = None, threading.Lock()


class Lease:
    """One task's hold on a stage's static input buffer (`inputs`, uint8)
    and, but for a direct run, on its instance. run(fn) computes the stage:
    fn reads the inputs and returns its outputs, which are the instance's
    (static: a later replay overwrites them) where `static`."""

    __slots__ = ("_runner", "_dkey", "_inst", "inputs", "_done", "_warmup",
                 "_turn")

    def __init__(self, runner, dkey, inst, inputs, warmup=False):
        self._runner, self._dkey, self._inst = runner, dkey, inst
        self.inputs, self._warmup = inputs, warmup
        self._done, self._turn = False, None

    @property
    def static(self) -> bool:
        return self._runner is not None

    def run(self, fn):
        if self._runner is None:
            return fn()
        return self._runner._run(self, fn)

    def release(self, ok: bool = True) -> None:
        """Call once the outputs are copied out or their fetches queued
        (ok), or after a failure (not ok: the instance is dropped)."""
        if self._runner is not None and not self._done:
            self._done = True
            self._runner._release(self, ok)


class Runner:
    """The instances of the stages' graphs by (device, stage, key); see the
    module's docstring. backend: CudaBackend, or a stand-in with the same
    methods. budget: the bytes the instances may hold; default the
    backend's budget()."""

    def __init__(self, backend=None, budget: int | None = None):
        self.backend = backend if backend is not None else CudaBackend()
        self.budget = self.backend.budget() if budget is None else budget
        self._lock = threading.Condition()
        self._turns = threading.Lock()  # captures and give-backs
        self._seen = {}    # dkey -> threading.Event set once its eager run ends
        self._inst = {}                        # dkey -> [its instances]
        self._pools = {}                       # (device, stage) -> _Pool
        self._lru = collections.OrderedDict()  # unleased instances, oldest first
        self._kept = []    # instances of failed stages whose last use is unknown
        self._bytes = 0
        self.reset_stats()

    # -- statistics ---------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self._stats = {"capture_s": 0.0, "evictions": 0,
                           "freed_bytes": 0, "peak_bytes": self._bytes,
                           "largest_bytes": 0}
            self._stages = {}

    def _stage(self, stage: str, key) -> dict:
        st = self._stages.setdefault(stage, {"eager": 0, "captures": 0,
                                             "replays": 0, "keys": set()})
        st["keys"].add(key)
        return st

    def stats(self) -> dict:
        """Since reset_stats: per stage the eager runs, captures, replays
        and distinct keys used; the seconds the captures took, the
        evictions, the bytes eviction gave back to the card (freed_bytes),
        the most the instances held (peak_bytes) and one instance held
        after its capture (largest_bytes); now: the instances and their
        bytes (graph_bytes)."""
        with self._lock:
            out = {s: {**{k: v for k, v in d.items() if k != "keys"},
                       "keys": len(d["keys"])}
                   for s, d in sorted(self._stages.items())}
            out.update(self._stats)
            out["instances"] = sum(map(len, self._inst.values()))
            out["graph_bytes"] = self._bytes
            return out

    # -- leases -------------------------------------------------------------

    def lease(self, device, stage: str, key, nbytes: int,
              shared: bool = False) -> Lease:
        device = _device(device)
        dkey = (device, stage, key)
        with self._lock:
            self._stage(stage, key)
            while True:
                insts = self._inst.setdefault(dkey, [])
                inst = next((i for i in insts if not i.leased), None)
                if inst is not None or not (shared and insts):
                    break
                self._lock.wait()
            if inst is None:
                inst = _Instance(dkey, shared)
                insts.append(inst)
            else:
                inst.leased = True
                self._lru.pop(id(inst), None)
            warm = self._seen.get(dkey)
            if warm is None:
                self._seen[dkey] = threading.Event()
        if warm is not None:
            warm.wait()  # the key's eager first run made what it makes once
        if inst.inputs is None:
            inst.inputs = _buffer(nbytes, device)
        elif inst.event is not None:
            self.backend.wait(inst.event, device)
        return Lease(self, dkey, inst, inst.inputs, warm is None)

    def _run(self, ls: Lease, fn):
        stage, key = ls._dkey[1:]
        inst = ls._inst
        if ls._warmup:
            try:
                fn()
            except BaseException:
                with self._lock:  # the next sight warms up again
                    self._seen.pop(ls._dkey).set()
                raise
            self._seen[ls._dkey].set()
            with self._lock:
                self._stage(stage, key)["eager"] += 1
        if inst.graph is None:
            self._capture(ls, fn)
        pool = inst.pool
        pool.lock.acquire()  # the pool's turn, given back at the release
        ls._turn = pool
        if pool.event is not None:
            self.backend.wait(pool.event, ls._dkey[0])
        self.backend.replay(inst.graph)
        kernels.add_launches(inst.launches)
        with self._lock:
            self._stage(stage, key)["replays"] += 1
        return inst.outputs

    def _capture(self, ls: Lease, fn) -> None:
        inst = ls._inst
        device, stage, key = ls._dkey
        t0 = time.perf_counter()
        try:
            with span("g.capture", tag=f"{stage} {key}"), self._turns:
                pool = (self._pools.get((device, stage)) if inst.shared
                        else None)
                inst.graph, inst.outputs, inst.launches = \
                    self.backend.capture(fn, device, pool and pool.handle)
                with self._lock:
                    if pool is None:
                        pool = _Pool(self.backend.pool(inst.graph))
                    elif self._pools.get((device, stage)) is not pool:
                        pool.nbytes = 0  # let go meanwhile: counted anew
                    if inst.shared:
                        self._pools[(device, stage)] = pool
                    pool.users += 1
                    inst.pool = pool
        except BaseException:
            inst.broken = True
            raise
        held, nbytes = self._held(pool, inst)
        with self._lock:
            self._bytes += held - pool.nbytes + nbytes - inst.nbytes
            pool.nbytes, inst.nbytes = held, nbytes
            self._stats["peak_bytes"] = max(self._stats["peak_bytes"],
                                            self._bytes)
            self._stats["largest_bytes"] = max(
                self._stats["largest_bytes"], held + nbytes)
            self._stats["capture_s"] += time.perf_counter() - t0
            self._stage(stage, key)["captures"] += 1

    def _held(self, pool: _Pool, inst: _Instance) -> tuple:
        """(the bytes of the pool, of the instance's static input), as the
        allocator holds them."""
        held, nbytes = self.backend.held_bytes(inst.dkey[0], [pool.handle],
                                               [inst.inputs])
        return held, nbytes

    def _release(self, ls: Lease, ok: bool) -> None:
        warm = self._seen.get(ls._dkey)
        if warm is not None:  # a first sight that never ran
            warm.set()
        inst = ls._inst
        event = self.backend.record(ls._dkey[0])
        if ls._turn is not None:
            ls._turn.event = event
            ls._turn.lock.release()
            ls._turn = None
        drop = []
        with self._lock:
            inst.leased = False
            if not ok or inst.broken or inst.graph is None:
                drop.append((inst, event, self._forget(inst)))
            else:
                inst.event = event
                self._lru[id(inst)] = inst
            while self._bytes > self.budget and self._lru:
                _, old = self._lru.popitem(last=False)
                self._stats["evictions"] += 1
                drop.append((old, old.event, self._forget(old)))
            self._lock.notify_all()
        if drop:
            self._drop(drop)

    def _forget(self, inst: _Instance):
        """Take the instance out of the runner and its bytes out of the
        count (its pool's too where it was the last to use it, which is
        then returned; else None). Under the lock."""
        insts = self._inst[inst.dkey]
        insts.remove(inst)
        if not insts:
            del self._inst[inst.dkey]
        self._bytes -= inst.nbytes
        pool = inst.pool
        if pool is None:
            return None
        pool.users -= 1
        if pool.users:
            return None
        self._bytes -= pool.nbytes
        if self._pools.get(inst.dkey[:2]) is pool:
            del self._pools[inst.dkey[:2]]
        return pool

    def _drop(self, drop: list) -> None:
        """Each (instance, its last replay's event, its pool if it goes
        with it), in the span g.evict: once the event is done its graph and
        tensors go; then the pools that went back to the card, in the
        last one's span. freed_bytes: what they counted, less what the
        allocator still holds of the pools."""
        freed, pools = 0, []
        for n, (old, ev, pool) in enumerate(drop):
            device, stage, key = old.dkey
            with span("g.evict", tag=f"{stage} {key}"):
                try:
                    if ev is not None:
                        self.backend.synchronize(ev)
                except Exception:  # a failed stage's stream: keep its memory
                    self._kept.append(old)
                else:
                    old.graph = old.outputs = old.inputs = None
                    freed += old.nbytes
                    if pool is not None:
                        freed += pool.nbytes
                        pools.append(pool.handle)
                if n == len(drop) - 1:
                    with self._turns:
                        self.backend.give_back()
                        freed -= sum(self.backend.held_bytes(
                            device, pools)[:-1])
        with self._lock:
            self._stats["freed_bytes"] += freed


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
          shared: bool = False) -> Lease:
    """A task's lease of `stage` at `key` on `device` with a static input
    buffer of `nbytes` (runner_for's runner; without one a plain buffer,
    and run() calls the step). shared: the key's one instance, in the
    stage's shared pool (see the module's docstring)."""
    runner = runner_for(device)
    if runner is None:
        return Lease(None, (torch.device(device), stage, key),
                     None, _buffer(nbytes, device))
    return runner.lease(device, stage, key, nbytes, shared)


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

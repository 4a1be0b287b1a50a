"""Structured logging + profiling hooks (port of phyngsc_tpu/utils/logging.py).

The reference's observability is printf with [I]/[E]/[!] prefixes and a
per-rank exit table (SURVEY §5, phyNGSC.cpp:108,63,323,1066). Here the same
prefixes feed Python logging (machine-parseable, level-filtered; the level
comes from PHYNGSC_LOG, default INFO), and `trace()` wraps a scope in a
torch.profiler trace: host activity always, the card's kernels on a CUDA
device, written as a Chrome trace (trace_dir/trace.json).

The span recorder. A driver call (call()) decides at its start whether
spans are recorded: with PHYNGSC_TIMING set, or inside trace(). When they
are, every span() records its name, its id and its parent's, the call's
id, the sub-block's task index (or -1), its thread, its start and end on
time.perf_counter_ns, the thread's CPU nanoseconds over it
(time.thread_time_ns), whether the thread only waited in it (on a
future or an event), and the counts that count() added to it while it
was this thread's innermost open span. Spans live in memory, one list a
call; the last KEEP_CALLS calls are kept (recorded_calls()). A pool
thread knows nothing of the call that submitted its work, so task()
carries the submitting thread's call, innermost span and sub-block to
it. While a torch.profiler
records, each span is also a record_function range of its name (a
user_annotation in the trace), so the trace holds the recording thread's
stages on its own clock (the profiling thread's; every thread's under
trace()'s profile_all_threads).
Off, span() and task() read one global and return a shared no-op (task:
the function itself): no clock, no allocation.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import os
import sys
import threading
import time
from typing import NamedTuple

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
    written to trace_dir/trace.json (chrome://tracing, Perfetto). The
    driver calls inside record their spans, which the trace shows as
    user_annotation ranges: the calling thread's, and the pool threads'
    where this torch takes profile_all_threads. No-op otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _PROFILING
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities, **_all_threads()) as prof:
        _PROFILING += 1
        try:
            yield
        finally:
            _PROFILING -= 1
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    info("profiler trace written to %s", path)


def _all_threads() -> dict:
    """profile()'s keyword that records every thread's ranges, where this
    torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


# -- the span recorder --------------------------------------------------------

#: the recorded calls kept (the oldest go first): a process that records
#: all its life holds at most this many calls' spans
KEEP_CALLS = 256


class Span(NamedTuple):
    """One recorded span; times in nanoseconds."""

    name: str
    id: int
    parent: int     # 0: none (a call's own span)
    call: int
    sub: int        # the sub-block's task index; -1: none
    thread: int     # threading.get_ident()
    t0: int         # time.perf_counter_ns() at entry and exit
    t1: int
    cpu: int        # the thread's time.thread_time_ns() over the span
    wait: bool      # the thread only waited in it
    tag: str
    counts: dict | None = None  # count()'s sums while it was innermost


class Call:
    """One driver call's spans (its own span, `kind`, is among them)."""

    __slots__ = ("id", "kind", "spans")

    def __init__(self, kind: str):
        self.id, self.kind, self.spans = next(_CALL_IDS), kind, []


class _Here(threading.local):
    """A thread's place: its call, its innermost open span, its sub-block."""

    call = None
    parent = 0
    sub = -1
    open = None      # the innermost open _Open


_ON = False          # set at each outermost call's start
_PROFILING = 0       # trace() scopes open
_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)
_CALLS: collections.deque = collections.deque(maxlen=KEEP_CALLS)
_HERE = _Here()
_NOOP = contextlib.nullcontext()
_autograd = None     # torch.autograd, once a call records


class _Open:
    """A span being recorded (span() while on)."""

    __slots__ = ("name", "wait", "sub", "tag", "done", "id", "call",
                 "parent", "outer_sub", "outer", "t0", "c0", "rf", "counts")

    def __init__(self, name, wait, sub, tag, done):
        self.name, self.wait, self.sub = name, wait, sub
        self.tag, self.done = tag, done
        self.counts = None

    # A profiler range is entered first and left last, so that the trace's
    # ranges leave the least between a thread's consecutive spans; inside
    # it the clocks are read first and last, so that a span's time holds
    # its own bookkeeping but not the profiler's. The range is entered
    # without the operator call that torch.profiler.record_function makes:
    # that call drops the GIL, and each drop can cost the thread a switch
    # interval behind the pool threads.
    def __enter__(self):
        self.rf = None
        if _autograd is not None and _autograd.profiler._is_profiler_enabled:
            self.rf = (_autograd._record_function_with_args_enter(
                self.name, self.tag) if self.tag else
                _autograd._record_function_with_args_enter(self.name))
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        here = _HERE
        self.call, self.parent = here.call, here.parent
        self.outer_sub = here.sub
        if self.sub is None:
            self.sub = self.outer_sub
        self.id = next(_IDS)
        self.outer = here.open
        here.parent, here.sub, here.open = self.id, self.sub, self
        return self

    def __exit__(self, *exc):
        here = _HERE
        here.parent, here.sub = self.parent, self.outer_sub
        here.open = self.outer
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        if self.call is not None:
            self.call.spans.append(Span(
                self.name, self.id, self.parent, self.call.id, self.sub,
                threading.get_ident(), self.t0, t1, c1 - self.c0, self.wait,
                self.tag, self.counts))
        if self.done is not None:
            self.done(self.name, (t1 - self.t0) * 1e-9)
        if self.rf is not None:
            _autograd._record_function_with_args_exit(self.rf)
        return False


def span(name: str, *, wait: bool = False, sub: int | None = None,
         tag: str = "", done=None):
    """A context manager: the span `name` on this thread, inside its
    innermost open span. wait: the thread only waits in it. sub: its
    sub-block's task index (default: the enclosing span's). tag: a note
    (the profiler's range carries it too). done(name, seconds) is called at
    its end. Off, or on a thread outside every call, nothing is recorded
    (done is still called while on)."""
    if not _ON:
        return _NOOP
    return _Open(name, wait, sub, tag, done)


def counting() -> bool:
    """Whether count() records on this thread now (a caller may then skip
    working out its counts)."""
    return _ON and _HERE.open is not None


def count(**counts) -> None:
    """Add each count to this thread's innermost open span (its Span's
    counts). Off, or with no span open, nothing."""
    sp = _HERE.open if _ON else None
    if sp is None:
        return
    if sp.counts is None:
        sp.counts = {}
    for k, v in counts.items():
        sp.counts[k] = sp.counts.get(k, 0) + v


class _CallScope:
    """An outermost call: its own span is the root of its spans."""

    __slots__ = ("call", "span", "outer")

    def __enter__(self):
        here = _HERE
        self.call = Call(self.span.name)
        self.outer = here.parent, here.sub
        here.call, here.parent, here.sub = self.call, 0, -1
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        here = _HERE
        here.call, (here.parent, here.sub) = None, self.outer
        _CALLS.append(self.call)
        return False


def call(kind: str):
    """A context manager around one driver call ("compress" or
    "decompress"). Outermost on its thread, it decides whether the call's
    spans are recorded (PHYNGSC_TIMING set, or a trace() open) and, when
    they are, records the call and its own span `kind`; nested in another
    call it joins that one."""
    global _ON, _autograd
    if _HERE.call is not None:
        return _NOOP
    _ON = bool(os.environ.get("PHYNGSC_TIMING")) or _PROFILING > 0
    if not _ON:
        return _NOOP
    if _autograd is None:
        import torch.autograd

        _autograd = torch.autograd
    scope = _CallScope()
    scope.span = _Open(kind, False, -1, "", None)
    return scope


def recorded(kind: str):
    """Decorator: each call of the function is a call(kind)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with call(kind):
                return fn(*args, **kwargs)
        return run
    return wrap


def task(fn, name: str | None = None):
    """fn as a pool task of this thread's call: on the pool's thread it
    runs under the span innermost here now (its parent) and in its
    sub-block, inside the span `name` if given. Off, or outside every
    call: fn itself."""
    if not _ON or _HERE.call is None:
        return fn
    here = _HERE
    ctx = (here.call, here.parent, here.sub)

    def run(*args, **kwargs):
        outer = (here.call, here.parent, here.sub)
        here.call, here.parent, here.sub = ctx
        try:
            if name is None:
                return fn(*args, **kwargs)
            with _Open(name, False, None, "", None):
                return fn(*args, **kwargs)
        finally:
            here.call, here.parent, here.sub = outer
    return run


def recorded_calls() -> list:
    """The kept calls (Call), oldest first."""
    return list(_CALLS)

"""Device selection and the asynchronous host<->device primitives.

resolve picks a device and never falls back to the CPU. The rest is the
port of phyngsc_tpu's asynchronous execution (pipeline/subblock.py
_host_async and its jax.device_put calls), where no host thread waits while
it hands work to the device:

- upload / Staging: host arrays reach the device through one pinned staging
  buffer, copied with non_blocking=True on the current stream. PyTorch's
  caching host allocator records an event on that copy, so the staging
  block is handed out again only after the copy has read it.
- fetch_async / Pending: a device tensor is copied into pinned host memory
  on the current stream behind an event; Pending.result() waits on that
  event alone, so a fetch waits only for the work queued before it on its
  own stream.
- task_streams / StreamRing / use_streams: a sub-block in flight is one
  task with one stream a device. The drivers hold a ring of task slots,
  hand one to each task in task order, and each stage that issues device
  work runs it inside use_streams, so all of it (kernels included:
  kernels._launch takes the current stream) is ordered on its own stream,
  whichever thread issues it. A slot's streams are made once a process,
  so the caching allocator's memory kept for them is found again by the
  next driver call.

- Staging(into=...) / views: the same one copy into the prefix of a
  device buffer that outlives the sub-block (a captured graph's static
  input, graphs.py), whose pieces lie at the offsets the specs give.
- constant: the codec's small host tables on a device, uploaded once a
  process, so that no step uploads anything (a graph replays no upload).

On the CPU (a CPU-only torch cannot pin) there is nothing to pin, no event
and no stream: upload is a plain copy, a Pending holds its array and a task
holds None. On CUDA a failed pin, stream or event raises; nothing falls
back to pageable memory or to a blocking copy.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def resolve(device) -> torch.device:
    """torch.device for `device`; raises RuntimeError for a CUDA device when
    no card is visible (pass device="cpu" to run the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def on_device(device: torch.device):
    """Context in which `device` is the current CUDA device (its current
    stream is the one work goes on); nothing to enter for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


_DTYPES: dict = {}


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    t = _DTYPES.get(dtype)
    if t is None:
        t = _DTYPES[dtype] = torch.from_numpy(np.zeros(0, dtype)).dtype
    return t


class Staging:
    """Host buffer of one upload: the pieces (shape, numpy dtype) of `specs`
    at offsets that are multiples of `align` bytes, each padded with zeros
    to a multiple of it, pinned for a CUDA device. Write each piece into
    its numpy view (views), then send() makes the one copy. nbytes: the
    buffer's size, the bytes the copy moves."""

    def __init__(self, specs, device, align: int = 16, into=None):
        self.device = torch.device(device)
        self._into = into
        self._specs = [(tuple(shape), np.dtype(dt)) for shape, dt in specs]
        self._offs, n = _layout(self._specs, align)
        self.nbytes = n
        # a CUDA device: pinned, or raise (no pageable fall back)
        self._host = torch.empty(n, dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
        buf = self._host.numpy()
        self.views = []
        for (shape, dt), o in zip(self._specs, self._offs):
            size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            end = o + -(-size // align) * align
            buf[o + size:end] = 0
            self.views.append(buf[o:o + size].view(dt).reshape(shape))

    @classmethod
    def of(cls, arrays, device, align: int = 16, into=None) -> "Staging":
        """A Staging holding `arrays`, each written into its view."""
        arrays = [np.asarray(a) for a in arrays]
        st = cls([(a.shape, a.dtype) for a in arrays], device, align, into)
        for v, a in zip(st.views, arrays):
            v[...] = a
        return st

    def into(self, buf) -> "Staging":
        """This Staging, to send into `buf` (a uint8 device buffer)."""
        self._into = buf
        return self

    def send(self) -> list:
        """The pieces on the device: views of one uint8 tensor made by one
        copy, non-blocking on the current stream for a CUDA device (a
        plain copy on the CPU). Made with `into` (a uint8 device buffer of
        nbytes or more), the copy fills that buffer's prefix and the rest
        keeps what it held."""
        cuda = self.device.type == "cuda"
        dev = self._into
        if dev is None:
            dev = (self._host.to(self.device, non_blocking=True) if cuda
                   else self._host.clone())
        elif (dev.dtype != torch.uint8 or dev.ndim != 1
              or dev.numel() < self.nbytes):
            raise ValueError(f"Staging: {self.nbytes} B into a buffer of "
                             f"{dev.numel()} {dev.dtype}")
        else:
            dev[:self.nbytes].copy_(self._host, non_blocking=cuda)
        return _views(dev, self._specs, self._offs)


def _layout(specs, align: int) -> tuple:
    """(offsets, total bytes) of pieces (shape, numpy dtype) laid out one
    after another, each at a multiple of `align` bytes."""
    offs, n = [], 0
    for shape, dt in specs:
        offs.append(n)
        n += -(-int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
               // align) * align
    return offs, n


def _views(buf: torch.Tensor, specs, offs) -> list:
    return [buf[o:o + int(np.prod(shape, dtype=np.int64)) * dt.itemsize]
            .view(_torch_dtype(dt)).view(shape)
            for (shape, dt), o in zip(specs, offs)]


def layout_bytes(specs, align: int = 16) -> int:
    """The bytes of a buffer laid out as a Staging of `specs` lays it
    out."""
    return _layout([(tuple(sh), np.dtype(dt)) for sh, dt in specs], align)[1]


def views(buf: torch.Tensor, specs, align: int = 16) -> list:
    """The pieces (shape, numpy dtype) of `specs` as views of the uint8
    device buffer `buf`, at the offsets a Staging of the same specs gives
    them: a Staging whose last piece is shorter sends into the prefix of a
    buffer laid out with the longer one, and every other piece lands where
    these views read it."""
    specs = [(tuple(sh), np.dtype(dt)) for sh, dt in specs]
    return _views(buf, specs, _layout(specs, align)[0])


def upload(arrays, device, align: int = 16) -> list:
    """Host arrays -> tensors of the same dtypes and shapes on `device`,
    made by one copy through a Staging (each array at a multiple of `align`
    bytes: the kernels load 16 bytes at a time)."""
    return Staging.of(arrays, device, align).send()


class Pending:
    """A device -> host copy in flight (fetch_async). result() waits for
    its event alone and returns the host array, a view of pinned memory
    that keeps that memory alive while it lives; on the CPU the array
    itself."""

    __slots__ = ("_host", "_event")

    def __init__(self, host: torch.Tensor, event=None):
        self._host, self._event = host, event

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()  # releases the GIL while it waits
        return self._host.numpy()


def fetch_async(t: torch.Tensor, *more: torch.Tensor) -> Pending:
    """Start copying `t` to the host on the current stream of its device
    (the counterpart of phyngsc_tpu's copy_to_host_async). The event blocks
    the waiting thread instead of spinning on a core, which the host's
    stages need. With `more` (1-d tensors of t's dtype and device, t 1-d
    too), the pieces arrive one after another in one host array, each by
    its own copy, behind one event."""
    parts = (t, *more)
    if t.device.type != "cuda":
        return Pending(torch.cat(parts) if more else t)
    shape = (sum(p.numel() for p in parts),) if more else t.shape
    host = torch.empty(shape, dtype=t.dtype, pin_memory=True)
    at = 0
    for p in parts:
        host[at:at + p.numel()].copy_(p.reshape(-1) if more else p,
                                      non_blocking=True)
        at += p.numel()
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(t.device))
    return Pending(host, event)


_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.Lock()


def constant(name: str, make, device) -> torch.Tensor:
    """The host table make() (a numpy array, the same every call) as a
    tensor on `device`, uploaded the first time a process asks for `name`
    there and then kept: a graph's replay reads it where its capture found
    it. The first upload is waited for (on its own event), so that a task
    on another stream never reads it early. Asked for while the thread
    captures a graph, a table not yet on the device raises: the capture
    would record a copy from host memory that is not kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, device)
    t = _CONSTANTS.get(key)
    if t is not None:
        return t
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"constant {name!r} first asked for on {device} "
                           "while a graph is captured")
    with _CONSTANTS_LOCK:
        t = _CONSTANTS.get(key)
        if t is None:
            (t,) = upload([np.asarray(make())], device)
            if device.type == "cuda":
                done = torch.cuda.Event(blocking=True)
                done.record(torch.cuda.current_stream(device))
                done.synchronize()
            _CONSTANTS[key] = t
    return t


#: the task streams of each CUDA device, slot by slot, made once a process:
#: PyTorch's caching allocator keeps freed device memory for the stream that
#: allocated it, so fresh streams for every driver call would find none
#: cached and allocate (cudaMalloc, which waits for the device) anew
_SLOTS: dict = {}
_SLOTS_LOCK = threading.Lock()


def task_streams(devices, slot: int = 0):
    """The streams of task slot `slot`: one stream on each distinct CUDA
    device of `devices`, the same for that slot and device all through the
    process; None when no device is a card."""
    seen = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d not in seen:
            seen.append(d)
    out = []
    with _SLOTS_LOCK:
        for d in seen:
            slots = _SLOTS.setdefault(d, [])
            while len(slots) <= slot:
                slots.append(torch.cuda.Stream(d))
            out.append(slots[slot])
    return tuple(out) or None


class StreamRing:
    """The streams of task slots 0 .. n - 1 (task_streams of `devices`),
    handed out in turn by take(); every entry is None when no device is a
    card."""

    def __init__(self, devices, n: int):
        self._slots = [task_streams(devices, i) for i in range(max(n, 1))]
        self._next = 0

    def take(self):
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        return slot


@contextlib.contextmanager
def use_streams(streams):
    """Context in which each stream of a task (task_streams) is its
    device's current stream, so that a copy between two devices is ordered
    on both; nothing to enter for None."""
    with contextlib.ExitStack() as stack:
        for s in streams or ():
            stack.enter_context(torch.cuda.stream(s))
        yield

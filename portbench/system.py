"""The system under test, phyngsc_tpu_torch, as the benchmark drives it.

This is the one module of the benchmark that imports the program. It
loads the port's CUDA library and host runtime, makes the CodecConfig of
a configuration file, calls the in-memory entry points, and reads the
program's own counters: graphs.stats() and the stage sink of
pipeline/subblock.py (PHYNGSC_TIMING). For the stage sink it wraps the
one function every stage label and byte count goes through, so that
each label becomes a span with its thread and its end on the host clock
(the sink itself keeps only sums).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from phyngsc_tpu_torch import graphs, host_runtime, kernels
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes


def load(device: str) -> None:
    """Build (on a checkout's first run) and load the host runtime and, for
    a CUDA device, the kernel library, both under the checkout's build/."""
    host_runtime.ensure()
    if device.startswith("cuda"):
        kernels.build()


def codec_config(fields: dict) -> CodecConfig:
    """A CodecConfig of the configuration file's "codec" fields; a field
    the program does not have raises."""
    names = {f.name for f in dataclasses.fields(CodecConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"CodecConfig has no field {sorted(unknown)}")
    return CodecConfig(**fields)


def compress(data: bytes, cfg: CodecConfig, n_writers: int, device) -> bytes:
    return compress_bytes(data, cfg, n_writers=n_writers, device=device)


def decompress(blob: bytes, cfg: CodecConfig, device) -> bytes:
    return decompress_bytes(blob, cfg, device=device)


def graph_stats() -> dict:
    return graphs.stats()


class StageSpans:
    """While entered: the program's stage sink on (PHYNGSC_TIMING), and
    every stage label recorded as (label, thread id, start, end) on
    time.perf_counter, every byte count as (key, bytes, time)."""

    def __init__(self):
        self.spans, self.counts = [], []
        self._lock = threading.Lock()

    def _record(self, key: str, value: float) -> None:
        now = time.perf_counter()
        with self._lock:
            if key.endswith("_bytes"):
                self.counts.append((key, value, now))
            else:
                self.spans.append((key, threading.get_ident(), now - value,
                                   now))
        self._add(key, value)

    def __enter__(self):
        self._env = os.environ.get("PHYNGSC_TIMING")
        os.environ["PHYNGSC_TIMING"] = "1"
        self._add = subblock._add
        subblock._add = self._record
        return self

    def __exit__(self, *exc):
        subblock._add = self._add
        if self._env is None:
            os.environ.pop("PHYNGSC_TIMING", None)
        else:
            os.environ["PHYNGSC_TIMING"] = self._env

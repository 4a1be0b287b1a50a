"""The end-to-end metrics the harness takes itself on the host: times on
its clock, and the bytes the program returned to it."""

from __future__ import annotations


def _rate(run, kind: str):
    calls = run.calls_of(kind)
    seconds = sum(c.t1 - c.t0 for c in calls)
    if not calls or seconds <= 0:
        return None
    return sum(c.fastq_bytes for c in calls) / seconds / 1e6


def _stored(run):
    calls = run.calls_of("compress")
    if not calls:
        return None
    return (sum(len(c.out) for c in calls)
            / sum(c.fastq_bytes for c in calls))


def read(name: str, run):
    """setup_s: process start to the window's start (the cold and warm
    round trips in it); compress_MBps / decompress_MBps: all FASTQ bytes
    of the window's calls of that kind (MB = 10^6 bytes) over the sum of
    their wall seconds; stored_bytes_per_byte: the bytes of the containers
    that the window's compress calls returned over their FASTQ bytes."""
    if name == "setup_s":
        return run.setup_s
    if name == "stored_bytes_per_byte":
        return _stored(run)
    if name == "compress_MBps":
        return _rate(run, "compress")
    if name == "decompress_MBps":
        return _rate(run, "decompress")
    return None

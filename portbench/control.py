"""The control and the faults that `correct` must catch, and their runs.

The control breaks the configuration's guarantee, a lossless round trip,
in the way that would tempt a faster or smaller codec: qualities binned
to Illumina's eight levels before compressing (a lossy quality mode). The
faults break the timed path under the harness:

- stale: each call returns what the previous call of its kind returned
  (a step that returns its state unchanged);
- half: each call works on half of the records and drops the rest;
- altered: one quality byte is altered where each answer is produced.

(With one card there is no exchange between cards to leave out.)

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
                                 --seconds <s> [--mode control|stale|...]

runs the cell once a seed in one process with the mode's break in place
and prints each run's checks as a JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

#: Illumina's eight-level quality binning (phred -> the bin's value)
_BINS = [(0, 2, 2), (2, 10, 6), (10, 20, 15), (20, 25, 22), (25, 30, 27),
         (30, 35, 33), (35, 40, 37), (40, 94, 40)]
BIN = np.arange(256, dtype=np.uint8)
for _lo, _hi, _to in _BINS:
    BIN[33 + _lo:33 + _hi] = 33 + _to


def _quality_mask(buf: np.ndarray) -> np.ndarray:
    """The bytes of each record's quality line (the fourth line)."""
    line = np.cumsum(buf == 10) - (buf == 10)  # the line each byte is on
    return (line % 4 == 3) & (buf != 10)


def bin_qualities(data: bytes) -> bytes:
    buf = np.frombuffer(data, np.uint8).copy()
    m = _quality_mask(buf)
    buf[m] = BIN[buf[m]]
    return buf.tobytes()


def alter_one(data: bytes) -> bytes:
    """The input with its first quality byte changed."""
    buf = np.frombuffer(data, np.uint8).copy()
    at = np.flatnonzero(_quality_mask(buf))
    if at.size:
        buf[at[0]] = 33 + (buf[at[0]] - 33 + 1) % 40
    return buf.tobytes()


def first_half(data: bytes) -> bytes:
    """The first half of the records."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    n = nl.shape[0] // 4
    return data[:int(nl[4 * (n // 2) - 1]) + 1] if n >= 2 else data


MODES = ("control", "stale", "half", "altered")


@contextlib.contextmanager
def broken(mode: str):
    """The adaptor's compress and decompress with `mode`'s break."""
    from portbench import system
    comp, decomp = system.compress, system.decompress
    last = {}

    def compress(data, cfg, n_writers, device):
        if mode == "control":
            return comp(bin_qualities(data), cfg, n_writers, device)
        if mode == "half":
            return comp(first_half(data), cfg, n_writers, device)
        if mode == "altered":
            return comp(alter_one(data), cfg, n_writers, device)
        out = last.get("c") or comp(data, cfg, n_writers, device)
        last["c"] = out
        return out

    def decompress(blob, cfg, device):
        out = decomp(blob, cfg, device)
        if mode == "half":
            return first_half(out)
        if mode == "altered":
            return alter_one(out)
        if mode == "stale":
            prev = last.get("d", out)
            last["d"] = out
            return prev
        return out

    system.compress, system.decompress = compress, decompress
    try:
        yield
    finally:
        system.compress, system.decompress = comp, decomp


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=MODES, default="control")
    a = ap.parse_args(argv)
    for seed in a.seeds:
        with broken(a.mode):
            out = harness.run_cell(a.workload, seed, a.seconds, False)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "mode": a.mode,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

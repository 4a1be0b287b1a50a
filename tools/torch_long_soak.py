#!/usr/bin/env python3
"""Round trips of a benchmark cell's inputs, in turn, for a while in one
process, with the card's memory and the stage graphs' statistics after
each: the soak of the graph cache (phyngsc_tpu_torch/graphs.py).

    python3 tools/torch_long_soak.py --workload ont_na12878_long.roundtrip \
        --seed N --seconds 600 [--out FILE]

Makes the cell's inputs from the seed as portbench's harness does, then
compresses and decompresses them in turn (each decode checked against
its input) until the seconds have passed, and at least two round trips of
each input. One JSON line a round trip: its input, seconds, MB/s each
way, torch.cuda.memory_reserved() / memory_allocated() after it, and
graphs.stats()'s instances, graph_bytes, peak_bytes, largest_bytes,
evictions, freed_bytes, capture seconds, and per stage the captures and
distinct keys. The last line sums it up: the reserved memory after the
first two round trips (the warm process) and after the last, their
difference against the largest instance, the least the card had free,
the card's name and power limit. --device cpu with --tiny rehearses it
on the CPU at a small size (no memory numbers)."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY = {"params": {"reads_per_file": 12, "mu": 6.5}}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    _, config, traffic, _, _ = harness.cell(harness.benchmark(), a.workload)
    if a.tiny:
        config = harness._merge(config, TINY)
    from portbench import system
    import torch
    from phyngsc_tpu_torch import graphs

    cuda = a.device.startswith("cuda")
    system.load(a.device)
    gen = importlib.import_module(
        f"portbench.generators.{config['generator']}")
    inputs = [gen.generate(config["params"], a.seed, i)
              for i in range(int(traffic["inputs"]))]
    cfg = system.codec_config(config["codec"])
    rows = []
    free_least = None
    t_end = time.perf_counter() + a.seconds
    k = 0
    while time.perf_counter() < t_end or k < 2 * len(inputs):
        i = k % len(inputs)
        t0 = time.perf_counter()
        blob = system.compress(inputs[i], cfg, config["n_writers"], a.device)
        t1 = time.perf_counter()
        back = system.decompress(blob, cfg, a.device)
        t2 = time.perf_counter()
        st = graphs.stats()
        mb = len(inputs[i]) / 1e6
        row = {"trip": k, "input": i, "ok": back == inputs[i],
               "compress_s": t1 - t0, "decompress_s": t2 - t1,
               "compress_MBps": mb / (t1 - t0),
               "decompress_MBps": mb / (t2 - t1),
               "stored_bytes": len(blob), "fastq_bytes": len(inputs[i])}
        if cuda:
            free, total = torch.cuda.mem_get_info()
            free_least = free if free_least is None else min(free_least,
                                                             free)
            row.update(reserved=torch.cuda.memory_reserved(),
                       allocated=torch.cuda.memory_allocated(),
                       free=free, total=total)
        for name in ("instances", "graph_bytes", "peak_bytes",
                     "largest_bytes", "evictions", "freed_bytes",
                     "capture_s"):
            row[name] = st.get(name)
        row["stages"] = {s: {"captures": v["captures"], "keys": v["keys"]}
                         for s, v in st.items() if isinstance(v, dict)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        k += 1
    warm = rows[2 * len(inputs) - 1]
    out = {"workload": a.workload, "seed": a.seed, "trips": len(rows),
           "all_ok": all(r["ok"] for r in rows),
           "seconds": sum(r["compress_s"] + r["decompress_s"]
                          for r in rows)}
    if cuda:
        out.update(
            card=_card(), reserved_warm=warm["reserved"],
            reserved_last=rows[-1]["reserved"],
            reserved_most=max(r["reserved"] for r in rows[2 * len(inputs)
                                                           - 1:]),
            growth=rows[-1]["reserved"] - warm["reserved"],
            largest_bytes=rows[-1]["largest_bytes"],
            free_least=free_least, total=rows[-1]["total"],
            captures_after_warm=sum(
                v["captures"] for v in rows[-1]["stages"].values())
            - sum(v["captures"] for v in warm["stages"].values()))
    print(json.dumps(out), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "summary": out}, f)
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

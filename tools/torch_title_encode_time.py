"""Time the title codec's encode (models/title.py encode, the pool's
`t.encode` task) on the sub-blocks of the benchmark's two cells, for one
or more trees in turn, each in a process of its own:

    python3 tools/torch_title_encode_time.py --tree chip_ab/parent \\
        --tree . --tree . --tree chip_ab/parent --seed 3000021001 \\
        --out chiprun_out/title_encode.json

For each tree and cell: the ms of one encode of each sub-block (the
least and the median of --reps calls, one thread calling), and the wall
ms of encoding every sub-block --reps times on a pool of 8 Python threads
(as the compress pool runs it; a call that holds the GIL serialises
them). The inputs are the cells' own files for the seed (portbench's
generators; ERR cut to its first 200,000 records, whose sub-blocks are
the full file's first). Prints one JSON line a tree and cell, and writes
them all to --out. Runs on the CPU too; the numbers of interest are the
card's host's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import concurrent.futures, importlib, json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
sys.path.insert(1, ROOT)
import numpy as np
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import title
from phyngsc_tpu_torch.pipeline import compress, subblock

def blocks(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        spec = json.load(f)
    gen = importlib.import_module("portbench.generators." + spec["generator"])
    params = dict(spec["params"])
    if "records_per_file" in params:
        params["records_per_file"] = min(params["records_per_file"], 200000)
    data = gen.generate(params, SEED, 0)
    buf = np.frombuffer(data, np.uint8)
    cfg = compress.resolve_substream(buf, CodecConfig(**spec["codec"]))
    out = []
    for _, idx in compress.iter_subblock_tasks(
            buf, compress.partition_regions(buf, 1, cfg), cfg):
        tl = (idx.title_end - idx.title_start).astype(np.int32)
        out.append((subblock._gather_matrix(
            buf, idx.title_start, tl.astype(np.int64), int(tl.max())), tl))
    return cfg, out

for name in ("ont_na12878_long", "err005195_ga36"):
    cfg, subs = blocks(name)
    title.encode(*subs[0], cfg)  # the runtime's build and load
    per = []
    for t, tl in subs:
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            title.encode(t, tl, cfg)
            ms.append((time.perf_counter() - t0) * 1e3)
        per.append((min(ms), statistics.median(ms)))
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        t0 = time.perf_counter()
        list(ex.map(lambda s: title.encode(s[0], s[1], cfg), subs * REPS))
        pool_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "cell": name, "sub_blocks": len(subs),
        "records": [int(t.shape[0]) for t, _ in subs],
        "ms_min": [round(a, 4) for a, _ in per],
        "ms_median": [round(b, 4) for _, b in per],
        "ms_median_all": round(statistics.median(b for _, b in per), 4),
        "pool8_ms": round(pool_ms, 3), "pool8_encodes": len(subs) * REPS}),
        flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout to time, in turn (repeat)")
    ap.add_argument("--seed", type=int, default=3000021001)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    code = (f"ROOT = {ROOT!r}\nSEED = {a.seed}\nREPS = {a.reps}\n" + CHILD)
    rows = []
    for i, tree in enumerate(a.tree):
        res = subprocess.run([sys.executable, "-c", code],
                             cwd=os.path.abspath(tree), capture_output=True,
                             text=True, timeout=1800)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        for line in res.stdout.splitlines():
            row = {"turn": i, "tree": tree, **json.loads(line)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Round trips and the wire's bytes of several trees of the port, on one card.

    python3 tools/torch_wire_ab.py TREE [TREE ...] [--mb 256] [--reps 3]

Each TREE (a checkout of the repo, e.g. the parent unpacked with git archive
into the git-ignored chip_ab/parent, or `.`) runs in a child process of its
own, in the order given (parent, change, change, parent compares two trees
in turns): it builds its kernels and its host runtime, makes the ERR005195
36 bp corpus of chip_smoke.py (synthesize_fastq, seed 5, about --mb MB),
runs one untimed round trip (compress_bytes -> decompress_bytes on cuda,
byte-identical), then --reps timed ones, then one under PHYNGSC_TIMING=1;
then times stage A of the corpus's first sub-block alone (stage_a and a
synchronize, the median of --reps + 2 calls) and, where the tree has
ops/transfer, its host packers on that sub-block's planes. Prints one JSON
line a tree (its MB/s, the stage split and the h2d / d2h bytes of both
directions, the container's bytes, those host times in ms) and then the
card's name and power limit as nvidia-smi gives them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time


def one(tree: str, mb: float, reps: int) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    sys.modules["jax"] = None  # the port never imports jax ...
    sys.modules["phyngsc_tpu"] = None  # ... nor the JAX package
    import torch

    from phyngsc_tpu_torch import CodecConfig, host_runtime, kernels
    from phyngsc_tpu_torch.pipeline import subblock
    from phyngsc_tpu_torch.pipeline.compress import compress_bytes
    from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
    from phyngsc_tpu_torch.utils.fastq import synthesize_fastq

    if not torch.cuda.is_available():
        raise SystemExit("torch_wire_ab: needs a CUDA card")
    import phyngsc_tpu_torch

    assert os.path.dirname(os.path.dirname(phyngsc_tpu_torch.__file__)) == tree
    host_runtime.ensure()
    kernels.build()
    per_rec = len(synthesize_fastq(1000, read_len=36, seed=5)) / 1000
    data = synthesize_fastq(int(mb * 1e6 / per_rec), read_len=36, seed=5)
    dev = torch.device("cuda")
    cfg = CodecConfig()

    def round_trip():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress_bytes(data, cfg, 1, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = decompress_bytes(blob, cfg, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != data:
            raise SystemExit(f"torch_wire_ab: {tree}: round trip differs")
        return blob, len(data) / 1e6 / (t1 - t0), len(data) / 1e6 / (t2 - t1)

    blob, _, _ = round_trip()
    runs = [round_trip()[1:] for _ in range(reps)]
    os.environ["PHYNGSC_TIMING"] = "1"
    try:
        compress_bytes(data, cfg, 1, device=dev)
        enc = dict(subblock.TIMING)
        decompress_bytes(blob, cfg, device=dev)
        dec = dict(subblock.TIMING)
    finally:
        del os.environ["PHYNGSC_TIMING"]
    return {**first_subblock_ms(data, cfg, dev, reps + 2),
            "tree": tree, "input_bytes": len(data),
            "container_bytes": len(blob),
            "compress_mbps": [r[0] for r in runs],
            "decompress_mbps": [r[1] for r in runs],
            "compress_timing": enc, "decompress_timing": dec}


def first_subblock_ms(data: bytes, cfg, dev, reps: int) -> dict:
    """Median host ms of stage A of data's first sub-block, as
    compress_bytes cuts it, with a synchronize after it; and of the tree's
    host packers (ops/transfer) on that sub-block's gathered planes."""
    import numpy as np
    import torch

    from phyngsc_tpu_torch.pipeline import compress, subblock

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    buf = np.frombuffer(data, np.uint8)
    cfg = compress.resolve_substream(buf, cfg)
    regions = compress.partition_regions(buf, 1, cfg)
    _, idx = next(compress.iter_subblock_tasks(buf, regions, cfg))

    def stage_a():
        subblock.stage_a(buf, idx, cfg, dev)
        torch.cuda.synchronize()

    out = {"stage_a_ms": median_ms(stage_a)}
    try:
        transfer = importlib.import_module("phyngsc_tpu_torch.ops.transfer")
    except ImportError:
        return out
    lens = idx.seq_len.astype(np.int64)
    L = int(lens.max())
    seq = subblock._gather_matrix(buf, idx.seq_start, lens, L)
    qual = subblock._gather_matrix(buf, idx.qual_start, lens, L)
    out["pack_seq_ms"] = median_ms(lambda: transfer.pack_seq_np(seq))
    out["pack_qual_ms"] = median_ms(lambda: transfer.pack_qual_np(qual))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--mb", type=float, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.mb, args.reps)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--mb", str(args.mb), "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=1800)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

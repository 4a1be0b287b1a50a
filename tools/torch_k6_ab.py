#!/usr/bin/env python3
"""K6, the decode's table build, of several trees of the port on one card.

    python3 tools/torch_k6_ab.py TREE [TREE ...] [--reps 200]

Each TREE (a checkout of the repo, e.g. the parent unpacked with git archive
into the git-ignored chip_ab/parent, or `.`) runs in a child process of its
own, in the order given (parent, change, change, parent compares two trees
in turns). The child builds the tree's kernels, cuts the first sub-block of
each of chip_smoke.py's K6 corpora with the tree's own chip_smoke.py
(FirstSubblock: ERR005195 36 bp, 1000 bp, variable 100 bp, SRR-style 76 bp
with Huffman DNA, 65,532 bp reads), uploads each stream's code lengths as
the decode does (subblock.decode_wires, subblock._upload_together) and
builds the tables of each case the tree's way: tables.walk_luts_both
where the tree has it (both streams in one launch), else one
tables.walk_luts a stream. For each case it prints the K6 launches a
build, the device ms a build (torch.profiler, the kernel alone, summed
over the build's launches), the CUDA-event ms of one build (host work
included), the calling thread's ms of one build (host clock, the median of
single calls; the launches queue behind each other) and the plain
version's event ms; then the empty kernel's device
ms at 1 block and at a block an SM, where the tree has it. One JSON line a
tree, then the card's name and power limit as nvidia-smi gives them.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def one(tree: str, reps: int) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from phyngsc_tpu_torch import kernels, synthesize_fastq
    from phyngsc_tpu_torch.ops import tables
    from phyngsc_tpu_torch.pipeline import subblock

    assert os.path.dirname(os.path.abspath(cs.__file__)) == tree
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_ab: needs a CUDA card")
    kernels.build()
    dev = torch.device("cuda")
    bits = cs.CodecConfig().max_code_len
    both = getattr(tables, "walk_luts_both", None)
    blocks = {
        "ERR": cs.FirstSubblock(synthesize_fastq(70000, read_len=36, seed=1),
                                dev),
        "1000 bp": cs.FirstSubblock(synthesize_fastq(5000, read_len=1000,
                                                     seed=4), dev),
        "variable 100 bp": cs.FirstSubblock(synthesize_fastq(
            40000, read_len=100, seed=3, variable_length=True), dev),
        "SRR": cs.FirstSubblock(cs.srr_huffman_corpus(40000, seed=2), dev),
        "65,532 bp": cs.FirstSubblock(cs.long_read_corpus(16, seed=11), dev),
    }

    def wires(name):
        b = blocks[name]
        return subblock.decode_wires(b.p, b.cfg)

    err = blocks["ERR"].p
    lens, sing = err.q_tables.lens.copy(), err.q_tables.singletons.copy()
    lens[::3], sing[::3] = 0, 40 + np.arange(lens[::3].shape[0])
    cases = {
        "ERR quality, 36 trees": wires("ERR")[:1],
        "1000 bp quality, 128 trees": wires("1000 bp")[:1],
        "variable 100 bp quality, 100 trees": wires("variable 100 bp")[:1],
        "DNA huffman, 1 tree": wires("SRR")[1:],
        "SRR sub-block: quality + DNA huffman": wires("SRR"),
        "ERR quality, every third tree a singleton": [
            tables.lens_wire(lens, sing, bits, max(err.Lt, 1))],
        "65,532 bp quality, 128 trees, shared block":
            wires("65,532 bp")[:1],
    }
    rows = []
    for name, ws in cases.items():
        pieces = [(w, *subblock._upload_together(w.pieces(), dev))
                  for w in ws]

        def build():
            if both is not None:
                return both(*pieces)
            return [tables.walk_luts(*x) for x in pieces]

        def plain():
            return [tables.walk_luts_plain(*x) for x in pieces]

        got, want = build(), plain()
        for g, w in zip(got, want):
            if not (torch.equal(g.full, w.full)
                    and torch.equal(g.packed, w.packed)):
                raise SystemExit(f"torch_k6_ab: {tree}: {name}: K6 differs "
                                 "from its plain version")
        torch.cuda.synchronize()
        before = kernels.LAUNCHES["k6_tables"]
        build()
        launches = kernels.LAUNCHES["k6_tables"] - before
        rows.append({"case": name, "trees": [w.n_trees for w in ws],
                     "launches": launches,
                     "device_ms": cs.device_ms(build, reps, "tables_kernel"),
                     "event_ms": cs.cuda_ms(build, reps),
                     "host_ms": cs.host_ms(build, reps),
                     "plain_ms": cs.cuda_ms(plain, 5)})
    floor = {}
    if hasattr(kernels, "empty_launch"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for n in (1, sms):
            floor[n] = cs.device_ms(lambda n=n: kernels.empty_launch(dev, n),
                                    reps, "empty_kernel")
    return {"tree": tree, "cases": rows, "empty_kernel_device_ms": floor}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0], args.reps)), flush=True)
        return 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--reps", str(args.reps)], capture_output=True, text=True,
            cwd=tree)
        lines = out.stdout.strip().splitlines()
        if out.returncode or not lines:
            print(out.stdout + out.stderr, file=sys.stderr)
            raise SystemExit(f"torch_k6_ab: {tree} failed")
        print(lines[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

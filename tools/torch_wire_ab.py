#!/usr/bin/env python3
"""Round trips and the wire's bytes of several trees of the port, on one card.

    python3 tools/torch_wire_ab.py TREE[@T] [TREE[@T] ...] [--mb 256] [--reps 3]

Each TREE (a checkout of the repo, e.g. the parent unpacked with git archive
into the git-ignored chip_ab/parent, or `.`; `@T` sets the host runtime's
threads T, for a tree that has the port's own runtime) runs in a child
process of its own, in the order given (parent, change, change, parent
compares two trees in turns): it builds its kernels and its host runtime
(and notes the runtime's library and T), makes the ERR005195 36 bp corpus
of chip_smoke.py (synthesize_fastq, seed 5, about --mb MB), runs one
untimed round trip (compress_bytes -> decompress_bytes on cuda,
byte-identical), then --reps timed ones (for a tree with the stages'
CUDA graphs, each call's seconds and graphs.stats() of its compress and
its decompress are kept: the first call's captures, the later calls'
replays), then one under PHYNGSC_TIMING=1,
then one compress and one decompress under torch.profiler (CPU and CUDA
activities), read by this tool's own tools/trace_activity.py
device_activity (loaded from its file, since the tree measured may predate
it) from the Chrome
trace: the card's busy share over each call's wall (the union of its
kernel, copy and memset intervals), the calling thread's time in CPU ops,
and the seconds the calling thread spent in cudaStreamSynchronize /
cudaEventSynchronize / cudaDeviceSynchronize, by enclosing op; then times
stage A of the corpus's first sub-block alone (stage_a and a
synchronize, the median of --reps + 2 calls) and, where the tree has
ops/transfer, its host packers on that sub-block's planes; and a cProfile
of the calling thread over one more compress and decompress (the
package's functions by cumulative seconds). Prints one JSON
line a tree (its MB/s, the stage split and the h2d / d2h bytes of both
directions, the container's bytes, those host times in ms), then one line
of each tree's turns pooled (medians and quartiles), then the card's name
and power limit as nvidia-smi gives them. Needs a CUDA card.

    python3 tools/torch_wire_ab.py --summary LOG

prints that pooled summary again from a saved run's output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_activity():
    """tools/trace_activity.py device_activity of this tool's own tree."""
    spec = importlib.util.spec_from_file_location(
        "_trace_activity", os.path.join(HERE, "tools", "trace_activity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_activity


def one(tree: str, mb: float, reps: int) -> dict:
    label = tree
    tree, _, threads = tree.partition("@")
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

    from phyngsc_tpu_torch.utils import native

    assert os.path.dirname(os.path.dirname(phyngsc_tpu_torch.__file__)) == tree
    # the host runtime's build step: a tree of the port's own runtime gives
    # its library's path and its thread count T; an older tree, which built
    # native/ without OpenMP on this host, a bool and one thread
    host_lib = host_runtime.ensure()
    if threads:
        native.set_threads(int(threads))
    host_threads = native.threads() if hasattr(native, "threads") else 1
    kernels.build()
    per_rec = len(synthesize_fastq(1000, read_len=36, seed=5)) / 1000
    data = synthesize_fastq(int(mb * 1e6 / per_rec), read_len=36, seed=5)
    dev = torch.device("cuda")
    cfg = CodecConfig()

    try:  # a tree with the stages' CUDA graphs
        graphs = importlib.import_module("phyngsc_tpu_torch.graphs")
    except ImportError:
        graphs = None
    calls = []  # each round trip's seconds and graph statistics

    def round_trip():
        if graphs is not None:
            graphs.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress_bytes(data, cfg, 1, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        enc = graphs.stats() if graphs is not None else None
        if graphs is not None:
            graphs.reset_stats()
        back = decompress_bytes(blob, cfg, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != data:
            raise SystemExit(f"torch_wire_ab: {tree}: round trip differs")
        calls.append({"compress_s": t1 - t0, "decompress_s": t2 - t1,
                      "graphs": enc and {
                          "compress": enc, "decompress": graphs.stats()}})
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
    from torch.profiler import ProfilerActivity, profile, record_function

    activity, profiled = device_activity(), {}
    trace = os.path.join(HERE, "build", "torch_wire_ab_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for side, call in (
            ("compress", lambda: compress_bytes(data, cfg, 1, device=dev)),
            ("decompress", lambda: decompress_bytes(blob, cfg, device=dev))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(f"ab.{side}"):
                call()
                torch.cuda.synchronize()
        profiled[side] = activity(prof, f"ab.{side}", trace)
        os.remove(trace)
    return {**first_subblock_ms(data, cfg, dev, reps + 2),
            "calling_thread": calling_thread(data, blob, cfg, dev),
            "tree": label, "host_runtime": host_lib,
            "host_threads": host_threads, "cpu_count": os.cpu_count(),
            "input_bytes": len(data),
            "container_bytes": len(blob),
            "compress_mbps": [r[0] for r in runs],
            "decompress_mbps": [r[1] for r in runs],
            "compress_timing": enc, "decompress_timing": dec,
            "profiled": profiled, "calls": calls}


def calling_thread(data: bytes, blob: bytes, cfg, dev, top: int = 25) -> dict:
    """cProfile of the calling thread (the pool's threads are not
    profiled) over one compress and one decompress: the `top` functions of
    the tree's package by cumulative seconds, as "file:line name" ->
    [seconds, calls]."""
    import cProfile
    import pstats

    import torch

    from phyngsc_tpu_torch.pipeline.compress import compress_bytes
    from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes

    out = {}
    for side, call in (
            ("compress", lambda: compress_bytes(data, cfg, 1, device=dev)),
            ("decompress", lambda: decompress_bytes(blob, cfg, device=dev))):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        call()
        torch.cuda.synchronize()
        prof.disable()
        rows = [(ct, nc, f"{os.path.relpath(fn, HERE)}:{line} {name}")
                for (fn, line, name), (_, nc, _, ct, _)
                in pstats.Stats(prof).stats.items()
                if "phyngsc_tpu_torch" in fn]
        out[side] = {k: [round(ct, 4), nc]
                     for ct, nc, k in sorted(rows, reverse=True)[:top]}
    return out


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
        st = subblock.stage_a(buf, idx, cfg, dev)
        torch.cuda.synchronize()
        if getattr(st, "lease", None) is not None:  # a tree with graphs
            st.lease.release()

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


def summary(results: list) -> dict:
    """Each tree's turns pooled: the median and quartiles of its compress
    and decompress MB/s, its stage A and packer ms, and the median of each
    stage-split key."""
    out = {}
    for tree in dict.fromkeys(r["tree"] for r in results):
        mine = [r for r in results if r["tree"] == tree]
        row = {"turns": len(mine)}
        for key in ("compress_mbps", "decompress_mbps"):
            runs = sorted(x for r in mine for x in r[key])
            q = statistics.quantiles(runs, n=4) if len(runs) > 1 else runs * 3
            row[key] = {"median": statistics.median(runs), "q1": q[0],
                        "q3": q[2], "runs": len(runs)}
        for key in ("stage_a_ms", "pack_seq_ms", "pack_qual_ms"):
            if all(key in r for r in mine):
                row[key] = [r[key] for r in mine]
        for side in ("compress_timing", "decompress_timing"):
            row[side] = {k: statistics.median(r[side][k] for r in mine)
                         for k in mine[0][side]}
        if all("profiled" in r for r in mine):
            for key in ("busy_share", "calling_op_s", "wall_s"):
                row[key] = {side: [r["profiled"][side][key] for r in mine]
                            for side in ("compress", "decompress")}
        out[tree] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--mb", type=float, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--summary", metavar="LOG",
                    help="print the summary of the JSON lines a run of this "
                         "tool printed (its output, saved to LOG)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.mb, args.reps)), flush=True)
        return 0
    if args.summary:
        with open(args.summary) as f:
            results = [json.loads(line) for line in f
                       if line.startswith('{"stage_a_ms"')]
        print(json.dumps(summary(results), indent=1))
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    results = []
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--mb", str(args.mb), "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=1800)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        print(line, flush=True)
    print(json.dumps({"summary": summary(results)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host cost of the port's K5 step as the decode takes it, on one GPU.

    python3 tools/torch_k5_host_profile.py [--calls 1000]

Run from the root of a checkout. Builds the first sub-block of a 36 bp
ERR005195-style corpus as chip_smoke does and uploads its quality words as
_decode_device does. Then, on a warm card:

1. bitpack.dense_words(words, lanes, Wmax, Sp), the decode's call on the
   uploaded lane table, --calls times under cProfile: its per-call split of
   the host time by function (tottime / calls, in microseconds). cProfile
   adds its own cost to each Python call, so its total exceeds the wall
   time; the shares are what it is for.
2. The pieces of the step and torch.gather (chip_smoke's library call for
   K5), each two ways: the CUDA-event time of one call between a
   synchronize and the next (median, as chip_smoke times a case) and the
   wall time a call over --calls calls in a row (host bound: the card
   finishes each launch sooner than the host issues the next). The pieces:
   bitpack.lane_table on the host table, its upload, the output's
   allocation, the bare launch (arguments ready) and the whole call.

Imports neither jax nor phyngsc_tpu.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import statistics
import sys
import time

sys.modules["jax"] = None
sys.modules["phyngsc_tpu"] = None
sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phyngsc_tpu_torch import CodecConfig, kernels, synthesize_fastq  # noqa: E402
from phyngsc_tpu_torch.ops import bitpack  # noqa: E402
from phyngsc_tpu_torch.pipeline import compress, subblock  # noqa: E402


def first_subblock(data: bytes, dev):
    buf = np.frombuffer(data, np.uint8)
    cfg = compress.resolve_substream(buf, CodecConfig())
    regions = compress.partition_regions(buf, 1, cfg)
    _, idx = next(compress.iter_subblock_tasks(buf, regions, cfg))
    b = subblock.stage_b(subblock.stage_a(buf, idx, cfg, dev), cfg)
    return cfg, subblock._decode_parse(subblock.stage_c(b, cfg), cfg)


def event_us(fn, reps: int = 200) -> float:
    """Median CUDA-event microseconds of one fn() call after a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def loop_us(fn, calls: int) -> float:
    """Wall microseconds a call over `calls` calls in a row."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = kernels.build()
    cfg, p = first_subblock(synthesize_fastq(70000, read_len=36, seed=1), dev)
    Wmax, Sp = bitpack.plane_geometry(p.q_sub, p.G, p.L, cfg.max_code_len)
    words = subblock._upload_words(p.q_words, dev)
    lanes = subblock._to_device(bitpack.lane_table(p.q_sub), dev)
    S, n = lanes.shape[1], words.shape[0]
    print(f"plane ({Wmax}, {Sp}), S={S}, N={n}", flush=True)

    def call():
        return bitpack.dense_words(words, lanes, Wmax, Sp)

    loop_us(call, args.calls)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.calls):
        call()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())
    print(f"cProfile of bitpack.dense_words: {total / args.calls * 1e6:.2f} "
          "us a call in all (tottime summed); by function, us a call:")
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])
    for (fname, line, func), (_, ncalls, tottime, _, _) in rows[:16]:
        where = f"{os.path.basename(fname)}:{line}" if line else fname
        print(f"  {tottime / args.calls * 1e6:8.2f}  "
              f"{ncalls // args.calls:>3}x {func} ({where})")

    start, sub = lanes[0], lanes[1]
    w = torch.arange(Wmax, device=dev)[:, None]
    src = start[None, :] + w
    index = torch.full((Wmax, Sp), n, dtype=torch.int64, device=dev)
    index[:, :S] = torch.where((w < sub[None, :]) & (src < n), src, n)
    padded = torch.cat([words, words.new_zeros(1)])
    out = words.new_empty((Wmax, Sp))
    stream = torch.cuda.current_stream().cuda_stream
    launch_args = (words.data_ptr(), n, lanes.data_ptr(), S, Wmax, Sp,
                   out.data_ptr(), stream)
    pieces = {
        "nothing (the event pair alone)": lambda: None,
        "bitpack.lane_table (host)": lambda: bitpack.lane_table(p.q_sub),
        "its upload (_to_device)": lambda: subblock._to_device(
            bitpack.lane_table(p.q_sub), dev),
        "words.new_empty of the plane": lambda: words.new_empty((Wmax, Sp)),
        "the launch (ctypes, arguments ready)": lambda: lib.phyngsc_densify(
            *launch_args),
        "bitpack.dense_words (the decode's call)": call,
        "torch.gather as chip_smoke's library_ms": lambda: torch.gather(
            padded, 0, index.view(-1)).view(Wmax, Sp),
    }
    print("us a call: CUDA event (one call after a synchronize, median) | "
          f"wall ({args.calls} calls in a row)")
    for name, fn in pieces.items():
        print(f"  {event_us(fn):8.2f} | {loop_us(fn, args.calls):8.2f}  "
              f"{name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (phyngsc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mb 256]

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA / nvcc
     versions, the host's CPUs (os.cpu_count(), the process's affinity) and
     the host runtime's threads T, its library (build/host/, built by
     host_runtime.ensure(), which must succeed) and build seconds, and the
     kernels' build time;
  2. each hand-written kernel (K1 histogram, K2 uniform walk, K3 masked walk
     in its plain2, Huffman and per-position-tree quality variants, K4 code
     lookup on the (T, A) tables and tree ids stage B uploads, K5 densify)
     against its plain PyTorch version on the card, on the inputs the
     pipeline gives it for one default 8 MiB sub-block (36 bp, 100 bp
     variable-length and 1000 bp reads, K5 and K3 on lanes past 2^16
     words, and K2, K3 and K4 on 65,532 bp reads whose 128 quality trees
     leave some prefixes no room in shared memory, the walks of the last
     two against the sub-block's own quality symbols, since the plain walk
     would take minutes; the walks on the word plane K5 builds, with the
     two-level shared-memory tables the decode builds); K6 (the decode's
     walk tables from code lengths) on the quality tables of the 36 bp,
     1000 bp, variable 100 bp and 65,532 bp sub-blocks (the last with the
     shared block of escapes), the SRR corpus's Huffman DNA table, its
     quality and DNA tables in one launch, and the 36 bp trees with every
     third a singleton: its full LUTs and two-level tables;
     K5 also on lane tables of 16,384 and 131,072 lanes (G = 8 and
     G = 1 over short reads); results must be exactly equal; times are
     CUDA-event medians of one call, each call timed alone after a
     synchronize. Beside each case: library_ms, one PyTorch call computing
     the same function (torch.bincount for K1, advanced indexing for K4,
     torch.gather for K5, none for the walks and K6), checked equal too and timed
     the same way, and bound_ms, the least time the card could take (bytes
     read once and written once at 3.35 TB/s, or the operations at
     67 T/s, whichever is larger), with the walks' chain floor (their
     longest lane's steps at one shared-memory load each); then the launch
     floor: an empty kernel at 1 block and at a block an SM, timed the same
     way (its device time in phase 6), the least a launch of K5 or K6
     takes;
  2b. the host runtime (phyngsc_tpu_torch/native/host_runtime.cpp on the
     card's host): one default ERR005195 sub-block compressed and
     decompressed on the card, recording each host stage the main path
     runs (index, gather, packers, table build, title encode and decode,
     the decode's tail, reassembly); each stage again at T threads, at 1
     thread and on the numpy versions (PHYNGSC_NO_NATIVE=1), outputs equal;
     each of the 14 entry points' own calls of that run at T and at 1
     thread, equal; the ms of each;
  3. the main path: compress_bytes -> decompress_bytes with device="cuda" on
     --mb MB of synthetic ERR005195 36 bp reads, an SRR-style 76 bp corpus
     whose DNA stream is Huffman-coded, variable-length 100 bp reads,
     1000 bp reads, SOLiD colour-space reads, variable 5.4 kbp reads whose
     lanes hold more than 2^16 words and 65,532 bp reads, each
     byte-identical, with
     every kernel variant launched, K5 twice per decoded sub-block, K6
     once per decoded sub-block (the decode builds both streams' tables on
     the card from the code lengths in one launch), and no plain version
     run on a CUDA tensor; each corpus's wire modes are
     printed (the sub-blocks' upload packing of DNA and quality, and their
     decode fetch: qual8, restored symbols at w bits, or raw planes);
  4. the file entry points: compress_file -> decompress_file of the
     ERR005195 corpus on disk, byte-identical, with every kernel of the path
     launched in that run, then `python3 -m phyngsc_tpu_torch verify FILE
     --device cuda` in a child process, which must exit 0;
  4b. the sharded and multi-process paths: the ERR005195 corpus at
     data_shards=2 on [cuda:0, cuda:0], byte-identical and with phase 3's
     1-shard container, every kernel launched once per shard per sub-block
     (K1 and K5 twice; K6 builds each shard's tables on its device, one
     launch a shard a sub-block), and
     variable-length 100 bp reads at data_shards=3
     (an odd lane split); then `python3 -m
     phyngsc_tpu_torch.parallel.distributed` as two processes on the card
     (gloo metadata), compress and --decompress of the ERR file, each
     process's log naming the port's library under build/host/ as the one
     it loaded, and the single-process decompress_file of their container;
     then one more ERR
     round trip under PHYNGSC_TIMING=1, whose stage split and h2d/d2h byte
     counts are printed and held to the packed wire's limits (at the
     default 264 MB, scaled above it: compress h2d <= 88 MB and d2h <=
     65 MB, decompress d2h <= 100 MB, decompress h2d <= 1.05x the
     container);
  5. the committed golden containers tiny_v1 / tiny_v2 / titles_v3 /
     longread_v4 decode to their inputs, and the titles_v3 input re-encodes
     to phyngsc_tpu's bytes (by SHA-256);
  5a. the JAX package's fuzz contract on the card: the first 60 of
     tests/test_fuzz.py's bit flips of its 2-writer container, each
     decoded on the card with the CPU's outcome (the input back, or the
     same ValueError / EOFError; any other exception fails), then a clean
     ERR round trip in the same process;
  5b. the asynchronous execution (device.py: task streams, pinned
     staging, fetches on events): an upload of a stage-A-sized staging
     buffer returns in under 5 ms while a sleep of tens of ms runs ahead
     of its copy on its stream, and a fetch returns while a longer sleep
     still runs on another task's stream, each with the right bytes and
     its ms printed; the ERR round trip under
     torch.cuda.set_sync_debug_mode("error") (no blocking copy, .item() or
     synchronize on any thread), byte-identical and with phase 3's
     container; then one ERR compress and one ERR decompress under
     torch.profiler: the card's busy share over each call's wall (the
     union of its kernel, copy and memset intervals), the calling
     thread's seconds in CPU ops and in each synchronizing CUDA call, by
     enclosing op (utils/logging.py device_activity; phase 4b prints the
     stage split);
  6. each phase-2 kernel case's own device time from a torch.profiler trace,
     and the empty kernel's (last, so that the profiler cannot touch the
     timed round trips).
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts (`launches` phase 3's, `sharded_launches`
phase 4b's), errors, times and bounds (K5 and K6 also the launch floor's
device ms by block count). The script imports neither jax nor
phyngsc_tpu.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import logging
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must never import jax ...
sys.modules["phyngsc_tpu"] = None  # ... nor the JAX package

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phyngsc_tpu_torch import (CodecConfig, host_runtime, kernels,  # noqa: E402
                               synthesize_fastq)
from phyngsc_tpu_torch.models import dna, quality, title  # noqa: E402
from phyngsc_tpu_torch.ops import (bitpack, bitpack_host, histogram,  # noqa: E402
                                   lookup, tables, transfer)
from phyngsc_tpu_torch.pipeline import compress, subblock  # noqa: E402
from phyngsc_tpu_torch.pipeline.decompress import (  # noqa: E402
    decompress_bytes, decompress_file)
from phyngsc_tpu_torch.utils import bitio, native  # noqa: E402
from phyngsc_tpu_torch import device as devmod  # noqa: E402
from phyngsc_tpu_torch.utils.logging import device_activity  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
#: scratch files of the file phase, inside the checkout's git-ignored build/
FILE_DIR = os.path.join(ROOT, "build", "chip_smoke")
#: where host_runtime builds the port's host runtime
HOST_DIR = os.path.join(ROOT, "build", "host")
GOLDEN_CFG = CodecConfig(subblock_input_bytes=32 << 10,
                         records_per_substream=16)
#: SHA-256 of phyngsc_tpu's compress_bytes(titles_v3 input, GOLDEN_CFG, 2).
#: The committed titles_v3.ngsct came from an older encoder (before adaptive
#: quality-tree merging) that neither package reproduces, so the card's
#: encoder-parity check holds the port's re-encode against the JAX package's
#: current output; tests/test_torch_pipeline.py keeps this value true.
TITLES_V3_REENCODE_SHA256 = (
    "11a94458ebce76eab0bbb7e15684a16848898e85b48048a678ced0901c0c37b9")

KERNELS = {
    "k1_histogram": ("phyngsc_tpu_torch/csrc/histogram.cu",
                     "phyngsc_tpu/ops/histogram.py:37"),
    "k2_walk_uniform": ("phyngsc_tpu_torch/csrc/walk.cu",
                        "phyngsc_tpu/ops/bitpack.py:572"),
    "k3_walk_masked": ("phyngsc_tpu_torch/csrc/walk.cu",
                       "phyngsc_tpu/ops/bitpack.py:698"),
    "k4_lookup": ("phyngsc_tpu_torch/csrc/lookup.cu",
                  "phyngsc_tpu/ops/lookup.py:214"),
    "k5_densify": ("phyngsc_tpu_torch/csrc/densify.cu",
                   "phyngsc_tpu/ops/bitpack.py:870"),
    # the port of an XLA function, not of a pallas_call: the JAX package's
    # decode builds its tables on the device from the code lengths
    "k6_tables": ("phyngsc_tpu_torch/csrc/tables.cu",
                  "phyngsc_tpu/ops/bitpack.py:1081"),
}
#: each kernel's __global__ function, as torch.profiler names it
KERNEL_FN = {"k1_histogram": "hist_kernel",
             "k2_walk_uniform": "walk_uniform_kernel",
             "k3_walk_masked": "walk_masked_kernel",
             "k4_lookup": "lookup_kernel", "k5_densify": "densify_kernel",
             "k6_tables": "tables_kernel"}
#: the H100's memory rate, and the rate taken for the kernels' scalar
#: integer operations (its float32 peak outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: one step of a walk's dependent chain: one shared-memory load, about 30
#: cycles, at the H100's 1,980 MHz boost clock
STEP_S = 30 / 1.98e9
#: the packed wire's limits on the ERR005195 corpus at the default size
#: (264 MB, 35 sub-blocks), in bytes: compress h2d and d2h, decompress d2h;
#: decompress h2d is held to 1.05x the container
ERR_WIRE_LIMITS = {"compress h2d": 88e6, "compress d2h": 65e6,
                   "decompress d2h": 100e6}
ERR_DEFAULT_BYTES = 264e6
SEQ_MODES = {transfer.SEQ_RAW: "raw", transfer.SEQ_2BIT: "2-bit",
             transfer.SEQ_3BIT: "3-bit",
             transfer.SEQ_2BIT_EXC: "2-bit + exceptions"}
QUAL_MODES = {transfer.QUAL_RAW: "raw", transfer.QUAL_6BIT: "6-bit"}
#: the kernels (and K3 variants) that the ERR005195 36 bp path launches
ERR_PATH = ("k1_histogram", "k2_walk_uniform", "k3_walk_masked/plain2",
            "k4_lookup", "k5_densify", "k6_tables")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of fn() over reps runs (host work alone)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def device_ms(fn, reps: int, kernel_fn: str):
    """Mean device time per fn() call of the CUDA kernels named kernel_fn,
    from torch.profiler's trace of reps calls (the kernel alone, without the
    wrapper's host work that a CUDA-event pair around one call includes);
    None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if kernel_fn in e.key)
    return us / reps / 1e3 if us else None


def srr_huffman_corpus(n: int, seed: int) -> bytes:
    """SRR-style 76 bp reads whose leading N keeps a quality outside
    [33, 40], so the ambiguity cannot move into the quality stream
    (dna.py:118-120 of phyngsc_tpu) and the DNA stream is Huffman-coded."""
    lines = synthesize_fastq(n, read_len=76, style="SRR", seed=seed).split(b"\n")
    for i in range(1, len(lines) - 1, 4):
        if lines[i][:1] == b"N":
            lines[i + 2] = b"B" + lines[i + 2][1:]
    return b"\n".join(lines)


def solid_corpus(n: int, seed: int) -> bytes:
    """SOLiD colour-space reads of 50 characters: a nucleotide, then '0'-'3'
    colours (the sub-blocks take the delta translation)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq = (rng.integers(0, 4, size=(n, 50)) + ord("0")).astype(np.uint8)
    seq[:, 0] = acgt[rng.integers(0, 4, size=n)]
    qual = rng.integers(33, 64, size=(n, 50)).astype(np.uint8)
    return b"".join(b"@solid.%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(),
                                                   qual[i].tobytes())
                    for i in range(n))


def long_lane_corpus(n: int, seed: int) -> bytes:
    """A 100 bp read, then n reads of 5,300-5,500 bp with uniform bases and
    qualities: auto_substream sees only the first read and keeps G = 64, so
    a lane's quality stream outgrows 2^16 words."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = [100] + list(rng.integers(5300, 5501, size=n))
    return b"".join(
        b"@long.%d\n%s\n+\n%s\n" % (
            i, acgt[rng.integers(0, 4, size=m)].tobytes(),
            rng.integers(33, 127, size=m).astype(np.uint8).tobytes())
        for i, m in enumerate(lens))


def long_read_corpus(n: int, seed: int) -> bytes:
    """n reads of 65,532 bp, near the container's longest, with skewed
    qualities (Zipf) that drift along the read: adaptive merging keeps 128
    quality trees, too many for every escaped prefix to get a secondary
    block in the shared memory left beside 65,532 tree ids."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = 65532
    drift = np.arange(L) * 30 // L
    return b"".join(
        b"@lr.%d\n%s\n+\n%s\n" % (
            i, acgt[rng.integers(0, 4, size=L)].tobytes(),
            (33 + np.minimum(rng.zipf(1.5, size=L) - 1 + drift, 60)).astype(
                np.uint8).tobytes())
        for i in range(n))


def corpus_of(mb: float, build) -> bytes:
    """build(n) scaled to about mb MB."""
    per_rec = len(build(1000)) / 1000
    return build(int(mb * 1e6 / per_rec))


def titles_input() -> bytes:
    """The titles_v3 golden's input (tests/test_format_stability.py)."""
    rng = np.random.default_rng(4242)
    w = 1.0 / np.arange(1, 121) ** 1.3
    lanes = rng.choice(np.arange(1, 121), size=480, p=w / w.sum())
    out = bytearray()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(480):
        tile = 1101 + 97 * (i // 96)
        x = 5000 + 7 * (i % 96)
        title_b = b"@GLD3.%d %d:%d:%d len=36" % (i + 1, tile, x, lanes[i])
        seq = acgt[rng.integers(0, 4, size=36)]
        qual = rng.integers(35, 72, size=36).astype(np.uint8)
        out += title_b + b"\n" + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n"
    return bytes(out)


class FirstSubblock:
    """The first sub-block of `data` as compress_bytes cuts it (after
    resolve_substream): stage A's device planes, the K4 lookups that stage B
    made (symbols and tables, recorded as the kernel was called) and the
    parse of the payload. These are the main path's kernel inputs."""

    def __init__(self, data: bytes, dev):
        buf = np.frombuffer(data, np.uint8)
        self.cfg = compress.resolve_substream(buf, CodecConfig())
        self.G = self.cfg.records_per_substream
        regions = compress.partition_regions(buf, 1, self.cfg)
        _, idx = next(compress.iter_subblock_tasks(buf, regions, self.cfg))
        self.a = subblock.stage_a(buf, idx, self.cfg, dev)
        self.lookups = []
        launch = kernels.lookup

        def record(sym, tab, tree=None):
            self.lookups.append((sym.clone(), tab.clone(),
                                 None if tree is None else tree.clone()))
            return launch(sym, tab, tree)

        kernels.lookup = record
        try:
            b = subblock.stage_b(self.a, self.cfg)
        finally:
            kernels.lookup = launch
        self.p = subblock._decode_parse(subblock.stage_c(b, self.cfg),
                                        self.cfg)
        self.lens = subblock._record_lens(self.p.lens_np, self.p.Rp, dev)
        self.dev = dev

    def stream(self, which: str):
        """(linear words, lane table, Wmax, Sp) of the quality ("q") or DNA
        ("d") stream on the card, as the decode uploads them, and the host
        substream table."""
        p = self.p
        sub_np = p.q_sub if which == "q" else p.d_sub
        words = subblock._upload_words(p.q_words if which == "q"
                                       else p.d_words, self.dev)
        Wmax, Sp = bitpack.plane_geometry(sub_np, p.G, p.L,
                                          self.cfg.max_code_len)
        lanes = subblock._to_device(bitpack.lane_table(sub_np), self.dev)
        return (words, lanes, Wmax, Sp), sub_np

    def plane(self, which: str) -> torch.Tensor:
        """The stream's word plane, built by K5 as the decode builds it."""
        return bitpack.dense_words(*self.stream(which)[0])

    def describe(self, what: str) -> None:
        p = self.p
        print(f"{what} sub-block: R={p.R} Rp={p.Rp} Lt={p.Lt} L={p.L} "
              f"G={self.G} S={p.Rp // self.G} variable={p.variable} "
              f"delta={p.is_delta} quality trees={p.q_tables.n_trees} "
              f"dna mode={p.d_plan.mode} lookups="
              f"{[tuple(t.shape) for _, t, _ in self.lookups]}", flush=True)


def bound(nbytes: int, ops: int = 0) -> dict:
    """The least time the card could take for work that moves nbytes (each
    input read once, each output written once) and does ops operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(kernel: str, name: str, kernel_fn, plain_fn, reps: int,
            plain_reps: int, work: dict, library_fn=None, extra=None,
            join=None):
    """kernel_fn (a launch of `kernel`) against plain_fn on the card: exact
    equality, then the CUDA-event median of one call of each, and of
    library_fn (one PyTorch call of the same function, also held equal)
    where there is one, each timed alone. work: bound() of the case's
    inputs. join: one tensor of a kernel's several outputs, for the
    comparison only. The kernel's own device time comes
    later (phase_device_times), from `_probe`."""
    got = kernel_fn()
    ref = plain_fn()
    if join is not None:
        got, ref = join(got), join(ref)
    torch.cuda.synchronize()
    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
    require(err == 0, f"{name}: kernel differs from its plain version "
            f"(max abs err {err})")
    library_ms = None
    if library_fn is not None:
        lib = library_fn()
        require(torch.equal(lib.long(), ref.long()),
                f"{name}: the library call computes another function")
        library_ms = cuda_ms(library_fn, reps)
    case = {"case": name, "shape": list(got.shape), "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, reps),
            "plain_ms": cuda_ms(plain_fn, plain_reps) if plain_reps else None,
            "library_ms": library_ms, **work, **(extra or {})}
    print(f"kernel check: {json.dumps(case)}", flush=True)
    case["_probe"] = (kernel_fn, reps, KERNEL_FN[kernel])
    return case


def phase_device_times(cases: dict) -> None:
    """Fill each case's device_ms (profiler time of the kernel alone)."""
    for kernel_cases in cases.values():
        for case in kernel_cases:
            case["device_ms"] = device_ms(*case.pop("_probe"))
            print(f"device time: {case['case']}: {case['device_ms']} ms",
                  flush=True)


def full_lut_prefixes(wl) -> int:
    """Primary prefixes of a WalkLuts whose secondary block is all escapes,
    so that every lookup under them reads the full LUT in global memory."""
    if wl is None or wl.k == 0:
        return 0
    table = wl.packed.long() & 0xFFFF
    primary = table[:wl.n_primary]
    ids = primary[primary >= bitpack.ESCAPE] - bitpack.ESCAPE
    if ids.numel() == 0:
        return 0
    d = wl.lut_bits - wl.k
    blocks = table[wl.n_primary:wl.n_primary + ((int(ids.max()) + 1) << d)]
    flagged = (blocks >= bitpack.ESCAPE).reshape(-1, 1 << d).all(dim=1)
    return int(flagged[ids].sum())


def walk_work(words: int, lanes: int, tables, slot_bytes: int,
              steps: torch.Tensor) -> tuple:
    """(bound() of a walk, its chain floor): the lanes' words, their totals,
    the tables (packed and tree ids), the slot bytes read and written; the
    longest lane's steps at one shared-memory load each."""
    nbytes = 4 * words + 4 * lanes + slot_bytes
    if tables is not None:
        nbytes += 2 * tables.packed.numel()
    longest = int(steps.max()) if steps.numel() else 0
    return bound(nbytes), {"chain_floor_ms": longest * STEP_S * 1e3,
                           "longest_lane_steps": longest}


def phase_kernels(dev) -> dict:
    bits = CodecConfig().max_code_len
    cases = {k: [] for k in KERNELS}

    def k1(name, sym, mask, A):
        """mask: the bool mask as the caller holds it (the kernel reads its
        bytes in place)."""
        R, L = sym.shape
        ok = mask.bool() & (sym.long() < A)
        flat = torch.where(ok, torch.arange(L, device=dev) * A + sym.long(),
                           L * A).reshape(-1)
        cases["k1_histogram"].append(compare(
            "k1_histogram", name, lambda: kernels.histogram(sym, mask, A),
            lambda: histogram.position_histogram_plain(sym, mask, A), 100, 5,
            bound(2 * R * L + 4 * L * A, R * L),
            lambda: torch.bincount(flat, minlength=L * A + 1)[:L * A].view(
                L, A)))

    def k2(name, f, against_input=False, reps=20):
        """against_input: hold the walk against the sub-block's own quality
        symbols (lanes too long for the plain walk's Python loop)."""
        p, G = f.p, f.G
        S = p.q_sub.shape[0]
        plane = f.plane("q")
        totals = f.lens.reshape(S, G).sum(dim=1, dtype=torch.int32)
        luts = bitpack.walk_luts(p.q_tables.luts(bits), bits, dev, p.Lt)
        tid = quality.tree_of_position(torch.arange(p.Lt, device=dev),
                                       p.q_tables.n_trees, p.L).to(torch.int32)
        work, chain = walk_work(int(p.q_sub.sum()), S, luts,
                                S * G * p.L + 4 * p.Lt, totals)
        extra = {**chain, "k": luts.k, "n_trees": luts.n_trees,
                 "full_lut_prefixes": full_lut_prefixes(luts)}
        plain_fn, plain_reps = (
            lambda: bitpack.walk_uniform_plain(plane, totals, luts.full, tid,
                                               bits, G, p.Lt, p.L)), 3
        if against_input:
            truth = torch.where(quality.valid_mask(f.lens, p.L), f.a.qual_t,
                                0)
            plain_fn, plain_reps = (lambda: truth), 0
            extra["reference"] = "the sub-block's quality symbols"
        cases["k2_walk_uniform"].append(compare(
            "k2_walk_uniform", name,
            lambda: kernels.walk_uniform(plane, totals, luts, tid, G, p.Lt,
                                         p.L),
            plain_fn, reps, plain_reps, work, extra=extra))

    def k3(name, f, variant, against_input=False, reps=20):
        """variant: plain2 / huffman (DNA, after the quality decode) or
        quality (variable-length quality, per-position trees); against_input:
        hold the quality walk against the sub-block's own symbols (lanes too
        long for the plain walk's Python loop)."""
        p, G = f.p, f.G
        S = p.q_sub.shape[0]
        q_plane = f.plane("q")
        q_luts = p.q_tables.luts(bits)
        valid = quality.valid_mask(f.lens, p.L)
        if variant == "quality":
            plane, keep, sub = q_plane, valid, p.q_sub
            luts = bitpack.walk_luts(q_luts, bits, dev,
                                     kernels.masked_ids(p.L))
            tid = quality.tree_of_position(torch.arange(p.L, device=dev),
                                           p.q_tables.n_trees, p.L).to(
                                               torch.int32)
        else:
            if p.variable:
                qual_t = quality.decode_walk_masked(q_plane, f.lens, q_luts,
                                                    p.L, G, bits)
            else:
                qual_t = quality.decode_walk(q_plane, f.lens, q_luts, p.L,
                                             p.Lt, G, bits)
            keep = (qual_t < 128) & valid
            plane, sub = f.plane("d"), p.d_sub
            luts = (None if variant == "plain2" else
                    bitpack.walk_luts(p.d_plan.luts(bits), bits, dev))
            tid = (None if variant == "plain2" else
                   torch.zeros(1, dtype=torch.int32, device=dev))
        keep = keep.to(torch.uint8).reshape(S, -1).contiguous()
        tot = keep.sum(dim=1, dtype=torch.int32)
        plain2 = variant == "plain2"
        steps = -(-tot // 16) if plain2 else tot
        work, chain = walk_work(int(sub.sum()), S, luts, 2 * keep.numel(),
                                steps)
        extra = {**chain, "k": luts and luts.k,
                 "n_trees": luts and luts.n_trees,
                 "full_lut_prefixes": full_lut_prefixes(luts)}
        if against_input:
            truth = torch.where(valid, f.a.qual_t, 0).reshape(S, -1)
            plain_fn, plain_reps = (lambda: truth), 0
            extra["reference"] = "the sub-block's quality symbols"
        else:
            plain_fn, plain_reps = (
                lambda: bitpack.walk_masked_plain(
                    plane, keep, None if plain2 else luts.full, tid, bits,
                    plain2)), 3
        cases["k3_walk_masked"].append(compare(
            "k3_walk_masked", name,
            lambda: kernels.walk_masked(plane, tot, keep, luts, tid, plain2),
            plain_fn, reps, plain_reps, work, extra=extra))

    def k5_case(name, words, sub_np, Wmax, Sp):
        """bitpack.dense_words timed as _decode_device calls it, on the
        words and the lane table as uploaded; lane_table_ms, the host time
        of the lane table that the decode computes before its upload."""
        lanes = subblock._to_device(bitpack.lane_table(sub_np), dev)
        S, n = sub_np.shape[0], words.shape[0]
        start, sub = lanes[0], lanes[1]
        w = torch.arange(Wmax, device=dev)[:, None]
        src = start[None, :] + w
        src = torch.where((w < sub[None, :]) & (src < n), src, n)
        index = torch.full((Wmax, Sp), n, dtype=torch.int64, device=dev)
        index[:, :S] = src
        padded = torch.cat([words, words.new_zeros(1)])
        cases["k5_densify"].append(compare(
            "k5_densify", f"{name} ({Wmax}, {Sp})",
            lambda: bitpack.dense_words(words, lanes, Wmax, Sp),
            lambda: bitpack.dense_words_plain(words, lanes, Wmax, Sp),
            200, 10, bound(4 * int(sub_np.sum()) + 16 * S + 4 * Wmax * Sp),
            lambda: torch.gather(padded, 0, index.view(-1)).view(Wmax, Sp),
            extra={"lanes": S, "lane_table_ms": host_ms(
                lambda: bitpack.lane_table(sub_np), 200)}))

    def k5(name, f):
        for which in ("q", "d"):
            (words, _, Wmax, Sp), sub_np = f.stream(which)
            k5_case(f"{name} {which} plane", words, sub_np, Wmax, Sp)

    def k5_lanes(S, lane_words, seed):
        """A lane table of S lanes of 1..lane_words words and its words (the
        quality stream of G = 1 or 8 over short reads)."""
        rng = np.random.default_rng(seed)
        sub_np = rng.integers(1, lane_words + 1, size=S).astype(np.int32)
        words = torch.randint(-(1 << 31), 1 << 31, (int(sub_np.sum()),),
                              dtype=torch.int32, device=dev)
        Wmax, Sp = bitpack_host.dense_geometry(sub_np)
        k5_case(f"k5 {S} lanes", words, sub_np, Wmax, Sp)

    def k4(name, sym, tab, tree):
        """The library call: tab32[tree64[pos], sym64], the table widened
        to int32 with & 0xFFFF and padded with zeros to 256 symbols (so a
        symbol >= A reads 0), the tree ids as int64 (tree64[pos] is
        tree64[None, :])."""
        R, L = sym.shape
        T, A = tab.shape
        tab32 = torch.zeros((T, 256), dtype=torch.int32, device=dev)
        tab32[:, :A] = tab.int() & 0xFFFF
        rows = (torch.zeros((1, L), dtype=torch.int64, device=dev)
                if tree is None else tree.long()[None, :])
        sym64 = sym.long()
        n_ids = 0 if tree is None else L
        cases["k4_lookup"].append(compare(
            "k4_lookup", name, lambda: kernels.lookup(sym, tab, tree),
            lambda: lookup.fused_lookup_plain(sym, tab, tree), 100, 5,
            bound(R * L + 2 * T * A + n_ids + 4 * R * L),
            lambda: tab32[rows, sym64], extra={"trees": T}))

    err = FirstSubblock(synthesize_fastq(70000, read_len=36, seed=1), dev)
    err.describe("ERR005195 36 bp")
    a = err.a
    # the R live rows as stage A passes them (the kernels line's K1 row),
    # then the padded planes (all Rp rows), as earlier trees passed them
    k1("k1 quality A=256 live rows", a.qual_t[:a.R],
       quality.valid_mask(a.lens[:a.R], a.L), 256)
    k1("k1 dna keep A=128 live rows", a.seq[:a.R], a.keep[:a.R], 128)
    k1("k1 quality A=256", a.qual_t, quality.valid_mask(a.lens, a.L), 256)
    k1("k1 dna keep A=128", a.seq, a.keep, 128)
    k5("k5 36 bp", err)
    k2("k2 quality walk", err)
    require(err.p.d_plan.mode == dna.MODE_PLAIN,
            "ERR005195 DNA plan is not plain")
    k3("k3 dna plain2", err, "plain2")
    require(len(err.lookups) == 1 and err.lookups[0][1].shape[1] == 256,
            "ERR005195 quality lookup is not one A=256 table")
    k4("k4 quality A=256", *err.lookups[0])

    clean = FirstSubblock(synthesize_fastq(70000, read_len=36, seed=1,
                                           ambiguity_rate=0.0), dev)
    require(clean.lookups[0][1].shape[1] == 64,
            "quality window of ERR005195 without IUPAC is not A=64")
    k4("k4 quality A=64", *clean.lookups[0])

    srr = FirstSubblock(srr_huffman_corpus(40000, seed=2), dev)
    srr.describe("SRR-style 76 bp")
    require(srr.p.d_plan.mode == dna.MODE_HUFFMAN and len(srr.lookups) == 2,
            "SRR corpus with high-quality N did not take DNA Huffman mode")
    k3("k3 dna huffman", srr, "huffman")
    k4(f"k4 dna huffman A={srr.lookups[1][1].shape[1]}", *srr.lookups[1])

    var = FirstSubblock(synthesize_fastq(40000, read_len=100, seed=3,
                                         variable_length=True), dev)
    var.describe("variable-length 100 bp")
    require(var.p.variable and var.p.q_tables.n_trees > 1,
            "variable-length sub-block without several quality trees")
    k3("k3 quality variable-length", var, "quality")
    k5("k5 variable 100 bp", var)

    long_ = FirstSubblock(synthesize_fastq(5000, read_len=1000, seed=4), dev)
    long_.describe("1000 bp")
    a = long_.a
    require(a.L == 1000, "1000 bp sub-block is not L = 1000")
    k1("k1 quality L=1000", a.qual_t, quality.valid_mask(a.lens, a.L), 256)
    k2("k2 quality walk L=1000", long_)
    k5("k5 1000 bp", long_)
    k4(f"k4 quality L=1000 A={long_.lookups[0][1].shape[1]}",
       *long_.lookups[0])

    lanes = FirstSubblock(long_lane_corpus(1500, seed=5), dev)
    lanes.describe("long lanes")
    lane = int(lanes.p.q_sub.max())
    require(lanes.G == 64 and lane > 1 << 16,
            f"long-lane sub-block: G = {lanes.G}, longest lane {lane} words")
    k5("k5 long lanes", lanes)
    k5_lanes(16384, 30, seed=13)
    k5_lanes(131072, 6, seed=14)
    k3("k3 quality long lanes", lanes, "quality", against_input=True)

    reads = FirstSubblock(long_read_corpus(16, seed=11), dev)
    reads.describe("65,532 bp reads")
    k2("k2 quality walk L=65532", reads, against_input=True, reps=3)
    k3("k3 quality L=65532", reads, "quality", against_input=True, reps=3)
    sym, tab, tree = reads.lookups[0]
    require(sym.shape[1] == 65532 and tab.shape[0] > 1 and tree is not None,
            "65,532 bp quality lookup is not one L = 65532 table of trees")
    k4(f"k4 quality L=65532 T={tab.shape[0]} A={tab.shape[1]}",
       *reads.lookups[0])

    def k6(name, build):
        """K6 on a sub-block's code lengths as the decode uploads them
        (build() gives one or two of subblock.decode_wires' LensWires: the
        lens4 words and the host's layout rows), both streams in one
        launch (tables.walk_luts_both), against each stream's plain version
        on the card (the full LUTs and the two-level table, exact); bound:
        the words and rows read, the tables written; wire_ms: the host
        time of build()."""
        wires = build()
        pieces = [(w, *subblock._upload_together(w.pieces(), dev))
                  for w in wires]

        def launch():
            return tables.walk_luts_both(*pieces)[:len(pieces)]

        def plain():
            return [tables.walk_luts_plain(*x) for x in pieces]

        def join(luts):
            return torch.cat([t for wl in luts for t in (
                wl.full.reshape(-1).long(), wl.packed.long())])

        lays = [w.layout for w in wires]
        nbytes = sum(4 * (words.numel() + rows.numel()
                          + w.n_trees * (1 << bits)) + 2 * w.layout.n
                     for w, words, rows in pieces)
        cases["k6_tables"].append(compare(
            "k6_tables", name, launch, plain, 200, 5, bound(nbytes),
            extra={"streams": len(wires),
                   "trees": [w.n_trees for w in wires],
                   "k": [x.k for x in lays], "entries": [x.n for x in lays],
                   "blocks": [x.n_blocks for x in lays],
                   "own_blocks": [x.own for x in lays],
                   "wire_ms": host_ms(build, 200)},
            join=join))
        return lays[0]

    k6("k6 ERR quality", lambda: subblock.decode_wires(err.p, err.cfg)[:1])
    k6("k6 1000 bp quality",
       lambda: subblock.decode_wires(long_.p, long_.cfg)[:1])
    k6("k6 variable 100 bp quality",
       lambda: subblock.decode_wires(var.p, var.cfg)[:1])
    k6("k6 DNA huffman", lambda: subblock.decode_wires(srr.p, srr.cfg)[1:])
    k6("k6 SRR quality + DNA huffman, one launch",
       lambda: subblock.decode_wires(srr.p, srr.cfg))
    lens = err.p.q_tables.lens.copy()
    sing = err.p.q_tables.singletons.copy()
    lens[::3], sing[::3] = 0, 40 + np.arange(lens[::3].shape[0])
    k6("k6 ERR quality, every third tree a singleton",
       lambda: [tables.lens_wire(lens, sing, bits, max(err.p.Lt, 1))])
    lay = k6("k6 65,532 bp quality (shared block)",
             lambda: subblock.decode_wires(reads.p, reads.cfg)[:1])
    require(lay.k > 0 and lay.n_blocks > lay.own,
            "the 65,532 bp tables have no shared block of escapes")

    def floor(blocks):
        """An empty kernel's launch: the floor under K5's and K6's times
        (its device time comes in phase 6, with the kernels')."""
        def fn():
            kernels.empty_launch(dev, blocks)

        case = {"case": f"empty kernel, {blocks} blocks", "blocks": blocks,
                "ms": cuda_ms(fn, 200)}
        print(f"launch floor: {json.dumps(case)}", flush=True)
        case["_probe"] = (fn, 200, "empty_kernel")
        return case

    cases["launch_floor"] = [floor(1), floor(
        torch.cuda.get_device_properties(dev).multi_processor_count)]
    walks = cases["k2_walk_uniform"] + cases["k3_walk_masked"]
    require(any(c["k"] is not None and c["k"] < bits for c in walks)
            and any(c["k"] == bits for c in walks),
            "the walk cases did not take both whole and two-level tables")
    last = cases["k2_walk_uniform"][-1:] + cases["k3_walk_masked"][-1:]
    require(all(c["full_lut_prefixes"] > 0 for c in last),
            "the 65,532 bp walks sent no prefix to the full LUT")
    return cases


#: each entry point of the host runtime, and the host stage of the main path
#: that reaches it (title_walk off for unpack_substreams, which the title
#: decode takes only without it)
HOST_ENTRIES = {
    "index_records": "index_records", "gather3": "gather3",
    "byte_scan": "pack_seq_np", "pack_fixed": "pack_seq_np",
    "find_non_acgt": "pack_seq_np", "huffman_lengths": "build_tables",
    "title_scan": "title.encode", "numeric_stats": "title.encode",
    "gather": "title.encode", "title_walk": "title.decode",
    "title_assemble": "title.decode",
    "unpack_substreams": "title.decode, title_walk off",
    "decode_tail": "_unpack_out", "fastq_assemble": "_reassemble"}
#: the host stages, where the main path calls them
HOST_STAGES = {"index_records": (compress, "index_records"),
               "pack_seq_np": (transfer, "pack_seq_np"),
               "pack_qual_np": (transfer, "pack_qual_np"),
               "build_tables": (quality, "build_tables"),
               "title.encode": (title, "encode"),
               "title.decode": (title, "decode"),
               "_unpack_out": (subblock, "_unpack_out"),
               "_reassemble": (subblock, "_reassemble")}


def same(a, b, exact=True) -> bool:
    """Equal values and shapes, and (exact) dtypes, through lists, tuples
    and dicts."""
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y, exact) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k], exact) for k in a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and (not exact or a.dtype == b.dtype)
                and np.array_equal(a, b))
    return a == b


def scanned(scan: dict) -> dict:
    """title_scan's outputs with the cells it leaves unwritten (past each
    row's separators and fields) zeroed."""
    ns = scan["nsep"][:, None]
    out = dict(scan)
    for k, n in (("sep_pos", ns), ("sep_chars", ns), ("values", ns + 1),
                 ("numeric_ok", ns + 1)):
        cols = np.arange(scan[k].shape[1])[None, :]
        out[k] = np.where(cols < n, scan[k], 0)
    return out


def stage_output(name: str, out):
    """What a host stage gives, as arrays, bytes and numbers."""
    if name == "index_records":
        return [getattr(out, f) for f in ("title_start", "title_end",
                                          "seq_start", "seq_end",
                                          "qual_start", "qual_end")]
    if name == "build_tables":
        return [out.lens, out.codes, out.singletons]
    if name == "title.encode":
        bw = bitio.BitWriter()
        title.write_header(bw, out)
        bw.flush()
        return [bw.getvalue(), out.fixed_words, out.char_words,
                out.char_sub_n_words]
    return out


def gather3_stage(args):
    """stage A's gather: native.gather3, else (numpy) three _gather_matrix
    and the quality plane's max, as subblock.stage_a does."""
    got = native.gather3(*args)
    if got is not None:
        return list(got)
    buf, t_start, t_lens, TW, s_start, q_start, lens, W = args
    planes = [subblock._gather_matrix(buf, st, n.astype(np.int64), w)
              for st, n, w in ((t_start, t_lens, TW), (s_start, lens, W),
                               (q_start, lens, W))]
    return planes + [int(planes[2].max()) if len(lens) else 0]


def phase_host_runtime(dev, T: int) -> list:
    """The host runtime on the card's host: one default ERR005195 sub-block
    through compress_bytes -> decompress_bytes on the card, recording the
    first call of each host stage (and stage A's gather3); then each stage
    at T threads, at 1 thread and on the numpy versions, equal, and the
    calls that each entry point received in the T run, replayed at T and
    at 1 thread, equal."""
    data = synthesize_fastq(70000, read_len=36, seed=1)
    buf = np.frombuffer(data, np.uint8)
    cfg = compress.resolve_substream(buf, CodecConfig())
    _, idx = next(compress.iter_subblock_tasks(
        buf, compress.partition_regions(buf, 1, cfg), cfg))
    data = data[int(idx.title_start[0]):int(idx.qual_end[-1]) + 1]
    first = {}
    saved = {k: getattr(m, a) for k, (m, a) in HOST_STAGES.items()}
    saved["gather3"] = native.gather3

    def recorder(key, fn):
        def rec(*args, **kwargs):
            first.setdefault(key, (args, kwargs))
            return fn(*args, **kwargs)
        return rec

    for k, (m, a) in HOST_STAGES.items():
        setattr(m, a, recorder(k, saved[k]))
    native.gather3 = recorder("gather3", saved["gather3"])
    try:
        blob = compress.compress_bytes(data, CodecConfig(), 1, device=dev)
        require(decompress_bytes(blob, None, device=dev) == data,
                "host runtime phase: the sub-block's round trip differs")
    finally:
        for k, (m, a) in HOST_STAGES.items():
            setattr(m, a, saved[k])
        native.gather3 = saved["gather3"]
    require(set(first) == set(HOST_STAGES) | {"gather3"},
            f"host runtime phase: stages not reached: "
            f"{sorted(set(HOST_STAGES) | {'gather3'} - set(first))}")
    runs = {}
    for k, (m, a) in HOST_STAGES.items():
        args, kwargs = first[k]
        runs[k] = (lambda k_=k, fn=saved[k], a_=args, kw=kwargs:
                   stage_output(k_, fn(*a_, **kw)))
    runs["gather3"] = lambda: gather3_stage(first["gather3"][0])
    t_args, t_kwargs = first["title.decode"]

    def decode_by_substreams():
        walk = native.title_walk
        native.title_walk = lambda *a, **k: None
        try:
            return saved["title.decode"](*t_args, **t_kwargs)
        finally:
            native.title_walk = walk

    runs["title.decode, title_walk off"] = decode_by_substreams

    stage_ms = {}
    calls = collections.defaultdict(list)
    wrappers = {e: getattr(native, e) for e in HOST_ENTRIES}

    def spy(entry, fn):
        def call(*args, **kwargs):
            calls[entry].append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    for name, fn in runs.items():
        native.set_threads(1)
        out_1, ms_1 = fn(), host_ms(fn, 3)
        os.environ["PHYNGSC_NO_NATIVE"] = "1"
        try:
            out_np, ms_np = fn(), host_ms(fn, 3)
        finally:
            del os.environ["PHYNGSC_NO_NATIVE"]
        native.set_threads(T)
        for e, w in wrappers.items():
            if HOST_ENTRIES[e] == name:
                setattr(native, e, spy(e, w))
        try:
            out_t = fn()
        finally:
            for e, w in wrappers.items():
                setattr(native, e, w)
        ms_t = host_ms(fn, 3)
        require(same(out_t, out_1, exact=False)
                and same(out_t, out_np, exact=False),
                f"host stage {name}: T = {T}, 1 thread and numpy differ")
        stage_ms[name] = (ms_t, ms_1, ms_np)
    rows = []
    for entry, stage in HOST_ENTRIES.items():
        made = calls[entry]
        require(made, f"host runtime: {stage} never called {entry}")
        w = wrappers[entry]

        def replay():
            return [w(*a, **k) for a, k in made]

        native.set_threads(1)
        got_1, ms_1 = replay(), host_ms(replay, 5)
        native.set_threads(T)
        got_t, ms_t = replay(), host_ms(replay, 5)
        if entry == "title_scan":
            got_1, got_t = [scanned(x) for x in got_1], [scanned(x)
                                                         for x in got_t]
        require(same(got_t, got_1),
                f"host runtime {entry}: {T} threads and 1 thread differ")
        s_t, s_1, s_np = stage_ms[stage]
        row = {"entry": entry, "stage": stage, "calls": len(made),
               "ms": ms_t, "ms_1_thread": ms_1, "stage_ms": s_t,
               "stage_ms_1_thread": s_1, "stage_numpy_ms": s_np}
        print(f"host runtime: {json.dumps(row)}", flush=True)
        rows.append(row)
    print(f"host runtime: 14 entry points equal at {T} threads, at 1 thread "
          f"and on the numpy versions ({len(data)} B sub-block)", flush=True)
    return rows


class WireModes:
    """While entered, notes the wire mode of every sub-block the pipeline
    packs or fetches: ops/transfer's sequence and quality upload packing,
    and the decode fetch (subblock.decode_stage_a's out_meta). counts():
    how many sub-blocks took each."""

    def __enter__(self):
        self.seen = []  # appended from the pipelines' pool threads
        self.saved = (transfer.pack_seq_np, transfer.pack_qual_np,
                      subblock.decode_stage_a)
        pack_seq, pack_qual, stage_a = self.saved

        def seq(plane):
            mode, words = pack_seq(plane)
            self.seen.append(f"seq {SEQ_MODES[mode]}")
            return mode, words

        def qual(plane):
            mode, words = pack_qual(plane)
            self.seen.append(f"qual {QUAL_MODES[mode]}")
            return mode, words

        def decode(*args, **kwargs):
            st = stage_a(*args, **kwargs)
            m = st.out_meta
            self.seen.append(
                "fetch raw planes" if m is None else
                f"fetch {'qual8' if m.qual8 else 'restored'}, index w={m.w}, "
                f"quality {'6' if m.q6 else '8'}-bit")
            return st

        transfer.pack_seq_np, transfer.pack_qual_np = seq, qual
        subblock.decode_stage_a = decode
        return self

    def __exit__(self, *exc):
        (transfer.pack_seq_np, transfer.pack_qual_np,
         subblock.decode_stage_a) = self.saved

    def counts(self) -> dict:
        return dict(sorted(collections.Counter(self.seen).items()))


def round_trip(data: bytes, dev, what: str, shards: int = 1) -> dict:
    """compress_bytes -> decompress_bytes on the card, byte-identical, with
    K5 launched twice (quality and DNA planes) per shard per decoded
    sub-block; `shards` data shards, all on dev. Returns the container's
    SHA-256, its sub-block count and both rates."""
    cfg = CodecConfig(data_shards=shards)
    device = dev if shards == 1 else [dev] * shards
    stats = []
    with WireModes() as modes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = compress.compress_bytes(data, cfg, 1, device=device,
                                       stats_out=stats)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        back = decompress_bytes(comp, cfg, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    require(back == data, f"{what}: round trip is not byte-identical")
    n_sub = sum(s.n_subblocks for s in stats)
    run = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    k5, k6 = run["k5_densify"], run["k6_tables"]
    require(k5 == 2 * shards * n_sub, f"{what}: K5 launched {k5} times for "
            f"{n_sub} decoded sub-blocks of {shards} shards, not twice each")
    require(k6 == shards * n_sub, f"{what}: K6 launched {k6} times for "
            f"{n_sub} decoded sub-blocks of {shards} shards, not once each")
    mb = len(data) / 1e6
    res = {"sha256": hashlib.sha256(comp).hexdigest(), "subblocks": n_sub,
           "compress_mbps": mb / (t1 - t0), "decompress_mbps": mb / (t2 - t1)}
    print(f"round trip {what}: {len(data)} B -> {len(comp)} B, ratio "
          f"{len(data) / len(comp):.4f}, compress {res['compress_mbps']:.2f} "
          f"MB/s ({t1 - t0:.3f} s), decompress {res['decompress_mbps']:.2f} "
          f"MB/s ({t2 - t1:.3f} s), byte-identical, {n_sub} sub-blocks, "
          f"{shards} shard(s), {k5} K5 and {k6} K6 launches", flush=True)
    print(f"wire modes {what}: {json.dumps(modes.counts())}", flush=True)
    return res


def check_counts(what: str, names) -> dict:
    """The launch counts of the run just driven: every kernel of `names`
    launched, no plain version run on a CUDA tensor."""
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_ON_CUDA)
    print(f"{what} launches: {json.dumps(launches)}", flush=True)
    print(f"{what}: plain versions run on CUDA tensors: {json.dumps(plain)}",
          flush=True)
    require(all(launches[n] > 0 for n in names),
            f"a kernel of the {what} was never launched")
    require(not any(plain.values()),
            f"a plain version ran on a CUDA tensor in the {what}")
    return launches


def phase_round_trip(dev, err: bytes) -> dict:
    corpora = [
        (f"ERR005195 36 bp {len(err) / 1e6:.0f} MB", err),
        ("SRR-style 76 bp (DNA Huffman)",
         srr_huffman_corpus(int(len(err) / 8 / 200), seed=6)),
        ("variable-length 100 bp", corpus_of(64, lambda n: synthesize_fastq(
            n, read_len=100, seed=7, variable_length=True))),
        ("1000 bp", corpus_of(64, lambda n: synthesize_fastq(
            n, read_len=1000, seed=8))),
        ("SOLiD colour space 50", corpus_of(16, lambda n: solid_corpus(n, 9))),
        ("long lanes (G = 64, reads of 5.4 kbp)",
         corpus_of(16, lambda n: long_lane_corpus(n, 10))),
        ("65,532 bp reads (128 trees)", long_read_corpus(16, seed=12)),
    ]
    kernels.reset_counts()
    results = [round_trip(data, dev, what) for what, data in corpora]
    return check_counts("main path", kernels.LAUNCHES), results[0]


def phase_files(dev, data: bytes) -> None:
    """compress_file -> decompress_file of `data` on disk, then the CLI's
    verify in a child process."""
    shutil.rmtree(FILE_DIR, ignore_errors=True)
    os.makedirs(FILE_DIR)
    try:
        src = os.path.join(FILE_DIR, "err.fastq")
        comp = os.path.join(FILE_DIR, "err.ngsct")
        back = os.path.join(FILE_DIR, "err.back.fastq")
        with open(src, "wb") as f:
            f.write(data)
        stats = []
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compress.compress_file(src, comp, CodecConfig(), 1, stats, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decompress_file(comp, back, None, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = check_counts("file path", ERR_PATH)
        n_sub = sum(s.n_subblocks for s in stats)
        require(launches["k5_densify"] == 2 * n_sub,
                f"file path: K5 launched {launches['k5_densify']} times for "
                f"{n_sub} sub-blocks")
        with open(back, "rb") as f:
            require(f.read() == data, "decompress_file did not restore the "
                    "input byte for byte")
        mb = len(data) / 1e6
        print(f"files: compress_file {mb / (t1 - t0):.2f} MB/s "
              f"({t1 - t0:.3f} s), decompress_file {mb / (t2 - t1):.2f} MB/s "
              f"({t2 - t1:.3f} s), {os.path.getsize(comp)} B container, "
              f"{n_sub} sub-blocks, byte-identical", flush=True)
        os.remove(comp)
        os.remove(back)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "phyngsc_tpu_torch", "verify", src,
             "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
        print(f"python3 -m phyngsc_tpu_torch verify "
              f"({time.perf_counter() - t0:.1f} s, exit {res.returncode}): "
              f"{res.stdout.strip()}", flush=True)
        require(res.returncode == 0, f"verify exited {res.returncode}: "
                f"{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(FILE_DIR, ignore_errors=True)


def run_pair(argv_of, what: str) -> float:
    """argv_of(coordinator, rank) as two child processes (ranks 0 and 1);
    both must exit 0 and log the port's host runtime (under build/host/) as
    the library they loaded. Returns the wall seconds until both ended."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv_of(coord, i), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        logs = [line for line in err.splitlines() if line.startswith("[I]")]
        print(f"{what} process {i}: exit {p.returncode}; " + " | ".join(logs),
              flush=True)
        require(p.returncode == 0, f"{what} process {i} exited "
                f"{p.returncode}: {err[-2000:]}")
        lib = os.path.join(HOST_DIR, "libphyngsc_host_")
        require(any(f"host runtime {lib}" in line for line in logs),
                f"{what} process {i} did not load the port's host runtime "
                f"under {HOST_DIR}")
    return wall


def phase_sharded(dev, err: bytes, err_result: dict) -> dict:
    """(a) the sharded round trips, with their launch counts; (b) two
    processes on the card; (c) the stage split. Returns the launch counts
    of (a)'s ERR run."""
    kernels.reset_counts()
    res = round_trip(err, dev, "ERR005195 36 bp, data_shards=2", shards=2)
    launches = check_counts("sharded path", ERR_PATH)
    require(res["sha256"] == err_result["sha256"],
            "the 2-shard container differs from phase 3's 1-shard one")
    n = 2 * res["subblocks"]  # (shard, sub-block) pairs
    want = {"k1_histogram": 2 * n, "k2_walk_uniform": n, "k5_densify": 2 * n,
            "k3_walk_masked": n,
            "k4_lookup": n + launches["k3_walk_masked/huffman"],
            "k6_tables": n}
    require(all(launches[k] == v for k, v in want.items()),
            f"sharded path: launches {launches} are not once per shard per "
            f"sub-block ({want})")
    print(f"sharded ERR005195: compress {res['compress_mbps']:.2f} / "
          f"decompress {res['decompress_mbps']:.2f} MB/s at 2 shards on one "
          f"card against {err_result['compress_mbps']:.2f} / "
          f"{err_result['decompress_mbps']:.2f} at 1 shard (phase 3); same "
          "container", flush=True)
    round_trip(corpus_of(16, lambda k: synthesize_fastq(
        k, read_len=100, seed=15, variable_length=True)), dev,
        "variable-length 100 bp, data_shards=3", shards=3)

    shutil.rmtree(FILE_DIR, ignore_errors=True)
    os.makedirs(FILE_DIR)
    try:
        src = os.path.join(FILE_DIR, "err.fastq")
        comp = os.path.join(FILE_DIR, "err.2p.ngsct")
        back = os.path.join(FILE_DIR, "err.2p.fastq")
        with open(src, "wb") as f:
            f.write(err)

        def driver(*args):
            return lambda coord, i: [
                sys.executable, "-m", "phyngsc_tpu_torch.parallel.distributed",
                "--coordinator", coord, "--num-processes", "2",
                "--process-id", str(i), "--device", "cuda", *args]

        t_c = run_pair(driver(src, comp), "distributed compress")
        t_d = run_pair(driver("--decompress", comp, back),
                       "distributed decompress")
        with open(back, "rb") as f:
            require(f.read() == err, "the two-process decode did not restore "
                    "the input byte for byte")
        os.remove(back)
        decompress_file(comp, back, None, dev)
        with open(back, "rb") as f:
            require(f.read() == err, "decompress_file of the two-process "
                    "container did not restore the input")
        mb = len(err) / 1e6
        print(f"two processes on one card: compress {t_c:.3f} s "
              f"({mb / t_c:.2f} MB/s), decompress {t_d:.3f} s "
              f"({mb / t_d:.2f} MB/s), wall with process start, "
              f"{os.path.getsize(comp)} B container, byte-identical, and "
              "decompress_file restores it", flush=True)
    finally:
        shutil.rmtree(FILE_DIR, ignore_errors=True)

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logger = logging.getLogger("phyngsc_tpu_torch")
    logger.addHandler(handler)
    os.environ["PHYNGSC_TIMING"] = "1"
    try:
        blob = compress.compress_bytes(err, CodecConfig(), 1, device=dev)
        enc = dict(subblock.TIMING)
        require(decompress_bytes(blob, None, device=dev) == err,
                "timed round trip is not byte-identical")
        dec = dict(subblock.TIMING)
    finally:
        del os.environ["PHYNGSC_TIMING"]
        logger.removeHandler(handler)
    require(hashlib.sha256(blob).hexdigest() == err_result["sha256"],
            "the container changed with PHYNGSC_TIMING=1")
    for line in lines:
        if "timing:" in line:
            print(f"stage split: {line}", flush=True)
    print(f"stage split bytes: compress h2d {int(enc['h2d_bytes'])} d2h "
          f"{int(enc['d2h_bytes'])}, decompress h2d {int(dec['h2d_bytes'])} "
          f"d2h {int(dec['d2h_bytes'])}; container {len(blob)} B, decompress "
          f"h2d / container {dec['h2d_bytes'] / len(blob):.4f}", flush=True)
    scale = max(1.0, len(err) / ERR_DEFAULT_BYTES)
    got = {"compress h2d": enc["h2d_bytes"], "compress d2h": enc["d2h_bytes"],
           "decompress d2h": dec["d2h_bytes"]}
    for name, limit in ERR_WIRE_LIMITS.items():
        require(got[name] <= limit * scale, f"ERR {name}: {int(got[name])} B "
                f"over the packed wire's {int(limit * scale)}")
    require(dec["h2d_bytes"] <= 1.05 * len(blob),
            f"ERR decompress h2d: {int(dec['h2d_bytes'])} B over 1.05x the "
            f"{len(blob)} B container")
    return launches


def phase_fuzz(dev, err: bytes, err_result: dict, n_flips: int = 60) -> None:
    """The first n_flips of tests/test_fuzz.py's bit flips (its corpus
    and seeds, tests/torch_fuzz_cases.py) decoded on the card and on the
    CPU: the same outcome each, the input back or the same designed
    rejection (ValueError / EOFError), never a fault; then a clean ERR
    round trip in this process, phase 3's container (a kernel fault would
    have poisoned the CUDA context)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fuzz_cases import CFG, bitflip_corpus, flips, outcome

    rng, data = bitflip_corpus()
    blob = compress.compress_bytes(data, CFG, 2, device=dev)
    require(blob == compress.compress_bytes(data, CFG, 2, device="cpu"),
            "fuzz: the card's container differs from the CPU's")
    seen = collections.Counter()
    for pos, bit, mutated in list(flips(rng, blob))[:n_flips]:
        try:
            here = outcome(lambda b: decompress_bytes(b, device="cpu"),
                           mutated, data)
            there = outcome(lambda b: decompress_bytes(b, device=dev),
                            mutated, data)
        except AssertionError as e:
            require(False, f"fuzz: flip of byte {pos} bit {bit}: {e}")
        require(here == there, f"fuzz: flip of byte {pos} bit {bit}: "
                f"{there} on the card, {here} on the CPU")
        seen[there] += 1
    torch.cuda.synchronize()
    require(set(seen) - {"ok"}, "fuzz: no flip was rejected")
    again = compress.compress_bytes(err, CodecConfig(), 1, device=dev)
    require(hashlib.sha256(again).hexdigest() == err_result["sha256"]
            and decompress_bytes(again, None, device=dev) == err,
            "fuzz: the ERR round trip after the flips is not phase 3's")
    print(f"fuzz: {n_flips} bit flips decoded on the card as on the CPU "
          f"{json.dumps(dict(sorted(seen.items())))}, then a clean ERR "
          "round trip", flush=True)


def phase_goldens(dev) -> None:
    inputs = {"tiny_v1.ngsct": synthesize_fastq(300, read_len=36, seed=99),
              "tiny_v2.ngsct": synthesize_fastq(300, read_len=36, seed=99),
              "titles_v3.ngsct": titles_input(),
              "longread_v4.ngsct": synthesize_fastq(
                  220, read_len=1000, seed=77, ambiguity_rate=0.005)}
    for name, want in inputs.items():
        with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
            blob = f.read()
        require(decompress_bytes(blob, None, device=dev) == want,
                f"golden {name} does not decode to its input")
        print(f"golden {name}: decodes byte-exact", flush=True)
        if name == "titles_v3.ngsct":
            again = compress.compress_bytes(want, GOLDEN_CFG, 2, device=dev)
            require(hashlib.sha256(again).hexdigest()
                    == TITLES_V3_REENCODE_SHA256,
                    "titles_v3 input re-encodes to other bytes than "
                    "phyngsc_tpu's")
            print("golden titles_v3 input: re-encodes to phyngsc_tpu's "
                  "bytes", flush=True)


def phase_async(dev, err: bytes, err_result: dict) -> None:
    """5b: the two probes, the round trip under sync-debug mode, the busy
    share."""
    sleep_cycles = 100_000_000
    (mine,), (theirs,) = (devmod.task_streams([dev], i) for i in range(2))
    words = np.random.default_rng(3).integers(0, 256, size=8_400_000,
                                              dtype=np.uint8)
    with torch.cuda.stream(mine):
        devmod.upload([words], dev)  # the staging block, made once
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(sleep_cycles)
        end.record()
        t0 = time.perf_counter()
        (got,) = devmod.upload([words], dev)
        up_ms = (time.perf_counter() - t0) * 1e3
        back = devmod.fetch_async(got).result()
    require(np.array_equal(back, words), "async probe: the upload's bytes "
            "differ")
    sleep_ms = start.elapsed_time(end)
    print(f"async probe: upload of {words.nbytes} B returned in {up_ms:.3f} "
          f"ms behind a {sleep_ms:.1f} ms sleep on its stream", flush=True)
    require(up_ms < 5, f"async probe: the upload waited {up_ms:.2f} ms")
    x = torch.arange(1 << 22, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(theirs):
        torch.cuda._sleep(4 * sleep_cycles)
        theirs_done = torch.cuda.Event()
        theirs_done.record()
    with torch.cuda.stream(mine):
        pending = devmod.fetch_async(x * 3)
    t0 = time.perf_counter()
    got = pending.result()
    fetch_ms = (time.perf_counter() - t0) * 1e3
    still = not theirs_done.query()
    print(f"async probe: fetch of {got.nbytes} B returned in {fetch_ms:.3f} "
          f"ms, another task's sleep still running: {still}", flush=True)
    require(still and np.array_equal(
        got, np.arange(1 << 22, dtype=np.int32) * 3),
        "async probe: the fetch waited for another task's stream")
    torch.cuda.synchronize()

    torch.cuda.set_sync_debug_mode("error")
    try:
        blob = compress.compress_bytes(err, CodecConfig(), 1, device=dev)
        back = decompress_bytes(blob, None, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(back == err and hashlib.sha256(blob).hexdigest()
            == err_result["sha256"], "the round trip under sync-debug mode "
            "is not phase 3's")
    print("sync debug: the ERR round trip raised nothing under "
          "torch.cuda.set_sync_debug_mode('error'), byte-identical",
          flush=True)

    from torch.profiler import ProfilerActivity, profile, record_function

    for side, call in (
            ("compress", lambda: compress.compress_bytes(err, CodecConfig(),
                                                         1, device=dev)),
            ("decompress", lambda: decompress_bytes(blob, None, device=dev))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(f"smoke.{side}"):
                out = call()
                torch.cuda.synchronize()
        require(out == (blob if side == "compress" else err),
                f"the profiled {side} differs")
        trace = os.path.join(ROOT, "build", "chip_smoke_trace.json")
        act = device_activity(prof, f"smoke.{side}", trace)
        os.remove(trace)
        require(act["busy_s"] > 0, f"the profiled {side} ran nothing on the "
                "card")
        print(f"busy share {side}: {json.dumps(act)}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=256,
                    help="size of the ERR005195 round-trip corpus in MB")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi()
    print(f"nvidia-smi: {card}", flush=True)
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} nvcc: {nvcc[-1]}", flush=True)
    require(not os.environ.get("PHYNGSC_NO_NATIVE"),
            "PHYNGSC_NO_NATIVE is set: the host runtime would not run")
    t0 = time.perf_counter()
    try:
        lib = host_runtime.ensure()
    except RuntimeError as e:
        require(False, f"the host runtime did not build: {e}")
    T = native.threads()
    require(native.loaded_path() == lib and os.path.dirname(lib) == HOST_DIR,
            f"the host runtime loaded is {native.loaded_path()}, not the "
            f"port's under {HOST_DIR}")
    print(f"host: os.cpu_count() {os.cpu_count()}, sched_getaffinity "
          f"{len(os.sched_getaffinity(0))}, host runtime threads T {T}, "
          f"library {lib}, found or built in {time.perf_counter() - t0:.2f} "
          "s", flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({kernels.library_path()})", flush=True)
    for line in kernels.build_log().splitlines():  # ptxas -v of the walks
        if "walk" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    cases = phase_kernels(dev)
    phase_host_runtime(dev, T)
    err = corpus_of(args.mb, lambda n: synthesize_fastq(n, read_len=36,
                                                        seed=5))
    launches, err_result = phase_round_trip(dev, err)
    phase_files(dev, err)
    sharded = phase_sharded(dev, err, err_result)
    phase_goldens(dev)
    phase_fuzz(dev, err, err_result)
    phase_async(dev, err, err_result)
    phase_device_times(cases)
    require(all(sys.modules.get(m) is None for m in ("jax", "phyngsc_tpu")),
            "jax or phyngsc_tpu was imported")

    floor_ms = {c["blocks"]: c["device_ms"] for c in cases["launch_floor"]}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        c = cases[name]
        extra = ({"launch_floor_device_ms": floor_ms}
                 if name in ("k5_densify", "k6_tables") else {})
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "sharded_launches": sharded[name],
                     "max_abs_err": max(x["max_abs_err"] for x in c),
                     "ms": c[0]["ms"], "plain_ms": c[0]["plain_ms"],
                     "bound_ms": c[0]["bound_ms"],
                     "bound_by": c[0]["bound_by"],
                     "library_ms": c[0]["library_ms"],
                     "device_ms": c[0]["device_ms"], **extra, "cases": c})
    print(card)  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (phyngsc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mb 256]

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA / nvcc
     versions, and the kernels' build time;
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
     two-level shared-memory tables the decode builds);
     K5 also on lane tables of 16,384 and 131,072 lanes (G = 8 and
     G = 1 over short reads); results must be exactly equal; times are
     CUDA-event medians of one call, each call timed alone after a
     synchronize. Beside each case: library_ms, one PyTorch call computing
     the same function (torch.bincount for K1, advanced indexing for K4,
     torch.gather for K5, none for the walks), checked equal too and timed
     the same way, and bound_ms, the least time the card could take (bytes
     read once and written once at 3.35 TB/s, or the operations at
     67 T/s, whichever is larger), with the walks' chain floor (their
     longest lane's steps at one shared-memory load each);
  3. the main path: compress_bytes -> decompress_bytes with device="cuda" on
     --mb MB of synthetic ERR005195 36 bp reads, an SRR-style 76 bp corpus
     whose DNA stream is Huffman-coded, variable-length 100 bp reads,
     1000 bp reads, SOLiD colour-space reads, variable 5.4 kbp reads whose
     lanes hold more than 2^16 words and 65,532 bp reads, each
     byte-identical, with
     every kernel variant launched, K5 twice per decoded sub-block, and no
     plain version run on a CUDA tensor;
  4. the file entry points: compress_file -> decompress_file of the
     ERR005195 corpus on disk, byte-identical, with every kernel of the path
     launched in that run, then `python3 -m phyngsc_tpu_torch verify FILE
     --device cuda` in a child process, which must exit 0;
  5. the committed golden containers tiny_v1 / tiny_v2 / titles_v3 /
     longread_v4 decode to their inputs, and the titles_v3 input re-encodes
     to phyngsc_tpu's bytes (by SHA-256);
  6. each phase-2 kernel case's own device time from a torch.profiler trace
     (last, so that the profiler cannot touch the timed round trips).
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors, times and bounds. The script
imports neither jax nor phyngsc_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
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
from phyngsc_tpu_torch.models import dna, quality  # noqa: E402
from phyngsc_tpu_torch.ops import (bitpack, bitpack_host, histogram,  # noqa: E402
                                   lookup)
from phyngsc_tpu_torch.pipeline import compress, subblock  # noqa: E402
from phyngsc_tpu_torch.pipeline.decompress import (  # noqa: E402
    decompress_bytes, decompress_file)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
#: scratch files of the file phase, inside the checkout's git-ignored build/
FILE_DIR = os.path.join(ROOT, "build", "chip_smoke")
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
}
#: each kernel's __global__ function, as torch.profiler names it
KERNEL_FN = {"k1_histogram": "hist_kernel",
             "k2_walk_uniform": "walk_uniform_kernel",
             "k3_walk_masked": "walk_masked_kernel",
             "k4_lookup": "lookup_kernel", "k5_densify": "densify_kernel"}
#: the H100's memory rate, and the rate taken for the kernels' scalar
#: integer operations (its float32 peak outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: one step of a walk's dependent chain: one shared-memory load, about 30
#: cycles, at the H100's 1,980 MHz boost clock
STEP_S = 30 / 1.98e9
#: the kernels (and K3 variants) that the ERR005195 36 bp path launches
ERR_PATH = ("k1_histogram", "k2_walk_uniform", "k3_walk_masked/plain2",
            "k4_lookup", "k5_densify")


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
            plain_reps: int, work: dict, library_fn=None, extra=None):
    """kernel_fn (a launch of `kernel`) against plain_fn on the card: exact
    equality, then the CUDA-event median of one call of each, and of
    library_fn (one PyTorch call of the same function, also held equal)
    where there is one, each timed alone. work: bound() of the case's
    inputs. The kernel's own device time comes
    later (phase_device_times), from `_probe`."""
    got = kernel_fn()
    ref = plain_fn()
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
    walks = cases["k2_walk_uniform"] + cases["k3_walk_masked"]
    require(any(c["k"] is not None and c["k"] < bits for c in walks)
            and any(c["k"] == bits for c in walks),
            "the walk cases did not take both whole and two-level tables")
    last = cases["k2_walk_uniform"][-1:] + cases["k3_walk_masked"][-1:]
    require(all(c["full_lut_prefixes"] > 0 for c in last),
            "the 65,532 bp walks sent no prefix to the full LUT")
    return cases


def round_trip(data: bytes, dev, what: str) -> None:
    """compress_bytes -> decompress_bytes on the card, byte-identical, with
    K5 launched twice (quality and DNA planes) per decoded sub-block."""
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = compress.compress_bytes(data, CodecConfig(), 1, device=dev,
                                   stats_out=stats)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k5_before = kernels.LAUNCHES["k5_densify"]
    back = decompress_bytes(comp, None, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    require(back == data, f"{what}: round trip is not byte-identical")
    n_sub = sum(s.n_subblocks for s in stats)
    k5 = kernels.LAUNCHES["k5_densify"] - k5_before
    require(k5 == 2 * n_sub, f"{what}: K5 launched {k5} times for {n_sub} "
            "decoded sub-blocks, not twice each")
    mb = len(data) / 1e6
    print(f"round trip {what}: {len(data)} B -> {len(comp)} B, ratio "
          f"{len(data) / len(comp):.4f}, compress {mb / (t1 - t0):.2f} MB/s "
          f"({t1 - t0:.3f} s), decompress {mb / (t2 - t1):.2f} MB/s "
          f"({t2 - t1:.3f} s), byte-identical, {n_sub} sub-blocks, "
          f"{k5} K5 launches", flush=True)


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
    for what, data in corpora:
        round_trip(data, dev, what)
    return check_counts("main path", kernels.LAUNCHES)


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
    print(f"host runtime (native/host_runtime.cpp): "
          f"{'built' if host_runtime.ensure() else 'absent, numpy fallbacks'}",
          flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({kernels.library_path()})", flush=True)
    for line in kernels.build_log().splitlines():  # ptxas -v of the walks
        if "walk" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    cases = phase_kernels(dev)
    err = corpus_of(args.mb, lambda n: synthesize_fastq(n, read_len=36,
                                                        seed=5))
    launches = phase_round_trip(dev, err)
    phase_files(dev, err)
    phase_goldens(dev)
    phase_device_times(cases)
    require(all(sys.modules.get(m) is None for m in ("jax", "phyngsc_tpu")),
            "jax or phyngsc_tpu was imported")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        c = cases[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(x["max_abs_err"] for x in c),
                     "ms": c[0]["ms"], "plain_ms": c[0]["plain_ms"],
                     "bound_ms": c[0]["bound_ms"],
                     "bound_by": c[0]["bound_by"],
                     "library_ms": c[0]["library_ms"],
                     "device_ms": c[0]["device_ms"], "cases": c})
    print(card)  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

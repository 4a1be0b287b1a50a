#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (phyngsc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mb 256]

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA / nvcc
     versions, and the kernels' build time;
  2. each hand-written kernel (K1 histogram, K2 uniform walk, K3 masked walk
     in its plain2, Huffman and per-position-tree quality variants, K4 code
     lookup) against its plain PyTorch version on the card, on the inputs
     the pipeline gives it for one default 8 MiB sub-block (36 bp, 100 bp
     variable-length and 1000 bp reads); results must be exactly equal;
     times are CUDA-event medians;
  3. the main path: compress_bytes -> decompress_bytes with device="cuda" on
     --mb MB of synthetic ERR005195 36 bp reads, an SRR-style 76 bp corpus
     whose DNA stream is Huffman-coded, variable-length 100 bp reads,
     1000 bp reads and SOLiD colour-space reads, each byte-identical, with
     every kernel variant launched and no plain version run on a CUDA
     tensor;
  4. the committed golden containers tiny_v1 / tiny_v2 / titles_v3 /
     longread_v4 decode to their inputs, and the titles_v3 input re-encodes
     to phyngsc_tpu's bytes (by SHA-256).
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must never import jax

import numpy as np  # noqa: E402
import torch  # noqa: E402

from phyngsc_tpu_torch import (CodecConfig, host_runtime, kernels,  # noqa: E402
                               synthesize_fastq)
from phyngsc_tpu_torch.models import dna, quality  # noqa: E402
from phyngsc_tpu_torch.ops import bitpack, histogram, lookup  # noqa: E402
from phyngsc_tpu_torch.pipeline import compress, subblock  # noqa: E402
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
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
}


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

        def record(sym, tab):
            self.lookups.append((sym.clone(), tab.clone()))
            return launch(sym, tab)

        kernels.lookup = record
        try:
            b = subblock.stage_b(self.a, self.cfg)
        finally:
            kernels.lookup = launch
        self.p = subblock._decode_parse(subblock.stage_c(b, self.cfg),
                                        self.cfg)
        self.lens = subblock._record_lens(self.p.lens_np, self.p.Rp, dev)

    def describe(self, what: str) -> None:
        p = self.p
        print(f"{what} sub-block: R={p.R} Rp={p.Rp} Lt={p.Lt} L={p.L} "
              f"G={self.G} S={p.Rp // self.G} variable={p.variable} "
              f"delta={p.is_delta} quality trees={p.q_tables.n_trees} "
              f"dna mode={p.d_plan.mode} lookups="
              f"{[tuple(t.shape) for _, t in self.lookups]}", flush=True)


def compare(name: str, kernel_fn, plain_fn, reps: int, plain_reps: int):
    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
    require(err == 0, f"{name}: kernel differs from its plain version "
            f"(max abs err {err})")
    case = {"case": name, "shape": list(got.shape), "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, reps), "plain_ms": cuda_ms(plain_fn, plain_reps)}
    print(f"kernel check: {json.dumps(case)}", flush=True)
    return case


def phase_kernels(dev) -> dict:
    bits = CodecConfig().max_code_len
    cases = {k: [] for k in KERNELS}

    def k1(name, sym, mask, A):
        mask = mask.to(torch.uint8).contiguous()
        cases["k1_histogram"].append(compare(
            name, lambda: kernels.histogram(sym, mask, A),
            lambda: histogram.position_histogram_plain(sym, mask, A), 20, 5))

    def k2(name, f):
        p, G = f.p, f.G
        S = p.q_sub.shape[0]
        q_words = subblock._upload_words(p.q_words, dev)
        q_sub = torch.from_numpy(p.q_sub).to(dev)
        q_start = bitpack.word_starts(q_sub)
        totals = f.lens.reshape(S, G).sum(dim=1, dtype=torch.int32)
        luts = torch.from_numpy(p.q_tables.luts(bits)).to(dev)
        tid = quality.tree_of_position(torch.arange(p.Lt, device=dev),
                                       p.q_tables.n_trees, p.L).to(torch.int32)
        cases["k2_walk_uniform"].append(compare(
            name,
            lambda: kernels.walk_uniform(q_words, q_start, totals, luts, tid,
                                         bits, G, p.Lt, p.L),
            lambda: bitpack.walk_uniform_plain(q_words, q_sub, totals, luts,
                                               tid, bits, G, p.Lt, p.L),
            20, 3))

    def k3(name, f, variant):
        """variant: plain2 / huffman (DNA, after the quality decode) or
        quality (variable-length quality, per-position trees)."""
        p, G = f.p, f.G
        S = p.q_sub.shape[0]
        q_words = subblock._upload_words(p.q_words, dev)
        q_sub = torch.from_numpy(p.q_sub).to(dev)
        q_luts = torch.from_numpy(p.q_tables.luts(bits)).to(dev)
        valid = quality.valid_mask(f.lens, p.L)
        if variant == "quality":
            words, sub, keep, luts = q_words, q_sub, valid, q_luts
            tid = quality.tree_of_position(torch.arange(p.L, device=dev),
                                           p.q_tables.n_trees, p.L).to(
                                               torch.int32)
        else:
            if p.variable:
                qual_t = quality.decode_walk_masked(q_words, q_sub, f.lens,
                                                    q_luts, p.L, G, bits)
            else:
                qual_t = quality.decode_walk(q_words, q_sub, f.lens, q_luts,
                                             p.L, p.Lt, G, bits)
            keep = (qual_t < 128) & valid
            words = subblock._upload_words(p.d_words, dev)
            sub = torch.from_numpy(p.d_sub).to(dev)
            luts = (None if variant == "plain2" else
                    torch.from_numpy(p.d_plan.luts(bits)).to(dev))
            tid = (None if variant == "plain2" else
                   torch.zeros(1, dtype=torch.int32, device=dev))
        keep = keep.to(torch.uint8).reshape(S, -1).contiguous()
        start = bitpack.word_starts(sub)
        tot = keep.sum(dim=1, dtype=torch.int32)
        plain2 = variant == "plain2"
        cases["k3_walk_masked"].append(compare(
            name,
            lambda: kernels.walk_masked(words, start, tot, keep, luts, tid,
                                        bits, plain2),
            lambda: bitpack.walk_masked_plain(words, sub, keep, luts, tid,
                                              bits, plain2),
            20, 3))

    def k4(name, sym, tab):
        cases["k4_lookup"].append(compare(
            name, lambda: kernels.lookup(sym, tab),
            lambda: lookup.fused_lookup_plain(sym, tab), 20, 5))

    err = FirstSubblock(synthesize_fastq(70000, read_len=36, seed=1), dev)
    err.describe("ERR005195 36 bp")
    a = err.a
    k1("k1 quality A=256", a.qual_t, quality.valid_mask(a.lens, a.L), 256)
    k1("k1 dna keep A=128", a.seq, a.keep, 128)
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

    long_ = FirstSubblock(synthesize_fastq(5000, read_len=1000, seed=4), dev)
    long_.describe("1000 bp")
    a = long_.a
    require(a.L == 1000, "1000 bp sub-block is not L = 1000")
    k1("k1 quality L=1000", a.qual_t, quality.valid_mask(a.lens, a.L), 256)
    k2("k2 quality walk L=1000", long_)
    k4(f"k4 quality L=1000 A={long_.lookups[0][1].shape[1]}",
       *long_.lookups[0])
    return cases


def round_trip(data: bytes, dev, what: str) -> None:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = compress.compress_bytes(data, CodecConfig(), 1, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = decompress_bytes(comp, None, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    require(back == data, f"{what}: round trip is not byte-identical")
    mb = len(data) / 1e6
    print(f"round trip {what}: {len(data)} B -> {len(comp)} B, ratio "
          f"{len(data) / len(comp):.4f}, compress {mb / (t1 - t0):.2f} MB/s "
          f"({t1 - t0:.3f} s), decompress {mb / (t2 - t1):.2f} MB/s "
          f"({t2 - t1:.3f} s), byte-identical", flush=True)


def phase_round_trip(dev, mb: int) -> dict:
    corpora = [
        (f"ERR005195 36 bp {mb} MB", corpus_of(
            mb, lambda n: synthesize_fastq(n, read_len=36, seed=5))),
        ("SRR-style 76 bp (DNA Huffman)",
         srr_huffman_corpus(int(mb * 1e6 / 8 / 200), seed=6)),
        ("variable-length 100 bp", corpus_of(64, lambda n: synthesize_fastq(
            n, read_len=100, seed=7, variable_length=True))),
        ("1000 bp", corpus_of(64, lambda n: synthesize_fastq(
            n, read_len=1000, seed=8))),
        ("SOLiD colour space 50", corpus_of(16, lambda n: solid_corpus(n, 9))),
    ]
    kernels.reset_counts()
    for what, data in corpora:
        round_trip(data, dev, what)
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_ON_CUDA)
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    print(f"plain versions run on CUDA tensors: {json.dumps(plain)}",
          flush=True)
    require(all(v > 0 for v in launches.values()),
            "a kernel of the main path was never launched")
    require(not any(plain.values()),
            "a plain version ran on a CUDA tensor in the main path")
    return launches


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

    cases = phase_kernels(dev)
    launches = phase_round_trip(dev, args.mb)
    phase_goldens(dev)
    require("jax" not in sys.modules or sys.modules["jax"] is None,
            "jax was imported")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        c = cases[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(x["max_abs_err"] for x in c),
                     "ms": c[0]["ms"], "plain_ms": c[0]["plain_ms"],
                     "cases": c})
    print(card)  # name, power limit: exactly as nvidia-smi prints them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

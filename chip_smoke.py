#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (phyngsc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--mb 256]

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA / nvcc
     versions, and the kernels' build time;
  2. each hand-written kernel (K1 histogram, K2 uniform walk, K3 masked walk
     in its plain2 and Huffman variants) against its plain PyTorch version
     on the card, at the shapes of one default 8 MiB sub-block; results must
     be exactly equal; times are CUDA-event medians;
  3. the main path: compress_bytes -> decompress_bytes with device="cuda" on
     --mb MB of synthetic ERR005195 36 bp reads (plus a smaller SRR-style
     76 bp corpus whose DNA stream is Huffman-coded), byte-identical, with
     every kernel launched and no plain version run on a CUDA tensor;
  4. the committed golden containers tiny_v1 / tiny_v2 / titles_v3 decode to
     their inputs, and the titles_v3 input re-encodes to phyngsc_tpu's bytes
     (by SHA-256).
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
from phyngsc_tpu_torch.ops import bitpack, histogram  # noqa: E402
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


def first_subblock(data: bytes, cfg: CodecConfig, dev):
    """Stage A of the first default sub-block of `data`, its payload and
    its parse: the main path's shapes."""
    buf = np.frombuffer(data, np.uint8)
    regions = compress.partition_regions(buf, 1, cfg)
    _, idx = next(compress.iter_subblock_tasks(buf, regions, cfg))
    a = subblock.stage_a(buf, idx, cfg, dev)
    payload = subblock.stage_c(subblock.stage_b(a, cfg), cfg)
    return a, subblock._decode_parse(payload, cfg)


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
    cfg = CodecConfig()
    G = cfg.records_per_substream
    bits = cfg.max_code_len
    cases = {k: [] for k in KERNELS}

    def lens_of(p):
        return subblock._uniform_lens(p.R, p.Rp, p.Lt, dev)

    err = synthesize_fastq(70000, read_len=36, seed=1)
    a, p = first_subblock(err, cfg, dev)
    print(f"main-path sub-block: R={a.R} Rp={a.Rp} L={a.L} S={a.Rp // G} "
          f"quality trees={p.q_tables.n_trees} dna mode={p.d_plan.mode}",
          flush=True)
    valid8 = quality.valid_mask(a.lens, a.L).to(torch.uint8).contiguous()
    keep8 = a.keep.to(torch.uint8).contiguous()
    cases["k1_histogram"].append(compare(
        "k1 quality A=256",
        lambda: kernels.histogram(a.qual_t, valid8, 256),
        lambda: histogram.position_histogram_plain(a.qual_t, valid8, 256),
        20, 5))
    cases["k1_histogram"].append(compare(
        "k1 dna keep A=128",
        lambda: kernels.histogram(a.seq, keep8, 128),
        lambda: histogram.position_histogram_plain(a.seq, keep8, 128),
        20, 5))

    S = p.q_sub.shape[0]
    q_words = subblock._upload_words(p.q_words, dev)
    q_sub = torch.from_numpy(p.q_sub).to(dev)
    q_start = bitpack.word_starts(q_sub)
    totals = lens_of(p).reshape(S, G).sum(dim=1, dtype=torch.int32)
    luts = torch.from_numpy(p.q_tables.luts(bits)).to(dev)
    tid = quality.tree_of_position(torch.arange(p.Lt, device=dev),
                                   p.q_tables.n_trees, p.L).to(torch.int32)
    cases["k2_walk_uniform"].append(compare(
        "k2 quality walk",
        lambda: kernels.walk_uniform(q_words, q_start, totals, luts, tid,
                                     bits, G, p.Lt, p.L),
        lambda: bitpack.walk_uniform_plain(q_words, q_sub, totals, luts, tid,
                                           bits, G, p.Lt, p.L),
        20, 3))

    def masked_case(name, p, plain2):
        qual_t = quality.decode_walk(
            subblock._upload_words(p.q_words, dev),
            torch.from_numpy(p.q_sub).to(dev), lens_of(p),
            torch.from_numpy(p.q_tables.luts(bits)).to(dev), p.L, p.Lt, G,
            bits)
        keep = ((qual_t < 128) & quality.valid_mask(lens_of(p), p.L)).to(
            torch.uint8).reshape(p.d_sub.shape[0], -1).contiguous()
        words = subblock._upload_words(p.d_words, dev)
        sub = torch.from_numpy(p.d_sub).to(dev)
        start = bitpack.word_starts(sub)
        tot = keep.sum(dim=1, dtype=torch.int32)
        lut = None if plain2 else torch.from_numpy(p.d_plan.luts(bits)[0]).to(dev)
        return compare(
            name,
            lambda: kernels.walk_masked(words, start, tot, keep, lut, bits,
                                        plain2),
            lambda: bitpack.walk_masked_plain(words, sub, keep, lut, bits,
                                              plain2),
            20, 3)

    require(p.d_plan.mode == dna.MODE_PLAIN, "ERR005195 DNA plan is not plain")
    cases["k3_walk_masked"].append(masked_case("k3 dna plain2", p, True))

    _, ph = first_subblock(srr_huffman_corpus(40000, seed=2), cfg, dev)
    require(ph.d_plan.mode == dna.MODE_HUFFMAN,
            "SRR corpus with high-quality N did not take DNA Huffman mode")
    cases["k3_walk_masked"].append(masked_case("k3 dna huffman", ph, False))
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
    per_rec = len(synthesize_fastq(1000, read_len=36, seed=5)) / 1000
    data = synthesize_fastq(int(mb * 1e6 / per_rec), read_len=36, seed=5)
    srr = srr_huffman_corpus(int(mb * 1e6 / 8 / 200), seed=6)
    kernels.reset_counts()
    round_trip(data, dev, f"ERR005195 36 bp {mb} MB")
    round_trip(srr, dev, "SRR-style 76 bp (DNA Huffman)")
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
              "titles_v3.ngsct": titles_input()}
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

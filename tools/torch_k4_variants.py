#!/usr/bin/env python3
"""K4 (csrc/lookup.cu) against variants of its design, on one GPU.

    python3 tools/torch_k4_variants.py [--reps 50]

Run from the root of a checkout. Each variant is the checkout's own
csrc/lookup.cu with text substitutions, built by nvcc (all variants at once)
into its own library under build/k4_variants/ and launched through ctypes on
the K4 inputs of chip_smoke.py: the tables and tree ids stage B uploads for
the first sub-block of the ERR005195 36 bp corpus (quality, A = 256), of the
same corpus without IUPAC bases (A = 64), of the SRR-style corpus (DNA,
A = 64, no tree ids), of 1000 bp reads and of 65,532 bp reads. Per case and
variant it prints the profiler's device time of the kernel (mean of --reps
launches) and whether the result equals the plain version's. Variants:

- as built: 512 threads a block, 16-byte loads through each warp's tile in
  shared memory, 16-byte stores of neighbouring lanes on neighbouring
  addresses, the next span loaded before the current one is looked up, a
  grid of the resident blocks;
- 1024 threads, 256 threads: larger or smaller blocks, fewer or more of
  them, each staging the tables;
- whole spans: the fewest blocks that give every warp the same whole number
  of spans (fewer blocks staging the tables, fewer warps in flight);
- 4-byte loads: each lane loads the 4 symbols of each of its groups
  straight from device memory (no tile, no 16-byte load);
- direct stores: each lane looks up its own 16 symbols and stores their
  entries itself, 64 bytes a lane, so the lanes of one store instruction
  are 64 bytes apart;
- streaming stores: the 16-byte stores marked evict-first (__stcs);
- no prefetch: each span is loaded when its turn comes.

Imports neither jax nor phyngsc_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.modules["jax"] = None
sys.modules["phyngsc_tpu"] = None
sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from phyngsc_tpu_torch import kernels, synthesize_fastq  # noqa: E402
from phyngsc_tpu_torch.ops import lookup  # noqa: E402

LOOP_LOAD = "    if (sp + kWarps < sp1) v = __ldg(src + (sp + kWarps) * 32);\n"
FIRST_LOAD = "  if (sp < sp1) v = __ldg(src + sp * 32);\n"
TILE_STORE = "    tile[lane] = v;\n"
GRID = ("  const int blocks = std::max(1, std::min(per_sm * "
        "phyngsc::sm_count(),\n"
        "                                          (spans + kWarps - 1) / "
        "kWarps));\n")
LOOKUP = ("      dst[32 * j] = entries4<kTrees>(words[32 * j], s_tab, s_ids, "
          "A, q, L);\n")
VARIANTS = {
    "as built": [],
    "1024 threads": [("constexpr int kThreads = 512;",
                      "constexpr int kThreads = 1024;")],
    "256 threads": [("constexpr int kThreads = 512;",
                     "constexpr int kThreads = 256;")],
    "whole spans": [(GRID, "  const int resident = per_sm * phyngsc::sm_count();\n"
                           "  const int each = std::max(1, (spans + resident * "
                           "kWarps - 1) / (resident * kWarps));\n"
                           "  const int blocks = std::max(1, (spans + each * "
                           "kWarps - 1) / (each * kWarps));\n")],
    "4-byte loads": [
        (FIRST_LOAD, ""), (LOOP_LOAD, ""), (TILE_STORE, ""),
        (LOOKUP, "      dst[32 * j] = entries4<kTrees>(__ldg(reinterpret_cast"
                 "<const uint32_t*>(sym + sp * kSpan) + 32 * j + lane), "
                 "s_tab, s_ids, A, q, L);\n")],
    "direct stores": [
        (TILE_STORE, "    const uint4 cur = v;\n"),
        ("  unsigned p = kTrees ? (sp * kSpan + 4 * lane) % L : 0;",
         "  unsigned p = kTrees ? (sp * kSpan + 16 * lane) % L : 0;"),
        ("  const unsigned group = kTrees ? 128 % L : 0;",
         "  const unsigned group = kTrees ? 4 % L : 0;"),
        ("    int4* dst = reinterpret_cast<int4*>(out + sp * kSpan) + lane;",
         "    int4* dst = reinterpret_cast<int4*>(out + sp * kSpan) + 4 * lane;"),
        (LOOKUP, "      dst[j] = entries4<kTrees>((&cur.x)[j], s_tab, s_ids, "
                 "A, q, L);\n")],
    "streaming stores": [
        (LOOKUP, "      __stcs(dst + 32 * j, entries4<kTrees>(words[32 * j], "
                 "s_tab, s_ids, A, q, L));\n")],
    "no prefetch": [(FIRST_LOAD, ""), (LOOP_LOAD, ""),
                    (TILE_STORE, "    tile[lane] = __ldg(src + sp * 32);\n")],
}
OUT = os.path.join(os.getcwd(), "build", "k4_variants")


def variant_source(name: str, subs) -> str:
    with open(os.path.join(kernels.SRC_DIR, "lookup.cu")) as f:
        src = f.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name!r}: the source no longer holds "
                             f"{old!r} once")
        src = src.replace(old, new)
    tag = name.replace(" ", "_")
    cu = os.path.join(OUT, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(src)
    return cu


def build_all() -> dict:
    """One nvcc per variant, all started together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        cu = variant_source(name, subs)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.SRC_DIR,
             "-o", cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r}: nvcc failed\n{log}")
        dll = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        dll.phyngsc_lookup.argtypes = [P, P, P, I, I, I, I, P, P]
        dll.phyngsc_lookup.restype = I
        libs[name] = dll
    return libs


def launcher(dll, sym, tab, tree):
    R, L = sym.shape
    T, A = tab.shape

    def run():
        out = torch.empty((R, L), dtype=torch.int32, device=sym.device)
        rc = dll.phyngsc_lookup(sym.data_ptr(), tab.data_ptr(),
                                None if T == 1 else tree.data_ptr(), R * L,
                                L, A, T, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_all()
    FS = chip_smoke.FirstSubblock
    err = FS(synthesize_fastq(70000, read_len=36, seed=1), dev)
    clean = FS(synthesize_fastq(70000, read_len=36, seed=1,
                                ambiguity_rate=0.0), dev)
    srr = FS(chip_smoke.srr_huffman_corpus(40000, seed=2), dev)
    long_ = FS(synthesize_fastq(5000, read_len=1000, seed=4), dev)
    reads = FS(chip_smoke.long_read_corpus(16, seed=11), dev)
    cases = {"quality A=256": err.lookups[0], "quality A=64": clean.lookups[0],
             "dna huffman": srr.lookups[1], "quality L=1000": long_.lookups[0],
             "quality L=65532": reads.lookups[0]}
    print(f"nvidia-smi: {chip_smoke.smi()}", flush=True)
    print(f"card: {torch.cuda.get_device_name(0)}; device ms a launch "
          f"(profiler, mean of {args.reps}), = when equal to the plain "
          "version", flush=True)
    for case, (sym, tab, tree) in cases.items():
        print(f"case {case}: symbols {tuple(sym.shape)} table "
              f"{tuple(tab.shape)} ids {tree is not None}", flush=True)
    for name, dll in libs.items():
        for case, (sym, tab, tree) in cases.items():
            run = launcher(dll, sym, tab, tree)
            equal = torch.equal(run(), lookup.fused_lookup_plain(sym, tab,
                                                                 tree))
            ms = chip_smoke.device_ms(run, args.reps, "lookup_kernel")
            shown = "not in the trace" if ms is None else f"{ms:.5f} ms"
            print(f"  {name:16s} {case:16s} {shown} "
                  f"{'=' if equal else 'differs'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

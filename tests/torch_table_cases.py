"""Seeded code-length sets of the decode-table tests: test_torch_tables.py
holds the plain versions to the JAX package on the CPU with them, and
test_torch_cuda.py holds K6 to its plain version on the card, where jax
is absent."""

import numpy as np
import torch

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.ops import bitpack_host, huffman, tables

KINDS = ["zipf", "incomplete", "all 256", "long codes"]


def trees(T: int, bits: int, kind: str, seed: int):
    """(lens (T, 256) uint8, singletons (T,) int32) of T trees: zipf trees
    of 2 .. 120 symbols with an empty tree first and a singleton second
    (where T allows; tests/test_lookup.py's mix); complete codes with about
    a third of their symbols dropped (incomplete); all 256 symbols present;
    or heavy zipf counts whose codes reach `bits`."""
    rng = np.random.default_rng(seed)
    freqs = np.zeros((T, 256), np.int64)
    for t in range(T):
        if kind == "all 256":
            freqs[t] = rng.integers(1, 1000, size=256)
        elif kind == "long codes":
            freqs[t] = rng.zipf(1.1, size=256) + (rng.random(256) < 0.9)
        else:
            n = int(rng.integers(2, 121))
            idx = rng.choice(256, size=n, replace=False)
            freqs[t, idx] = np.maximum(rng.zipf(1.5, size=n), 1)
    if kind == "zipf":
        freqs[0] = 0
        if T > 1:
            freqs[1] = 0
            freqs[1, int(rng.integers(0, 256))] = 5
    lens = huffman.build_code_lengths_batch(freqs, bits)
    sing = huffman.singleton_of_batch(freqs)
    if kind == "incomplete":
        drop = (rng.random(lens.shape) < 0.33) & (lens > 0)
        lens = np.where(drop, 0, lens).astype(np.uint8)
        for t in range(T):  # two symbols or more stay
            if np.count_nonzero(lens[t]) < 2:
                lens[t, :2] = 1
    return lens, sing


#: (n_ids of the walk, trees): K3's one DNA tree, K2 at 36 bp, K3 over
#: variable 100 bp and 1000 bp reads
TWO_LEVEL = [(1, 1), (36, 36), (kernels.masked_ids(100), 100),
             (kernels.masked_ids(1000), 128)]
#: budgets below the walks' that take 36 trees through smaller k, the
#: shared block of escapes and no table at all (k = 0)
SMALL_BUDGETS = [40000, 20000, 8000, 3000, 1000, 600, 0]


#: (quality trees, their kind, the walk's tree ids; the DNA stream's kind,
#: or None for a plain-DNA sub-block) of the two-stream table build: ERR's
#: 36 trees, 1000 bp's 128, the 65,532 bp reads' 128 (at 12 bits, with the
#: shared block of escapes), one tree
TWO_STREAMS = [(36, "zipf", 36, "long codes"), (36, "zipf", 36, None),
               (128, "incomplete", kernels.masked_ids(1000), "zipf"),
               (128, "long codes", kernels.masked_ids(65532), None),
               (1, "all 256", 1, "long codes")]
TWO_STREAM_BITS = [8, 10, 12, 14, 16]


def wire_pieces(lens, sing, bits: int, budget: int) -> tuple:
    """A stream's LensWire laid out at `budget` and its uploaded pieces on
    the CPU: (wire, words, rows)."""
    words = bitpack_host.pack_lens4_np(lens, sing).view(np.int32)
    wire = tables.LensWire(words, lens.shape[0], bits,
                           tables.two_level_layout(lens, sing, bits, budget))
    return (wire, *(torch.from_numpy(p) for p in wire.pieces()))


def two_streams(T: int, kind: str, n_ids: int, dna_kind, bits: int) -> tuple:
    """The (q, d) pieces of a TWO_STREAMS case at lut_bits `bits` (d None
    without a DNA stream); code lengths capped at 15, the nibble's
    largest."""
    cap = min(bits, 15)
    lens, sing = trees(T, cap, kind, seed=T + bits)
    q = wire_pieces(lens, sing, bits, kernels.table_budget(n_ids))
    if dna_kind is None:
        return q, None
    dl, ds = trees(1, cap, dna_kind, seed=bits)
    return q, wire_pieces(dl, ds, bits, kernels.table_budget(1))

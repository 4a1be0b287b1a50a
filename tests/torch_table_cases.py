"""Seeded code-length sets of the decode-table tests: test_torch_tables.py
holds the plain versions to the JAX package on the CPU with them, and
test_torch_cuda.py holds K6 to its plain version on the card, where jax
is absent."""

import numpy as np

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.ops import huffman

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

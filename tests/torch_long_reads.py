"""Nanopore-like long reads for the port's tests: uniform ACGT bases,
phred+33 qualities skewed low and drifting along the read (the benchmark's
ont_long generator's model), MinKNOW-like titles; lengths as given, four
reads a sub-block under CFG, so that a test picks each sub-block's longest
read. The first read of each set is 700 bp, so auto_substream takes G = 8,
as it does for nanopore batches."""

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

#: the codec fields of the sets below: four reads a sub-block, and two
#: host threads (the CPU's torch ops take the cores)
CFG = dict(subblock_input_bytes=1 << 20, max_records_per_subblock=4,
           auto_substream=True, host_workers=2)
#: four sub-blocks whose longest reads, 700 to 1,500 bp, take three rungs
#: of the ladder: short enough for the JAX package's compress on the CPU
SHORTER = [700, 300, 600, 520, 900, 1100, 400, 800,
           1500, 200, 640, 300, 1300, 1000, 350, 500]
#: five sub-blocks, one with a read of 65,532 bp (the longest multiple of 4
#: that the container holds); the last two longest reads share a rung
LONGEST = [700, 300, 1900, 2600, 65532, 900, 400, 500,
           5100, 4000, 900, 3000, 800, 1100, 400, 2200,
           1200, 2500, 2400, 600]


def long_reads(lengths, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        seq = ACGT[rng.integers(0, 4, size=n)]
        z = np.minimum(rng.zipf(1.5, size=n) - 1, 59)
        drift = np.arange(n) * 30 // n
        qual = (33 + np.minimum(z + drift, 60)).astype(np.uint8)
        out += [f"@{i:08x}-long runid=0f ch={1 + i % 512} read={i}\n"
                .encode(), seq.tobytes(), b"\n+\n", qual.tobytes(), b"\n"]
    return b"".join(out)

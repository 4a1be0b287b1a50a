"""ERR005195-style FASTQ: BGI Illumina GA reads of one length, the shape of
pcdslab/PHYNGSC's own test input (input10MB.fastq).

Rewritten from the codec's synthesize_fastq(style="ERR005195"): titles
"@ERR005195.<n> BGI-FC30BFTAAXX_5_1_000:<x>/2" with n counting the records
of all the cell's files and x uniform in [0, 2048); uniform ACGT bases of
which a share, by default 0.2%, is an IUPAC code from "YRWSKMDVHBNXU.-"
with a quality in [33, 40]; other qualities in [33, 73], skewed to 'I' by
weights linspace(0.2, 4.0, 41) ** 4. Everything is drawn in bulk: one
file of 2 million records takes about a second.
"""

from __future__ import annotations

import numpy as np

from portbench.generators.fastq import Records, rng_for, table_sampler

IUPAC = np.frombuffer(b"YRWSKMDVHBNXU.-", np.uint8)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def generate(params: dict, seed: int, index: int) -> bytes:
    """File `index` of the cell's inputs for run seed `seed`."""
    R, L = int(params["records_per_file"]), int(params["read_len"])
    rng = rng_for(seed, index)
    quals = np.arange(33, 74, dtype=np.uint8)
    weights = np.linspace(0.2, 4.0, quals.shape[0]) ** 4
    qual = table_sampler(quals, weights)(rng, R * L)
    seq = ACGT[rng.integers(0, 4, size=R * L, dtype=np.uint8)]
    n_amb = rng.binomial(R * L, float(params["ambiguity_rate"]))
    at = rng.choice(R * L, size=n_amb, replace=False) if n_amb < R * L // 8 \
        else np.flatnonzero(rng.random(R * L) < params["ambiguity_rate"])
    seq[at] = IUPAC[rng.integers(0, IUPAC.shape[0], size=at.shape[0])]
    qual[at] = rng.integers(33, 41, size=at.shape[0]).astype(np.uint8)
    rec = Records(R)
    rec.text(b"@ERR005195.")
    rec.number(np.arange(R, dtype=np.int64) + index * R + 1)
    rec.text(b" BGI-FC30BFTAAXX_5_1_000:")
    rec.number(rng.integers(0, 2048, size=R))
    rec.text(b"/2\n")
    rec.fixed(seq.reshape(R, L))
    rec.text(b"\n+\n")
    rec.fixed(qual.reshape(R, L))
    rec.text(b"\n")
    return rec.build()

"""Oxford Nanopore long reads in MinKNOW FASTQ batches, the shape of the
Nanopore WGS Consortium's NA12878 R9.4 1D reads (Jain et al., Nat
Biotechnol 36:338, 2018).

Read lengths are log-normal, mu and sigma from the configuration (the
defaults give a read N50 of about 10 kb and a mean of about 0.7 of it),
clipped to [min_len, max_len]. Each file's set of lengths comes from the
configuration's length_seed and the file's index alone, so every run seed
gives the same bytes of work; the run seed shuffles their order and draws
everything else. Bases are uniform ACGT (plain 2-bit DNA). Qualities are
phred+33, skewed and drifting along the read as in the codec's long-read
corpus: 33 + min(z + 30 * pos // len, 60), z a Zipf(1.5) draw less one
(k = z + 1 in 1..60, weights k ** -1.5).
Titles are MinKNOW's: "@<uuid> runid=<40 hex> read=<n> ch=<1..512>
start_time=<ISO 8601>".
"""

from __future__ import annotations

import numpy as np

from portbench.generators.fastq import rng_for, table_sampler

ACGT = np.frombuffer(b"ACGT", np.uint8)
HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def lengths(params: dict, index: int) -> np.ndarray:
    """The read lengths of file `index`, in a fixed order."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(params["length_seed"]), index]))
    n = int(params["reads_per_file"])
    raw = rng.lognormal(float(params["mu"]), float(params["sigma"]), size=n)
    return np.clip(np.rint(raw), params["min_len"],
                   params["max_len"]).astype(np.int64)


def n50(lens: np.ndarray) -> int:
    """The length at which the reads this long or longer hold half of the
    bases."""
    s = np.sort(lens)[::-1]
    return int(s[np.searchsorted(np.cumsum(s), s.sum() / 2)])


def _hex(rng: np.random.Generator, n: int, width: int) -> list:
    return [b.tobytes() for b in HEX[rng.integers(0, 16, size=(n, width))]]


def generate(params: dict, seed: int, index: int) -> bytes:
    rng = rng_for(seed, index)
    lens = rng.permutation(lengths(params, index))
    n, total = lens.shape[0], int(lens.sum())
    seq = ACGT[rng.integers(0, 4, size=total, dtype=np.uint8)]
    k = np.arange(1, 61, dtype=np.float64)
    z = table_sampler(np.arange(60, dtype=np.uint8), k ** -1.5)(rng, total)
    uuid = _hex(rng, n, 32)
    runid = _hex(rng, 1, 40)[0].decode()
    ch = rng.integers(1, 513, size=n)
    t0 = 1488326400 + int(rng.integers(0, 86400 * 20))
    t = t0 + np.cumsum(rng.integers(0, 4, size=n))
    read = np.cumsum(rng.integers(1, 40, size=n))
    ends = np.cumsum(lens)
    out = []
    for i in range(n):
        u = uuid[i].decode()
        s = int(t[i])
        day, rem = divmod(s - 1488326400, 86400)  # days since 2017-03-01
        title = (f"@{u[:8]}-{u[8:12]}-{u[12:16]}-{u[16:20]}-{u[20:]} "
                 f"runid={runid} read={read[i]} ch={ch[i]} start_time="
                 f"2017-03-{day + 1:02d}T{rem // 3600:02d}:"
                 f"{rem // 60 % 60:02d}:{rem % 60:02d}Z\n").encode()
        a, b = ends[i] - lens[i], ends[i]
        drift = np.arange(lens[i], dtype=np.int32) * 30 // lens[i]
        qual = 33 + np.minimum(z[a:b] + drift, 60)
        out += [title, seq[a:b].tobytes(), b"\n+\n",
                qual.astype(np.uint8).tobytes(), b"\n"]
    return b"".join(out)

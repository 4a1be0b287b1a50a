"""What the FASTQ generators share: the seeding, a sampler of a discrete
distribution, and a builder of many short records at once."""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, index: int) -> np.random.Generator:
    """The generator of file `index` of a run seeded `seed` (any whole
    number, however large)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), index]))


def table_sampler(values: np.ndarray, weights: np.ndarray):
    """A sampler of `values` with probabilities `weights` (normalised), by
    an inverse-CDF table of 2^16 entries: each draw is one uint16 and one
    lookup, so tens of millions take a fraction of a second. The
    probabilities are kept to 2^-16."""
    cdf = np.cumsum(np.asarray(weights, np.float64))
    cdf /= cdf[-1]
    u = (np.arange(1 << 16) + 0.5) / (1 << 16)
    table = np.asarray(values)[np.searchsorted(cdf, u, side="right")]

    def draw(rng: np.random.Generator, n: int) -> np.ndarray:
        return table[rng.integers(0, 1 << 16, size=n, dtype=np.uint16)]
    return draw


_DIGITS4 = np.array([list(b"%04d" % i) for i in range(10000)], np.uint8)


class Records:
    """R records built column by column, then laid end to end: constant
    text, decimal numbers and fixed-width byte columns. Each column takes
    its widest width in every row of one matrix, written a column slice
    at a time; the unused leading bytes of the narrower numbers are then
    deleted from the flattened matrix in one pass."""

    def __init__(self, R: int):
        self.R = R
        #: ((R, width) uint8, None, or (R,) the unused leading bytes)
        self.cols = []

    def text(self, s: bytes) -> None:
        self.cols.append((np.frombuffer(s, np.uint8)[None, :], None))

    def number(self, v: np.ndarray) -> None:
        """Decimal digits of non-negative v, right-aligned in the column,
        four at a time from a table."""
        v = np.asarray(v, np.int64)
        chunks = []
        while True:
            chunks.append(_DIGITS4[v % 10000])
            v = v // 10000
            if not v.any():
                break
        digits = np.concatenate(chunks[::-1], axis=1)
        nz = digits != 48
        # the leading zeros, but a 0 keeps its one digit
        lead = np.where(nz.any(axis=1), np.argmax(nz, axis=1),
                        digits.shape[1] - 1)
        self.cols.append((digits, lead))

    def fixed(self, mat: np.ndarray) -> None:
        self.cols.append((np.asarray(mat, np.uint8), None))

    def build(self) -> bytes:
        R = self.R
        widths = [c.shape[1] for c, _ in self.cols]
        W = sum(widths)
        M = np.empty((R, W), np.uint8)
        at, unused = 0, []
        for (c, lead), w in zip(self.cols, widths):
            M[:, at:at + w] = c
            if lead is not None:
                rows, k = np.nonzero(np.arange(w)[None, :] < lead[:, None])
                unused.append(rows.astype(np.int64) * W + at + k)
            at += w
        flat = M.reshape(-1)
        if unused:
            flat = np.delete(flat, np.concatenate(unused))
        return flat.tobytes()

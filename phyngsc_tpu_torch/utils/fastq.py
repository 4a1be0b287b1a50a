# Copied from phyngsc_tpu/utils/fastq.py; imports point at phyngsc_tpu_torch.
"""FASTQ parsing, record indexing and test-data synthesis.

Host-side equivalent of the reference's OpenMP record indexer (C3,
phyNGSC.cpp:254-331): find every record's title/sequence/quality spans in a
byte buffer. The reference scans byte-by-byte across threads; here the scan is
a vectorized newline search (numpy) with an optional native C++ fast path
(native/host_runtime.cpp), producing structure-of-arrays offsets ready for
device batching.

FASTQ shape contract (reference README.md:95-102): records are exactly 4 lines
(@title / sequence / '+' / quality), the third line is '+' only, and the
quality line has the same length as the sequence line.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEWLINE = 0x0A
TITLE_MARK = ord("@")
PLUS_MARK = ord("+")


class FastqFormatError(ValueError):
    pass


@dataclasses.dataclass
class RecordIndex:
    """Offsets of n records inside a byte buffer (all int64, shape (n,)).

    Spans exclude newlines. Layout per record:
        @<title>\n<seq>\n+\n<qual>\n
        title: [title_start, title_end)   (includes the leading '@')
        seq:   [seq_start,   seq_end)
        qual:  [qual_start,  qual_end)
    """

    title_start: np.ndarray
    title_end: np.ndarray
    seq_start: np.ndarray
    seq_end: np.ndarray
    qual_start: np.ndarray
    qual_end: np.ndarray

    @property
    def n_records(self) -> int:
        return int(self.title_start.shape[0])

    @property
    def seq_len(self) -> np.ndarray:
        return self.seq_end - self.seq_start

    @property
    def end_offset(self) -> int:
        """Byte offset just past the final record's trailing newline."""
        return int(self.qual_end[-1]) + 1 if self.n_records else 0

    def slice(self, lo: int, hi: int) -> "RecordIndex":
        return RecordIndex(
            self.title_start[lo:hi], self.title_end[lo:hi],
            self.seq_start[lo:hi], self.seq_end[lo:hi],
            self.qual_start[lo:hi], self.qual_end[lo:hi],
        )


def index_records(buf: np.ndarray, *, validate: bool = True) -> RecordIndex:
    """Index all complete 4-line records in `buf` (uint8 array).

    The buffer must start at a record boundary and end right after the last
    complete record's newline (use `align_region_start` / truncation helpers
    for arbitrary regions). Trailing bytes past the last complete record are
    ignored.
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if validate:  # native fast path (falls back to numpy on any failure so
        from phyngsc_tpu_torch.utils import native  # the error message is exact)

        spans = native.index_records(buf, validate=True)
        if spans is not None:
            return RecordIndex(*spans)
    nl = np.flatnonzero(buf == NEWLINE)
    n_lines = nl.shape[0]
    n_records = n_lines // 4
    if n_records == 0:
        return RecordIndex(*(np.zeros(0, np.int64) for _ in range(6)))
    nl = nl[: n_records * 4].reshape(n_records, 4)
    line_start = np.empty((n_records, 4), dtype=np.int64)
    flat_nl = nl.reshape(-1)
    line_start.reshape(-1)[1:] = flat_nl[:-1] + 1
    line_start[0, 0] = 0

    idx = RecordIndex(
        title_start=line_start[:, 0].copy(),
        title_end=nl[:, 0].copy(),
        seq_start=line_start[:, 1].copy(),
        seq_end=nl[:, 1].copy(),
        qual_start=line_start[:, 3].copy(),
        qual_end=nl[:, 3].copy(),
    )

    if validate:
        if not np.all(buf[idx.title_start] == TITLE_MARK):
            bad = int(np.flatnonzero(buf[idx.title_start] != TITLE_MARK)[0])
            raise FastqFormatError(f"record {bad}: title line does not start with '@'")
        # third line must be exactly "+" (README.md:100-102: repeated-title
        # third lines are rejected by the reference; same contract here).
        plus_len = nl[:, 2] - line_start[:, 2]
        if not np.all(plus_len == 1) or not np.all(buf[line_start[:, 2]] == PLUS_MARK):
            bad = int(np.flatnonzero((plus_len != 1) | (buf[line_start[:, 2]] != PLUS_MARK))[0])
            raise FastqFormatError(f"record {bad}: third line is not a bare '+'")
        qua_len = idx.qual_end - idx.qual_start
        seq_len = idx.seq_end - idx.seq_start
        if not np.all(qua_len == seq_len):
            bad = int(np.flatnonzero(qua_len != seq_len)[0])
            raise FastqFormatError(
                f"record {bad}: quality length {int(qua_len[bad])} != sequence length {int(seq_len[bad])}"
            )
    return idx


def _is_record_start(buf: np.ndarray, pos: int) -> bool:
    """Structurally validate a candidate record start: '@'-title line, bare
    '+' third line, quality length == sequence length, and the following byte
    (if any) opens another record. The reference's scan (phyNGSC.cpp:131-156)
    accepts the first '\\n@' pair, which misfires on '@' (phred 31) inside
    quality lines; this check is strictly stronger."""
    n = buf.shape[0]
    if pos >= n or buf[pos] != TITLE_MARK:
        return False
    line_ends = []
    p = pos
    for _ in range(4):
        nxt = np.flatnonzero(buf[p : min(p + (1 << 20), n)] == NEWLINE)
        if nxt.shape[0] == 0:
            # ran off the buffer: incomplete trailing record, cannot fully
            # validate — accept; index_records drops partial tails anyway
            return True
        e = p + int(nxt[0])
        line_ends.append(e)
        p = e + 1
    t_end, s_end, p_end, q_end = line_ends
    if p_end - s_end != 2 or buf[s_end + 1] != PLUS_MARK:
        return False
    if (q_end - p_end) != (s_end - t_end):
        return False
    if p < n and buf[p] != TITLE_MARK:
        return False
    return True


def align_region_start(buf: np.ndarray, start: int, overlap: int) -> int:
    """Scan forward from `start` (within `overlap` bytes) for the first
    *validated* record start following a newline (generalized from
    phyNGSC.cpp:131-156; see `_is_record_start` for why validation is
    needed). Returns the byte offset of the '@', or -1 if none found in the
    window. `start == 0` is always a record start (reference: rank 0 starts
    at byte 0)."""
    if start == 0:
        return 0
    lo = max(0, start - 1)
    window = np.asarray(buf[lo : start + overlap], dtype=np.uint8)
    hits = np.flatnonzero((window[:-1] == NEWLINE) & (window[1:] == TITLE_MARK))
    for h in hits:
        cand = lo + int(h) + 1
        if _is_record_start(buf, cand):
            return cand
    return -1


# ---------------------------------------------------------------------------
# Test-data synthesis (the bundled input10MB.fastq was stripped from the
# reference mount; README.md:107-126 documents its shape — ERR005195, 36 bp).
# ---------------------------------------------------------------------------

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
_IUPAC = np.frombuffer(b"YRWSKMDVHBNXU.-", dtype=np.uint8)


def synthesize_fastq(
    n_records: int,
    *,
    read_len: int = 36,
    style: str = "ERR005195",
    seed: int = 0,
    ambiguity_rate: float = 0.002,
    variable_length: bool = False,
) -> bytes:
    """Generate a FASTQ byte string shaped like the reference's documented
    datasets (README.md:107-152): 'ERR005195' = 36 bp, short titles,
    phred+33 qualities skewed to 'I'; 'SRR' = 76 bp, 'length=' titles,
    leading-N reads."""
    rng = np.random.default_rng(seed)
    R = n_records
    lens = np.full(R, read_len, dtype=np.int64)
    if variable_length:
        lens = rng.integers(max(1, read_len - 8), read_len + 1, size=R)
    L = read_len

    # Quality distribution: heavily skewed to high scores like the samples.
    qual_alphabet = np.arange(33, 74, dtype=np.uint8)  # '!'..'I'
    probs = np.linspace(0.2, 4.0, qual_alphabet.shape[0]) ** 4
    probs /= probs.sum()

    seq = _DNA[rng.integers(0, 4, size=(R, L))]
    qual = qual_alphabet[rng.choice(qual_alphabet.shape[0], size=(R, L), p=probs)]
    amb = rng.random((R, L)) < ambiguity_rate
    if amb.any():
        seq[amb] = _IUPAC[rng.integers(0, len(_IUPAC), size=int(amb.sum()))]
        qual[amb] = rng.integers(33, 41, size=int(amb.sum())).astype(np.uint8)

    if style == "SRR":
        a = rng.integers(0, 8, size=R)
        b = rng.integers(0, 2048, size=R)
        titles = [
            f"@SRR013667.{i + 1} 30PTAAAXX:5:1:{a[i]}:{b[i]} length={lens[i]}".encode()
            for i in range(R)
        ]
        lead_n = rng.random(R) < 0.5
        seq[lead_n, 0] = ord("N")
        qual[lead_n, 0] = ord("#")
    else:
        b = rng.integers(0, 2048, size=R)
        titles = [
            f"@ERR005195.{i + 1} BGI-FC30BFTAAXX_5_1_000:{b[i]}/2".encode()
            for i in range(R)
        ]

    tlens = np.array([len(t) for t in titles], dtype=np.int64)
    rec_bytes = tlens + 1 + lens + 1 + 2 + lens + 1
    offs = np.concatenate([[0], np.cumsum(rec_bytes)])
    out = np.zeros(int(offs[-1]), np.uint8)
    pos = np.arange(L, dtype=np.int64)
    m = pos[None, :] < lens[:, None]
    base_t = offs[:-1]
    # titles (ragged) — short Python loop only over the title bytes
    tcat = np.frombuffer(b"".join(titles), np.uint8)
    toffs = np.concatenate([[0], np.cumsum(tlens)])
    tpos_max = int(tlens.max()) if R else 0
    tp = np.arange(tpos_max, dtype=np.int64)
    tm = tp[None, :] < tlens[:, None]
    src = (toffs[:-1][:, None] + tp[None, :])[tm]
    dst = (base_t[:, None] + tp[None, :])[tm]
    out[dst] = tcat[src]
    out[base_t + tlens] = NEWLINE
    base_s = base_t + tlens + 1
    out[(base_s[:, None] + pos[None, :])[m]] = seq[m]
    out[base_s + lens] = NEWLINE
    base_p = base_s + lens + 1
    out[base_p] = PLUS_MARK
    out[base_p + 1] = NEWLINE
    base_q = base_p + 2
    out[(base_q[:, None] + pos[None, :])[m]] = qual[m]
    out[base_q + lens] = NEWLINE
    return out.tobytes()


def records_to_text(titles, seqs, quals) -> bytes:
    """Reassemble FASTQ text from per-record byte strings (decode side)."""
    parts = []
    for t, s, q in zip(titles, seqs, quals):
        parts.append(bytes(t) + b"\n" + bytes(s) + b"\n+\n" + bytes(q) + b"\n")
    return b"".join(parts)

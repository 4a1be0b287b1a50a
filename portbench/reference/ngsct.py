"""The plain reference decoder of the .ngsct container: NumPy only.

It imports nothing of the codec. It reads the footer and the fixed-size
blocks, stitches the split sub-blocks, and decodes every sub-block's four
sections (meta, title, quality, DNA) from the format alone: the quality
stream with one canonical Huffman tree per position (or per group of
positions), the DNA stream as 2-bit ACGT or one Huffman tree over the
positions that kept their base (an IUPAC base moves into quality as a
symbol >= 128: 128 + 8 * code - 16 + (quality - 33)), the SOLiD delta
translation undone, each record rebuilt as title, bases, "+", qualities,
and each sub-block's crc32 checked. The lanes of a chunk of sub-blocks
walk together (bits.walk), so a chunk costs about as many numpy steps as
its longest lane has symbols; chunks go to worker processes.
"""

from __future__ import annotations

import zlib

import numpy as np

from portbench.reference.bits import (BitReader, decode_lut, get_uint_array,
                                      load_table, walk)
from portbench.reference.title import TitleJob

MAGIC = b"NGST"
FLAG_VARIABLE, FLAG_DELTA, FLAG_CRC = 1, 2, 4
# the ambiguity codes: ACGT -> 1, IUPAC -> 2..16
AMB_CHAR = np.zeros(17, np.uint8)
for _i, _c in enumerate(b"YRWSKMDVHBNXU.-"):
    AMB_CHAR[2 + _i] = _c
ACGT = np.frombuffer(b"ACGT", np.uint8)
NUC_INDEX = np.zeros(256, np.int64)  # a non-ACGT byte indexes as 0
NUC_INDEX[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
#: lanes walked together hold at most this many symbols
BATCH_SLOTS = 48 << 20


def read_footer(blob) -> dict:
    if bytes(blob[-4:]) != MAGIC:
        raise ValueError("not a .ngsct container")
    flen = int.from_bytes(blob[-8:-4], "big")
    if flen > len(blob) - 8:
        raise ValueError("truncated footer")
    br = BitReader(bytes(blob[len(blob) - 8 - flen:len(blob) - 8]))
    f = {"version": br.get_byte(), "fastq_size": br.get_uint(8),
         "block_size": br.get_uint(4), "n_writers": br.get_bits(16),
         "G": br.get_bits(16), "max_code_len": br.get_bits(8)}
    n_blocks = br.get_uint(4)
    f["writers"] = [(br.get_uint(4), br.get_uint(4), br.get_uint(4))
                    for _ in range(f["n_writers"])]
    wbits = max(1, (max(f["n_writers"] - 1, 1)).bit_length())
    f["cbo"] = [br.get_bits(wbits) for _ in range(n_blocks)]
    if not 1 <= f["version"] <= 4 or f["G"] < 1:
        raise ValueError("corrupt footer")
    if any(w >= f["n_writers"] for w in f["cbo"]):
        raise ValueError("corrupt footer: writer id out of range")
    return f


def subblocks(blob, foot: dict) -> list:
    """[(writer, payload)] in each writer's order: the blocks in file
    order, each [writer: u16][n: u8][flags: u8][n sizes: u32] then the
    entries; flags bit 0: the first entry ends a split sub-block, bit 1:
    the last one starts one."""
    left = [n for _, n, _ in foot["writers"]]
    out, pending, off = [], {}, 0
    for w in foot["cbo"]:
        left[w] -= 1
        size = foot["writers"][w][2] if left[w] == 0 else foot["block_size"]
        blk = bytes(blob[off:off + size])
        off += size
        n, flags = blk[2], blk[3]
        sizes = [int.from_bytes(blk[4 + 4 * i:8 + 4 * i], "big")
                 for i in range(n)]
        at = 4 + 4 * n
        entries = []
        for s in sizes:
            entries.append(blk[at:at + s])
            at += s
        for i, e in enumerate(entries):
            head = i == 0 and flags & 1
            tail = i == n - 1 and flags & 2
            if head:
                if w not in pending:
                    raise ValueError("a split sub-block's tail alone")
                e = pending.pop(w) + e
            elif w in pending and i == 0:
                raise ValueError("dangling split sub-block")
            if tail:
                pending[w] = e
            else:
                out.append((w, e))
    if pending or off + 8 > len(blob):
        raise ValueError("corrupt block framing")
    return out


def _sections(payload: bytes) -> list:
    out, off = [], 0
    for _ in range(4):
        n = int.from_bytes(payload[off:off + 4], "big")
        out.append(payload[off + 4:off + 4 + n])
        off += 4 + n
    return out


def _stream_header(br: BitReader, dna: bool) -> dict:
    h = {}
    if dna:
        h["mode"] = br.get_bits(2)
        h["delta"] = bool(br.get_bit())
    else:
        h["n_trees"] = br.get_bits(16)
    h["total"] = br.get_uint(4)
    n_sub = br.get_bits(24)
    h["sub"] = get_uint_array(br, n_sub, br.get_bits(6))
    if int(h["sub"].sum()) > h["total"]:
        raise ValueError("corrupt substream table")
    if dna:
        h["tables"] = [load_table(br, 256)] if h["mode"] == 1 else []
    else:
        h["tables"] = [load_table(br, 256) for _ in range(h["n_trees"])]
    return h


class SubBlock:
    """One sub-block's parse; quality, DNA and titles filled in by
    decode_payloads."""

    def __init__(self, payload: bytes, G: int, legacy: bool):
        meta, tsec, qsec, dsec = _sections(payload)
        br = BitReader(meta)
        self.R = R = br.get_uint(4)
        Lt = br.get_bits(16)
        flags = br.get_byte()
        self.delta = bool(flags & FLAG_DELTA)
        self.crc = br.get_uint(4) if flags & FLAG_CRC else None
        if flags & FLAG_VARIABLE:
            w = br.get_byte()
            br.align()
            self.lens = get_uint_array(br, R, w)
        else:
            self.lens = np.full(R, Lt, np.int64)
        if R and int(self.lens.max()) > Lt:
            raise ValueError("corrupt meta: a length past the maximum")
        self.L = max(4, (Lt + 3) // 4 * 4)
        self.G, self.legacy = G, legacy
        self.title = TitleJob(tsec, R, G)
        qb = BitReader(qsec)
        self.q = _stream_header(qb, dna=False)
        qb.align()
        self.q_words = np.frombuffer(qb.get_bytes(4 * self.q["total"]), ">u4")
        db = BitReader(dsec)
        self.d = _stream_header(db, dna=True)
        db.align()
        self.d_words = np.frombuffer(db.get_bytes(4 * self.d["total"]), ">u4")
        self.delta = self.delta or self.d["delta"]
        lanes = self.q["sub"].shape[0]
        if self.d["sub"].shape[0] != lanes or lanes * G < R:
            raise ValueError("corrupt substream tables")

    def quality_trees(self) -> np.ndarray:
        """(Lt,) the tree of each position (v4: positions grouped in
        proportion when there are fewer trees than positions; v1-v3 and
        short reads: one a position, the last one shared)."""
        T = self.q["n_trees"]
        pos = np.arange(int(self.lens.max()) if self.R else 0)
        if self.legacy or T >= self.L:
            return np.minimum(pos, T - 1)
        return np.minimum(pos * T // self.L, T - 1)

    def lane_slots(self, per_record: np.ndarray) -> np.ndarray:
        lanes = self.q["sub"].shape[0]
        return np.bincount(np.arange(self.R) // self.G, per_record,
                           minlength=lanes).astype(np.int64)[:lanes]


class _Batch:
    """Lanes of several sub-blocks' streams, walked together."""

    def __init__(self):
        self.words, self.w0, self.nw, self.s0, self.ns = [], [], [], [], []
        self.slot_lut, self.luts = [], []
        self.n_words = self.n_slots = self.n_luts = 0

    def add(self, words, sub, lane_slots, slot_lut, luts) -> int:
        """Returns where this stream's slots start in the walk's output."""
        start = self.n_slots
        sub = np.asarray(sub, np.int64)
        self.words.append(np.asarray(words, np.uint32))
        self.w0.append(self.n_words + np.cumsum(sub) - sub)
        self.nw.append(sub)
        self.s0.append(start + np.cumsum(lane_slots) - lane_slots)
        self.ns.append(lane_slots)
        self.slot_lut.append(slot_lut + self.n_luts)
        self.luts.append(luts)
        self.n_words += int(words.shape[0])
        self.n_slots += int(slot_lut.shape[0])
        self.n_luts += int(luts.shape[0])
        return start

    def run(self, lut_bits: int) -> np.ndarray:
        if not self.words:
            return np.zeros(0, np.int64)
        cat = np.concatenate
        return walk(cat(self.words), cat(self.w0), cat(self.nw),
                    cat(self.s0), cat(self.ns), cat(self.slot_lut),
                    cat(self.luts), lut_bits)


def _valid_positions(lens: np.ndarray):
    """(record of each symbol, its position) over the records' symbols in
    record-major order."""
    n = int(lens.sum())
    rec = np.repeat(np.arange(lens.shape[0]), lens)
    pos = np.arange(n) - np.repeat(np.cumsum(lens) - lens, lens)
    return rec, pos


def _walk_all(jobs, lut_bits: int, stage) -> None:
    """stage(sb, batch) adds one sub-block's stream to the batch and
    returns a callback taking the walk's output; batches hold at most
    BATCH_SLOTS symbols."""
    batch, pending = _Batch(), []
    for sb in jobs:
        cb = stage(sb, batch)
        if cb is not None:
            pending.append(cb)
        if batch.n_slots >= BATCH_SLOTS:
            out = batch.run(lut_bits)
            for cb in pending:
                cb(out)
            batch, pending = _Batch(), []
    out = batch.run(lut_bits)
    for cb in pending:
        cb(out)


def decode_payloads(payloads: list, G: int, lut_bits: int,
                    legacy: bool) -> list:
    """Sub-block payloads (of any containers with these G and code
    lengths) -> each one's FASTQ bytes. Raises ValueError on a corrupt
    sub-block or a crc32 that differs."""
    sbs = [SubBlock(p, G, legacy) for p in payloads]

    def titles(sb, batch):
        sub, ns, slot_lut, luts = sb.title.slots(lut_bits)
        at = batch.add(sb.title.char, sub, ns, slot_lut, luts)
        n = slot_lut.shape[0]

        def done(out):
            sb.titles, sb.tlens = sb.title.assemble(out[at:at + n])
        return done

    def quality(sb, batch):
        rec, pos = _valid_positions(sb.lens)
        trees = sb.quality_trees()
        luts = np.stack([decode_lut(l, s, lut_bits)
                         for l, s in sb.q["tables"]]) if sb.q["tables"] \
            else np.zeros((1, 1 << lut_bits), np.int64)
        at = batch.add(sb.q_words, sb.q["sub"], sb.lane_slots(sb.lens),
                       trees[pos] if pos.size else pos, luts)
        n = pos.shape[0]

        def done(out):
            sb.qual = out[at:at + n]
        return done

    def dna_huffman(sb, batch):
        if sb.d["mode"] != 1:
            return None
        keep = sb.qual < 128
        per_rec = np.bincount(np.repeat(np.arange(sb.R), sb.lens), keep,
                              minlength=sb.R).astype(np.int64)
        lens, sing = sb.d["tables"][0]
        at = batch.add(sb.d_words, sb.d["sub"], sb.lane_slots(per_rec),
                       np.zeros(int(keep.sum()), np.int64),
                       decode_lut(lens, sing, lut_bits)[None])
        n = int(keep.sum())

        def done(out):
            sb.kept = out[at:at + n]
        return done

    _walk_all(sbs, lut_bits, titles)
    _walk_all(sbs, lut_bits, quality)
    _walk_all(sbs, lut_bits, dna_huffman)
    return [_finish(sb) for sb in sbs]


def _plain_dna(sb: SubBlock, keep: np.ndarray) -> np.ndarray:
    """2-bit ACGT, lane-major: kept symbol i of lane s at bit 32 *
    (lane start word) + 2 * i."""
    rec_of = np.repeat(np.arange(sb.R), sb.lens)[keep]
    lane = rec_of // sb.G
    first = np.searchsorted(lane, np.arange(sb.q["sub"].shape[0]))
    i = np.arange(lane.shape[0]) - first[lane]
    sub = sb.d["sub"]
    bits = 2 * np.bincount(lane, minlength=sub.shape[0])[:sub.shape[0]]
    if np.any(bits > 32 * sub) or np.any(bits <= 32 * (sub - 1)):
        raise ValueError("corrupt DNA stream: lanes and words disagree")
    bit = (np.cumsum(sub) - sub)[lane] * 32 + 2 * i
    by = np.frombuffer(sb.d_words.tobytes(), np.uint8)
    by = np.concatenate([by, np.zeros(1, np.uint8)])
    return ACGT[(by[bit >> 3] >> (6 - (bit & 7))) & 3]


def _finish(sb: SubBlock) -> bytes:
    q = sb.qual
    moved = q >= 128
    keep = ~moved
    if sb.d["mode"] == 1:
        kept = sb.kept.astype(np.uint8)
    else:
        kept = _plain_dna(sb, keep)
    seq = np.zeros(q.shape[0], np.uint8)
    seq[keep] = kept
    code = np.clip((q[moved] - 128 + 16) >> 3, 0, 16)
    seq[moved] = AMB_CHAR[code]
    qual = q.copy()
    qual[moved] = (q[moved] - 128 + 16) - (code << 3) + 33
    if sb.delta and seq.size:
        idx = NUC_INDEX[seq]
        first = np.zeros(seq.shape[0], bool)
        first[(np.cumsum(sb.lens) - sb.lens)[sb.lens > 0]] = True
        col = (np.concatenate([[0], idx[:-1]]) ^ idx) + 48
        seq = np.where(first, seq, col).astype(np.uint8)
    out = _records(sb, seq, qual.astype(np.uint8))
    if sb.crc is not None and zlib.crc32(out) != sb.crc:
        raise ValueError("sub-block crc32 differs")
    return out


def _records(sb: SubBlock, seq: np.ndarray, qual: np.ndarray) -> bytes:
    """title \\n bases \\n + \\n qualities \\n, per record."""
    tl, ln = sb.tlens.astype(np.int64), sb.lens
    size = tl + 2 * ln + 5
    rec0 = np.cumsum(size) - size
    out = np.full(int(size.sum()), 10, np.uint8)
    TL = sb.titles.shape[1]
    m = np.arange(TL)[None, :] < tl[:, None]
    out[(rec0[:, None] + np.arange(TL)[None, :])[m]] = sb.titles[m]
    rec, pos = _valid_positions(ln)
    s0 = rec0 + tl + 1
    out[s0[rec] + pos] = seq
    out[s0 + ln + 1] = ord("+")
    out[s0[rec] + ln[rec] + 3 + pos] = qual
    return out.tobytes()


#: sub-blocks a worker decodes together
CHUNK = 4


def _decode_chunk(job):
    """A worker's job: (payloads, G, lut bits, legacy) -> their texts, or
    the ValueError that one of them raised."""
    try:
        return decode_payloads(*job)
    except (ValueError, EOFError, IndexError) as e:
        return ValueError(str(e))


def decode_containers(blobs: list, workers: int = 0) -> list:
    """Containers -> their FASTQ bytes; a corrupt one gives its ValueError
    in its place. Each container's sub-blocks are decoded in chunks of
    CHUNK, on `workers` processes (spawned: they load numpy and this
    package only) where workers > 1, else here."""
    parsed, jobs, owner = [], [], []
    for k, blob in enumerate(blobs):
        try:
            foot = read_footer(blob)
            subs = subblocks(blob, foot)
        except (ValueError, EOFError, IndexError) as e:
            parsed.append(ValueError(str(e)))
            continue
        parsed.append((foot, subs))
        for i in range(0, len(subs), CHUNK):
            jobs.append(([p for _, p in subs[i:i + CHUNK]], foot["G"],
                         foot["max_code_len"], foot["version"] <= 3))
            owner.append(k)
    if workers > 1 and len(jobs) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(min(workers, len(jobs)),
                                    mp_context=mp.get_context("spawn")) as ex:
            done = list(ex.map(_decode_chunk, jobs))
    else:
        done = [_decode_chunk(j) for j in jobs]
    texts = {}
    for k, out in zip(owner, done):
        t = texts.setdefault(k, [])
        if isinstance(out, ValueError) or isinstance(t, ValueError):
            texts[k] = t if isinstance(t, ValueError) else out
        else:
            t.extend(out)
    result = []
    for k, p in enumerate(parsed):
        t = texts.get(k, [])
        if isinstance(p, ValueError) or isinstance(t, ValueError):
            result.append(p if isinstance(p, ValueError) else t)
        else:
            result.append(_place(p[0], p[1], t))
    return result


def _place(foot: dict, subs: list, texts: list):
    """Each writer's sub-blocks in order from its region's start: the
    region starts are fastq_size * w // n_writers + the writer's overlap,
    never before the previous writer's."""
    n = foot["n_writers"]
    starts = []
    for w in range(n):
        a = foot["fastq_size"] * w // n + foot["writers"][w][0]
        starts.append(max(a, starts[-1]) if starts else a)
    out = bytearray(foot["fastq_size"])
    cur = list(starts)
    for (w, _), t in zip(subs, texts):
        if cur[w] + len(t) > foot["fastq_size"]:
            return ValueError("decoded past the footer's size")
        out[cur[w]:cur[w] + len(t)] = t
        cur[w] += len(t)
    for w in range(n):
        end = starts[w + 1] if w + 1 < n else foot["fastq_size"]
        if cur[w] != end:
            return ValueError("decoded regions do not tile the output")
    return bytes(out)

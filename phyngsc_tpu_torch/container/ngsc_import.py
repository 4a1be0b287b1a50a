# Copied from phyngsc_tpu/container/ngsc_import.py; imports point at phyngsc_tpu_torch.
"""Read-only importer for the reference phyNGSC ``.ngsc`` container.

Decodes files produced by the original C++ compressor (pcdslab/PHYNGSC)
back to the exact FASTQ bytes — the decompressor the reference itself never
shipped (its Makefile:7 declares phyNGSD but phyNGSD.cpp is absent; the
decode-side primitives exist at tasks.cpp:625-1101 with no driver, footer
walk, ambiguity restore, or record reassembly). This module is the proof
that our capability mapping (SURVEY C4-C12) is semantically faithful: every
structure here inverts a specific store-side routine of the reference, cited
inline.

Format summary (all bit I/O is MSB-first / big-endian — BitStream and
BitMemory share the layout, bit_stream.h:149-265, bit_memory.h:195-348):

    file    := blocks... footer footer_size:u16
    footer  := MakeFooter, tasks.cpp:1104-1176 (bit-packed widths + tables)
    block   := header payload; header = MakeHeader, tasks.cpp:1179-1200
               (WRID, BHS, NOSB, BESO, BCSS flags, sub-block offset list);
               FSBS/LSBS mark sub-blocks split across a writer's blocks
               (phyNGSC.cpp:852-897)
    subblk  := info title quality dna   (copy order phyNGSC.cpp:804-840)
    info    := no_records:u32 max_qua_len:u32 global_max_seq_len:u32
               n_symbols:u8 quality_mode:u8 n_qualities:u8 fastq_flags:u32
               [variable: per-record qua_len @ BitLength(max_qua_len) bits]
               (phyNGSC.cpp:719-742)
    title   := StoreTitle, tasks.cpp:289-510
    quality := StoreQuality, tasks.cpp:572-622
    dna     := StoreDNA, tasks.cpp:513-569

Huffman trees are stored as byte-aligned blobs (huffman.cpp:191-205):
size:u32 then root_id:u32 n_symbols:u32 min_len:u8 and a pre-order shape
walk — internal node = 0-bit, leaf = 1-bit + symbol id in
ceil(log2(n_symbols)) bits (huffman.cpp:88-147). Codes are the tree-shape
codes (left=0 / right=1), not canonical.

Known reference limitations surfaced as errors, not wrong bytes:

- SOLiD color-space input (FLAG_USE_DELTA): the encoder overwrites the
  quality line with the color characters while translating
  (phyNGSC.cpp:533-534), so the original quality data is not in the file;
  with FLAG_DELTA_CONSTANT it also drops the shared primer base
  (translation=1, phyNGSC.cpp:502,533). Those files are not byte-exactly
  invertible by ANY decoder; we refuse them loudly.
- A numeric field whose VALUE range fits 512 stores a Huffman tree only
  because ``map_stats = delta_values`` copy-assigns into num_values
  (tasks.cpp:324-335 — a C++ reference-binding quirk); the decode side
  (tasks.cpp:688-694) expects a tree from the range alone. We mirror the
  STORE side, i.e. what is actually in the file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from phyngsc_tpu_torch.utils.bitio import BitReader

BLOCK_BYTES = 8 << 20          # WRITE_BUFFER_SIZE, defs.h:21
MAX_FIELD_STAT_LEN = 128       # tasks.cpp:25
B_SIZE = 32                    # DEFAULT_B_SIZE, tasks.cpp:26
MAX_NUM_VAL_HUF = 512          # tasks.cpp:27

# fastq_flags (defs.h:69-80)
FLAG_DNA_PLAIN = 1 << 1
FLAG_CONST_NUM_FIELDS = 1 << 2
FLAG_USE_DELTA = 1 << 4
FLAG_VARIABLE_LENGTH = 1 << 7

# block header BCSS (defs.h:82-86)
LSBS = 1
FSBS = 2

#: inverse of trans_amb_codes (phyNGSC.cpp:187-206): code -> ambiguity char
AMB_CHAR = {2: b"Y", 3: b"R", 4: b"W", 5: b"S", 6: b"K", 7: b"M", 8: b"D",
            9: b"V", 10: b"H", 11: b"B", 12: b"N", 13: b"X", 14: b"U",
            15: b".", 16: b"-"}


class NgscFormatError(ValueError):
    pass


class NgscUnsupportedError(NgscFormatError):
    """The file uses a reference mode that is not byte-exactly invertible
    (see module docstring)."""


# ---------------------------------------------------------------------------
# Huffman tree blob (huffman.cpp StoreTree / EncodeProcess)
# ---------------------------------------------------------------------------

def _int_log2(x: int) -> int:
    """utils::int_log(x, 2) (utils.h:95-108): floor(log2(x)), 0 for x <= 1."""
    r = 0
    t = 2
    while t <= x:
        t *= 2
        r += 1
    return r


class Tree:
    """Prefix-code tree parsed from the reference blob; decodes via a
    full-width LUT when shallow enough, else a per-bit walk."""

    __slots__ = ("syms", "lens", "codes", "max_len", "_lut", "_lut_bits")

    def __init__(self, syms: List[int], lens: List[int], codes: List[int]):
        self.syms = syms
        self.lens = lens
        self.codes = codes
        self.max_len = max(lens) if lens else 0
        self._lut = None
        self._lut_bits = 0
        if 0 < self.max_len <= 20:
            W = self.max_len
            lut = np.zeros(1 << W, np.int32)
            for s, l, c in zip(syms, lens, codes):
                lo = c << (W - l)
                lut[lo : lo + (1 << (W - l))] = (l << 16) | s
            self._lut = lut
            self._lut_bits = W

    @classmethod
    def parse_blob(cls, blob: bytes) -> "Tree":
        br = BitReader(blob)
        br.get_uint(4)                      # root_id (implied by the shape)
        n_symbols = br.get_uint(4)
        br.get_byte()                       # min_len (speedup only)
        bits_per_id = _int_log2(n_symbols)
        if n_symbols & (n_symbols - 1):
            bits_per_id += 1
        syms: List[int] = []
        lens: List[int] = []
        codes: List[int] = []

        # pre-order walk, iterative: stack holds (code, len) of the next
        # subtree to read (huffman.cpp:134-147)
        stack = [(0, 0)]
        while stack:
            code, ln = stack.pop()
            if br.get_bit():                # leaf
                sym = br.get_bits(bits_per_id) if bits_per_id else 0
                syms.append(sym)
                lens.append(ln)
                codes.append(code)
            else:                           # internal: left then right
                stack.append(((code << 1) | 1, ln + 1))
                stack.append((code << 1, ln + 1))
        return cls(syms, lens, codes)

    @classmethod
    def load(cls, br: BitReader) -> "Tree":
        """HuffmanEncoder::LoadTree(BitStream&) framing (huffman.cpp:208-222):
        byte-align, u32 size, blob bytes."""
        br.align()
        size = br.get_uint(4)
        if size == 0 or size > (1 << 24):
            raise NgscFormatError(f"bad tree blob size {size}")
        return cls.parse_blob(br.get_bytes(size))

    def decode(self, br: BitReader) -> int:
        if self.max_len == 0:
            # single-leaf tree (n_symbols == 1): zero-bit code
            return self.syms[0]
        if self._lut is not None:
            e = int(self._lut[br.peek_bits(self._lut_bits)])
            ln = e >> 16
            if ln:
                br.skip_bits(ln)
                return e & 0xFFFF
        # deep-code fallback: per-bit prefix match (rare in practice)
        code = 0
        ln = 0
        pairs = {(l, c): s for s, l, c in
                 zip(self.syms, self.lens, self.codes)}
        while ln <= self.max_len:
            code = (code << 1) | br.get_bit()
            ln += 1
            s = pairs.get((ln, code))
            if s is not None:
                return s
        raise NgscFormatError("invalid prefix code in stream")


# ---------------------------------------------------------------------------
# Footer (tasks.cpp MakeFooter / ReadFooter)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NgscFooter:
    n_ranks: int
    fastq_size: int
    n_blocks: int
    n_subblocks: int
    overlaps: List[int]        # ranks 1..n-1 (rank 0 starts at 0)
    cbo: List[int]             # writer id per block (advisory — see below)
    last_block_sizes: List[int]  # per-rank final partial block bytes


def read_footer(data: bytes) -> NgscFooter:
    fsize = int.from_bytes(data[-2:], "big")
    if fsize <= 0 or fsize + 2 > len(data):
        raise NgscFormatError("bad .ngsc footer size")
    body = data[len(data) - 2 - fsize : len(data) - 2]
    br = BitReader(body)
    beps = br.get_bits(4)
    befs = br.get_bits(6)
    bebs = br.get_bits(4)
    bess = br.get_bits(4)
    belb = br.get_bits(5)
    beov = br.get_bits(4)
    lbes = br.get_bit()
    ps = br.get_bits(beps)
    if befs > 32:
        fs = (br.get_bits(befs - 32) << 32) | br.get_bits(32)
    else:
        fs = br.get_bits(befs)
    bs = br.get_bits(bebs)
    ss = br.get_bits(bess)
    if ps < 1 or bs < 1:
        raise NgscFormatError("empty .ngsc container")
    overlaps = [br.get_bits(beov) for _ in range(ps - 1)]
    cbo_bits = max(1, math.ceil(math.log2(ps))) if ps > 1 else 0
    cbo = [br.get_bits(cbo_bits) if cbo_bits else 0 for _ in range(bs)]
    if any(w >= ps for w in cbo):
        raise NgscFormatError("CBO writer id out of range")
    if lbes == 0:
        lbs = [br.get_bits(belb) for _ in range(ps)]
    else:
        # all last blocks equal — the size itself is NOT stored
        # (tasks.cpp:1163-1169); recover it from the physical file size
        payload = len(data) - 2 - fsize
        full = bs - ps
        if full < 0 or (payload - full * BLOCK_BYTES) % ps:
            raise NgscFormatError("cannot recover equal last-block size")
        lbs = [(payload - full * BLOCK_BYTES) // ps] * ps

    # Block sizes are NOT taken from CBO + LBS (the reference's ABS
    # derivation, tasks.cpp:1280-1292): the CBO comes from gathered write
    # TIMESTAMPS plus a header peek-and-correct pass (phyNGSC.cpp:994-1033)
    # and is observably wrong under some MPI implementations — the exact
    # C13 ordering fragility SURVEY flagged. Every block header is
    # self-delimiting instead (BHS + sum(SBOL) == block size, both for
    # 8 MiB-filled and final partial blocks, phyNGSC.cpp:843-903), so the
    # walk in iter_subblocks derives sizes from the headers and treats the
    # CBO as advisory only.
    return NgscFooter(ps, fs, bs, ss, overlaps, cbo, lbs)


# ---------------------------------------------------------------------------
# Block headers (tasks.cpp MakeHeader)
# ---------------------------------------------------------------------------

def _parse_block(data: bytes, n_ranks: int):
    """Returns (writer_id, bcss, [sub-block byte lengths], block_size).

    The header is self-delimiting: BHS + sum(SBOL) equals the block's total
    bytes for both full (8 MiB) and final partial blocks
    (phyNGSC.cpp:843-903)."""
    br = BitReader(data)
    bewr = max(0, math.ceil(math.log2(n_ranks))) if n_ranks > 1 else 0
    wrid = br.get_bits(bewr) if bewr else 0
    bhs = br.get_bits(12)
    nosb = br.get_bits(6)
    beso = br.get_bits(5)
    bcss = br.get_bits(2)
    sbol = [br.get_bits(beso) for _ in range(nosb)]
    return wrid, bcss, sbol, bhs + sum(sbol)


def iter_subblocks(data: bytes, foot: NgscFooter):
    """Yield (writer_id, complete sub-block payload) walking blocks by their
    self-delimiting headers (writer ids come from the headers, NOT the
    footer CBO — see read_footer) and stitching FSBS/LSBS splits per writer
    (phyNGSC.cpp:852-897: a sub-block crossing the 8 MiB write buffer is
    split across that writer's consecutive blocks)."""
    fsize = int.from_bytes(data[-2:], "big")
    blocks_end = len(data) - 2 - fsize
    pending = {w: b"" for w in range(foot.n_ranks)}
    off = 0
    n_blocks = 0
    while off < blocks_end:
        wrid, bcss, sbol, size = _parse_block(data[off : off + 4096],
                                              foot.n_ranks)
        if wrid >= foot.n_ranks or off + size > blocks_end:
            raise NgscFormatError(
                f"corrupt block header at {off} (writer {wrid}, size {size})")
        bhs = size - sum(sbol)
        payload = bytes(data[off + bhs : off + size])
        off += size
        n_blocks += 1
        pos = 0
        for k, n in enumerate(sbol):
            chunk = payload[pos : pos + n]
            pos += n
            if len(chunk) != n:
                raise NgscFormatError("sub-block overruns block payload")
            first, last = k == 0, k == len(sbol) - 1
            if first and (bcss & FSBS):
                chunk = pending[wrid] + chunk
                pending[wrid] = b""
            if last and (bcss & LSBS):
                pending[wrid] = chunk
            else:
                yield wrid, chunk
    if n_blocks != foot.n_blocks:
        raise NgscFormatError(
            f"walked {n_blocks} blocks, footer claims {foot.n_blocks}")
    for w, rest in pending.items():
        if rest:
            raise NgscFormatError(f"writer {w} ends with a dangling split")


# ---------------------------------------------------------------------------
# Title stream (tasks.cpp StoreTitle / FetchTitleHeader / FetchTitleBody)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Field:
    sep: int
    is_constant: bool
    data: bytes = b""
    is_numeric: bool = False
    min_value: int = 0
    max_value: int = 0
    min_delta: int = 0
    max_delta: int = 0
    is_delta_coding: bool = False
    bits_per_num: int = 0
    bits_per_value: int = 0
    tree: Optional[Tree] = None
    # char fields
    is_len_constant: bool = False
    flen: int = 0
    max_len: int = 0
    min_len: int = 0
    bits_per_len: int = 0
    ham: List[bool] = dataclasses.field(default_factory=list)
    trees: List[Optional[Tree]] = dataclasses.field(default_factory=list)


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= (1 << 31) else x


def _bit_length(x: int) -> int:
    """BitStream::BitLength (bit_stream.h:268-277): bits so x < 2^i, 0 for
    x == 0; negative int32 reinterprets as a huge uint and returns 64."""
    if x < 0:
        return 64
    for i in range(32):
        if x < (1 << i):
            return i
    return 64


def read_title_header(br: BitReader) -> List[_Field]:
    n_fields = br.get_uint(4)
    if n_fields > 1 << 12:
        raise NgscFormatError(f"implausible field count {n_fields}")
    fields = []
    for _ in range(n_fields):
        sep = br.get_byte()
        f = _Field(sep=sep, is_constant=br.get_byte() != 0)
        if f.is_constant:
            n = br.get_uint(4)
            f.data = br.get_bytes(n)
            fields.append(f)
            continue
        f.is_numeric = br.get_byte() != 0
        if f.is_numeric:
            f.min_value = _i32(br.get_uint(4))
            f.max_value = _i32(br.get_uint(4))
            f.min_delta = _i32(br.get_uint(4))
            f.max_delta = _i32(br.get_uint(4))
            v_diff = f.max_value - f.min_value
            d_diff = f.max_delta - f.min_delta
            if v_diff < d_diff:
                f.is_delta_coding = False
                diff = v_diff
            else:
                f.is_delta_coding = True
                diff = d_diff
            f.bits_per_num = _bit_length(diff)
            f.bits_per_value = _bit_length(v_diff)
            # tree present iff the STORE side wrote one (see module
            # docstring): range fits AND the (copy-assigned) stats map was
            # non-empty — num_values is seeded from record 0
            # (phyNGSC.cpp:368), so value-coding always qualifies; delta
            # stats are empty for single-record sub-blocks, but those fall
            # into value coding (diff 0 < delta diff), so range alone
            # matches the store behavior for well-formed files.
            if 0 <= diff + 1 <= MAX_NUM_VAL_HUF:
                f.tree = Tree.load(br)
                br.align()                      # FlushInputWordBuffer
            fields.append(f)
            continue
        f.is_len_constant = br.get_byte() != 0
        f.flen = br.get_uint(4)
        f.max_len = br.get_uint(4)
        f.min_len = br.get_uint(4)
        f.bits_per_len = _bit_length(f.max_len - f.min_len)
        f.data = br.get_bytes(f.flen)
        f.ham = [br.get_bit() != 0 for _ in range(f.flen)]
        n_pos = min(f.max_len, MAX_FIELD_STAT_LEN)
        f.trees = [None] * (MAX_FIELD_STAT_LEN + 1)
        for j in range(n_pos):
            if j >= f.flen or not f.ham[j]:
                f.trees[j] = Tree.load(br)
        if f.max_len >= MAX_FIELD_STAT_LEN:
            f.trees[MAX_FIELD_STAT_LEN] = Tree.load(br)
        br.align()                              # store-side flush
        fields.append(f)
    return fields


def decode_title_body(br: BitReader, fields: List[_Field],
                      no_records: int) -> List[bytes]:
    """FetchTitleBody (tasks.cpp:738-954) — returns full title lines,
    trailing separator ('\\n') included."""
    n_blocks = (no_records + B_SIZE - 1) // B_SIZE
    titles: List[bytes] = []
    prev_value = [0] * len(fields)
    block_str: List[bytes] = [b""] * len(fields)
    for block_no in range(n_blocks):
        lo = block_no * B_SIZE
        hi = min(lo + B_SIZE, no_records)
        blk_flag = [False] * len(fields)
        for i, f in enumerate(fields):
            if f.is_constant:
                continue
            prev_value[i] = 0
            blk_flag[i] = br.get_bit() != 0
        for r in range(lo, hi):
            parts = []
            for i, f in enumerate(fields):
                if f.is_constant:
                    parts.append(f.data)
                    parts.append(bytes([f.sep]))
                    continue
                if f.is_numeric:
                    if r % B_SIZE == 0:
                        v = (br.get_bits(f.bits_per_value)
                             if f.bits_per_value else 0) + f.min_value
                    else:
                        blk_const = blk_flag[i]
                        if not blk_const:
                            if f.bits_per_num > 0:
                                nv = (f.tree.decode(br) if f.tree
                                      else br.get_bits(f.bits_per_num))
                            else:
                                nv = 0
                        else:
                            nv = (0 if f.is_delta_coding
                                  else prev_value[i] - f.min_value)
                        if f.is_delta_coding:
                            v = nv + prev_value[i] + f.min_delta
                        else:
                            v = nv + f.min_value
                    prev_value[i] = v
                    parts.append(b"%d" % (v & 0xFFFFFFFF))
                    parts.append(bytes([f.sep]))
                    continue
                # char field
                if r % B_SIZE > 0 and blk_flag[i]:
                    parts.append(block_str[i])
                    parts.append(bytes([f.sep]))
                    continue
                if f.is_len_constant:
                    flen = f.flen
                else:
                    flen = br.get_bits(f.bits_per_len) + f.min_len \
                        if f.bits_per_len else f.min_len
                chars = bytearray()
                for k in range(flen):
                    if k < f.flen and f.ham[k]:
                        chars.append(f.data[k])
                    else:
                        t = f.trees[min(k, MAX_FIELD_STAT_LEN)]
                        chars.append(t.decode(br))
                s = bytes(chars)
                if r % B_SIZE == 0 and blk_flag[i]:
                    block_str[i] = s
                parts.append(s)
                parts.append(bytes([f.sep]))
            titles.append(b"".join(parts))
        br.align()                              # per-block flush
    return titles


# ---------------------------------------------------------------------------
# Whole-file decode
# ---------------------------------------------------------------------------

def decode_subblock(payload: bytes) -> bytes:
    br = BitReader(payload)
    no_records = br.get_uint(4)
    max_qua_len = br.get_uint(4)
    br.get_uint(4)                              # global_max_sequence_length
    n_symbols = br.get_byte()
    quality_mode = br.get_byte()
    n_qualities = br.get_byte()
    fastq_flags = br.get_uint(4)
    br.align()
    if quality_mode != 0:                       # QUALITY_PLAIN
        raise NgscUnsupportedError(f"quality mode {quality_mode}")
    if fastq_flags & FLAG_USE_DELTA:
        raise NgscUnsupportedError(
            "SOLiD color-space .ngsc: the reference encoder overwrites the "
            "quality line while delta-translating (phyNGSC.cpp:533-534), so "
            "no decoder can restore the original bytes")
    if not fastq_flags & FLAG_CONST_NUM_FIELDS:
        raise NgscUnsupportedError("variable field count per record")
    if no_records == 0:
        return b""
    qua_len_bits = _bit_length(max_qua_len)
    if fastq_flags & FLAG_VARIABLE_LENGTH:
        qua_lens = [br.get_bits(qua_len_bits) for _ in range(no_records)]
        br.align()
    else:
        qua_lens = [max_qua_len] * no_records

    # title stream
    fields = read_title_header(br)
    titles = decode_title_body(br, fields, no_records)

    # quality stream (tasks.cpp:1036-1101): alphabet, per-position trees
    # (index j+1; tree 0 is the position-agnostic total, decode never uses
    # it), then per-record symbols
    qualities = bytes(br.get_byte() for _ in range(n_qualities))
    br.align()
    qtrees = [Tree.load(br) for _ in range(max_qua_len + 1)]
    br.align()
    quals: List[bytes] = []
    n_amb: List[int] = []
    for r in range(no_records):
        q = bytes(qualities[qtrees[j + 1].decode(br)]
                  for j in range(qua_lens[r]))
        quals.append(q)
        n_amb.append(sum(1 for c in q if c >= 128))
    br.align()

    # dna stream (tasks.cpp:957-1033)
    symbols = bytes(br.get_byte() for _ in range(n_symbols))
    br.align()
    dtree = None
    if not fastq_flags & FLAG_DNA_PLAIN:
        dtree = Tree.load(br)
    br.align()
    out = bytearray()
    for r in range(no_records):
        seq_len = qua_lens[r] - n_amb[r]
        if seq_len < 0:
            raise NgscFormatError("ambiguity count exceeds record length")
        if dtree is None:
            seq = bytes(symbols[br.get_bits(2)] for _ in range(seq_len))
        else:
            seq = bytes(symbols[dtree.decode(br)] for _ in range(seq_len))
        # ambiguity restore — inverse of the transfer at phyNGSC.cpp:573-588
        # (stored quality = 128 + (code << 3) - 16 + (q - 33))
        q = quals[r]
        if n_amb[r]:
            s = bytearray()
            qq = bytearray()
            it = iter(seq)
            for c in q:
                if c >= 128:
                    code = (c - 112) >> 3
                    ch = AMB_CHAR.get(code)
                    if ch is None:
                        raise NgscFormatError(
                            f"bad ambiguity code {code} in quality stream")
                    s += ch
                    qq.append(((c - 112) & 7) + 33)
                else:
                    s.append(next(it))
                    qq.append(c)
            seq, q = bytes(s), bytes(qq)
        out += titles[r]
        out += seq
        out += b"\n+\n"
        out += q
        out += b"\n"
    return bytes(out)


def decompress_ngsc(data) -> bytes:
    """.ngsc container bytes → original FASTQ bytes.

    Writers' outputs concatenate in rank order (working regions are
    contiguous file spans, phyNGSC.cpp:113-160); within a writer,
    sub-blocks are sequential."""
    data = bytes(data)
    foot = read_footer(data)
    per_writer: List[List[bytes]] = [[] for _ in range(foot.n_ranks)]
    for wid, payload in iter_subblocks(data, foot):
        per_writer[wid].append(decode_subblock(payload))
    out = b"".join(b"".join(chunks) for chunks in per_writer)
    if len(out) != foot.fastq_size:
        raise NgscFormatError(
            f"decoded {len(out)} bytes != footer fastq_size "
            f"{foot.fastq_size}")
    return out


def import_ngsc_file(in_path: str, out_path: str) -> int:
    with open(in_path, "rb") as f:
        data = f.read()
    out = decompress_ngsc(data)
    with open(out_path, "wb") as f:
        f.write(out)
    return len(out)

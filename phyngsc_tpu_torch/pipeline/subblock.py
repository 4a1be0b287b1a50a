"""Sub-block encode/decode (port of phyngsc_tpu/pipeline/subblock.py).

One sub-block of records -> self-contained bytes, section layout

    [meta][title][quality][dna]   (each u32-length-prefixed)

byte-identical to phyngsc_tpu. Encode: stage_a gathers the planes on the
host, uploads the raw (Rp, L) seq/qual planes and runs the ambiguity
transfer (after the SOLiD colour-space translation, for delta sub-blocks)
and both histograms (K1) on the device; stage_b builds and fuses the code
tables on the host, uploads them in one copy and packs both streams on the
device (code lookups on K4); stage_c fetches the words and assembles the
sections. Decode: _decode_parse is host code; decode_stage_a uploads the
linear word streams and host-built LUTs, lays each stream out as its (Wmax,
Sp) word plane (K5), decodes quality (K2 for uniform lengths, K3 with
per-position trees for variable lengths) then DNA (K3) from the planes,
restores the ambiguity and undoes the delta translation on the device;
decode_stage_b fetches the restored planes and reassembles FASTQ text.
Every read length the container holds (up to 65535) is taken.
"""

from __future__ import annotations

import numpy as np
import torch

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.utils.bitio import BitReader, BitWriter
from phyngsc_tpu_torch.utils.fastq import FastqFormatError, RecordIndex
from phyngsc_tpu_torch.utils.shapes import bucket_length, bucket_records
from phyngsc_tpu_torch.models import dna, quality, title
from phyngsc_tpu_torch.ops import bitpack, lookup
from phyngsc_tpu_torch.ops.bitpack_host import bytes_to_words, words_to_bytes

FLAG_VARIABLE_LENGTH = 1
FLAG_DELTA = 2
FLAG_CRC = 4


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to phyngsc_tpu_torch yet (a later slice of "
        "the port); use phyngsc_tpu for this input")


def _gather_matrix(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   width: int) -> np.ndarray:
    """(R, width) uint8 padded gather of byte spans (copied from
    phyngsc_tpu/pipeline/subblock.py)."""
    R = starts.shape[0]
    if R == 0 or width == 0:
        return np.zeros((R, max(width, 1)), np.uint8)
    from phyngsc_tpu_torch.utils import native

    out = native.gather(buf, starts, lens, width)
    if out is not None:
        return out
    cols = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    mask = np.arange(width)[None, :] < lens[:, None]
    out = buf[np.clip(cols, 0, buf.shape[0] - 1)]
    out[~mask] = 0
    return out


def _pack_fixed_np(values: np.ndarray, width: int) -> bytes:
    """Host fixed-width bit pack via np.packbits, MSB first (copied from
    phyngsc_tpu/pipeline/subblock.py:62-68)."""
    if width == 0 or values.shape[0] == 0:
        return b""
    v = values.astype(np.uint64)
    bits = (v[:, None] >> np.arange(width - 1, -1, -1, dtype=np.uint64)[None, :]) & 1
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def _unpack_fixed_np(data: bytes, width: int, n: int) -> np.ndarray:
    """Inverse of _pack_fixed_np (copied from phyngsc_tpu/pipeline/
    subblock.py:71-76)."""
    if width == 0 or n == 0:
        return np.zeros(n, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[: n * width]
    bits = bits.reshape(n, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1, dtype=np.int64)[None, :]).sum(axis=1)


def _word_cap(R: int, L: int, G: int) -> int:
    """Worst-case packed size: <= 16 bits/symbol + one alignment word per
    substream."""
    return (R * L) // 2 + (R // G) + 8


def _exact_cap(counts: np.ndarray, lens_tab: np.ndarray, S: int,
               worst: int) -> int:
    """Words the stream can need: the exact payload bits (histogram x code
    lengths) + <= one alignment word per substream."""
    bits = int(np.sum(counts.astype(np.int64) * lens_tab.astype(np.int64)))
    return min(bits // 32 + S + 8, worst)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _upload_together(arrays, device) -> list:
    """Host arrays -> device tensors of the same dtypes and shapes, made by
    one host-to-device copy: each array starts on a 16-byte boundary of one
    uint8 buffer (the kernels load 16 bytes at a time)."""
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    buf = np.zeros(n, np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = _to_device(buf, device)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(
        a.shape) for a, o in zip(arrays, offs)]


def _upload_words(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> int32 device tensor holding the same bits."""
    return _to_device(np.asarray(words, np.uint32).view(np.int32), device)


def _is_variable(lens_np: np.ndarray) -> bool:
    return bool(lens_np.shape[0]) and not bool(np.all(lens_np == lens_np[0]))


def _record_lens(lens_np: np.ndarray, Rp: int, device) -> torch.Tensor:
    """(Rp,) int32 record lengths on the device, 0 for padding: computed
    there when every record has the same length, else uploaded."""
    R = lens_np.shape[0]
    if not _is_variable(lens_np):
        Lt = int(lens_np[0]) if R else 0
        r = torch.arange(Rp, device=device)
        return torch.where(r < R, Lt, 0).to(torch.int32)
    pad = np.zeros(Rp, np.int32)
    pad[:R] = lens_np
    return _to_device(pad, device)


class _StageA:
    """Host gather + device analyze dispatched; counts_blob not fetched yet."""

    __slots__ = ("R", "Lt", "L", "Rp", "lens_np", "tlens_np", "titles_np",
                 "is_delta", "seq", "lens", "qual_t", "keep", "counts_blob",
                 "n_q_counts", "t_future", "crc")


class _StageB:
    """Tables built, stream packing dispatched; one fused device blob."""

    __slots__ = ("a", "q_tables", "d_plan", "t_enc", "blob", "blob_layout")


def stage_a(buf: np.ndarray, idx: RecordIndex, cfg: CodecConfig,
            device, executor=None, rp=None) -> _StageA:
    """executor: optional ThreadPoolExecutor for the title encode. rp: the
    padded record count; the driver picks it from its shapes.BucketCtx on
    its own thread in task order (the picks depend on history, so output
    bytes would otherwise depend on timing). Default: bucket_records."""
    st = _StageA()
    st.t_future = None
    st.crc = None
    R = st.R = idx.n_records
    G = cfg.records_per_substream
    lens_np = st.lens_np = idx.seq_len.astype(np.int32)
    Lt = st.Lt = int(lens_np.max()) if R else 1
    L = st.L = bucket_length(Lt)
    Rp = st.Rp = rp if rp is not None else bucket_records(R, G)
    if Lt > 0xFFFF:
        raise FastqFormatError(
            f"read length {Lt} exceeds the container's 65535 limit")
    tlens_np = st.tlens_np = (idx.title_end - idx.title_start).astype(np.int32)
    TL = int(tlens_np.max()) if R else 1
    from phyngsc_tpu_torch.utils import native as _native

    g3 = (_native.gather3(buf, idx.title_start, tlens_np, TL,
                          idx.seq_start, idx.qual_start, lens_np, L)
          if R else None)
    if g3 is not None:
        st.titles_np, seq_np, qual_np, qmax = g3
    else:
        seq_np = _gather_matrix(buf, idx.seq_start,
                                lens_np.astype(np.int64), L)
        qual_np = _gather_matrix(buf, idx.qual_start,
                                 lens_np.astype(np.int64), L)
        st.titles_np = _gather_matrix(buf, idx.title_start,
                                      tlens_np.astype(np.int64), TL)
        qmax = int(qual_np.max()) if R else 0
    if R and qmax >= 128:
        raise FastqFormatError(
            "quality byte >= 128 in input: outside printable phred+33 and "
            "reserved for the ambiguity transfer (phyNGSC.cpp:579 encoding)")
    st.is_delta = dna.detect_delta(seq_np, lens_np)
    if cfg.checksum and R:
        import zlib

        span = buf[int(idx.title_start[0]) : int(idx.qual_end[-1]) + 1]
        st.crc = zlib.crc32(np.ascontiguousarray(span))

    # upload the raw planes; the padding rows are zero on the device
    seq = st.seq = torch.zeros((Rp, L), dtype=torch.uint8, device=device)
    qual = torch.zeros((Rp, L), dtype=torch.uint8, device=device)
    if R:
        seq[:R] = _to_device(seq_np, device)
        qual[:R] = _to_device(qual_np, device)
    lens = st.lens = _record_lens(lens_np, Rp, device)
    if st.is_delta:
        seq = st.seq = dna.delta_translate(seq, lens)
    small = int(seq_np.max(initial=0)) < 128
    st.qual_t, st.keep, _ = dna.transfer_ambiguity(seq, qual, lens)
    # the histograms read the R live rows only (contiguous views): the
    # padding rows' masks are zero, so the counts are the same
    q_counts = quality.analyze(st.qual_t[:R], lens[:R])
    d_counts = dna.analyze(seq[:R], st.keep[:R], small_alpha=small)
    st.n_q_counts = q_counts.numel()
    st.counts_blob = torch.cat([q_counts.reshape(-1), d_counts.reshape(-1)])
    if executor is not None:
        st.t_future = executor.submit(title.encode, st.titles_np, tlens_np, cfg)
    return st


def stage_b(a: _StageA, cfg: CodecConfig) -> _StageB:
    st = _StageB()
    st.a = a
    G = cfg.records_per_substream
    dev = a.seq.device
    counts = a.counts_blob.cpu().numpy()  # the one stage-A fetch
    q_counts = counts[: a.n_q_counts].reshape(-1, quality.ALPHABET)
    d_counts = counts[a.n_q_counts :]
    st.q_tables, q_group = quality.build_tables_adaptive(q_counts, cfg)
    st.d_plan = dna.plan(d_counts, cfg)
    huffman_dna = st.d_plan.mode == dna.MODE_HUFFMAN
    d_group = (lookup.group_for(int(st.d_plan.lens_tab.max()) or 1)
               if huffman_dna else 2)
    # fuse the code tables on the host, sliced to the occupied alphabet
    # window as the JAX encoder slices them (header serialization keeps the
    # full tables), and upload them with the quality tree ids in one copy
    q_off, q_A = lookup.window_np(q_counts)
    tables = list(quality.encode_tables(
        st.q_tables.codes[:, q_off:q_off + q_A],
        st.q_tables.lens[:, q_off:q_off + q_A], a.L))
    d_off = 0
    if huffman_dna:
        d_off, d_A = lookup.window_np(d_counts.reshape(1, -1))
        tables.append(lookup.fused_table_np(
            st.d_plan.codes_tab[None, d_off:d_off + d_A],
            st.d_plan.lens_tab[None, d_off:d_off + d_A]).view(np.int16))
    q_tab_d, q_tree_d, *d_tab_d = _upload_together(tables, dev)

    S = a.Rp // G
    worst = _word_cap(a.Rp, a.L, G)
    q_cap = _exact_cap(q_counts, quality.lens_rows_for(st.q_tables,
                                                       q_counts.shape[0]),
                       S, worst)
    d_cap = _exact_cap(d_counts, st.d_plan.lens_tab if huffman_dna
                       else np.full(256, 2, np.int64), S, worst)
    q_words, q_sub, q_total = quality.encode_device(
        a.qual_t, a.lens, q_tab_d, q_tree_d, G, q_cap, q_group, q_off)
    d_words, d_sub, d_total = dna.encode_device(
        a.seq, a.keep, d_tab_d[0] if d_tab_d else None, st.d_plan.mode, G,
        d_cap, d_group, d_off)
    st.blob = torch.cat([q_words, d_words, q_sub, d_sub, q_total.view(1),
                         d_total.view(1)])
    st.blob_layout = (q_cap, d_cap, S)
    # title is host-heavy: runs on a worker thread started in stage A (or
    # inline here) while the device packs quality/dna
    st.t_enc = (a.t_future.result() if a.t_future is not None
                else title.encode(a.titles_np, a.tlens_np, cfg))
    return st


def stage_c(b: _StageB, cfg: CodecConfig) -> bytes:
    a = b.a
    blob = b.blob.cpu().numpy()  # the one stage-B fetch (int64 words)
    nqw, ndw, S = b.blob_layout
    q_words = blob[:nqw]
    d_words = blob[nqw : nqw + ndw]
    q_sub = blob[nqw + ndw : nqw + ndw + S].astype(np.int32)
    d_sub = blob[nqw + ndw + S : nqw + ndw + 2 * S].astype(np.int32)
    q_total, d_total = (int(x) for x in blob[nqw + ndw + 2 * S :])

    meta = BitWriter()
    meta.put_uint(a.R, 4)
    meta.put_bits(a.Lt, 16)
    variable = _is_variable(a.lens_np)
    meta.put_byte((FLAG_VARIABLE_LENGTH if variable else 0)
                  | (FLAG_DELTA if a.is_delta else 0)
                  | (FLAG_CRC if a.crc is not None else 0))
    if a.crc is not None:
        meta.put_uint(a.crc, 4)
    if variable:
        w = max(1, int(a.lens_np.max()).bit_length())
        meta.put_byte(w)
        meta.flush()
        meta.put_bytes(_pack_fixed_np(a.lens_np, w))
    meta.flush()

    tbw = BitWriter()
    title.write_header(tbw, b.t_enc)
    tbw.flush()
    title_sec = (tbw.getvalue() + words_to_bytes(b.t_enc.fixed_words)
                 + words_to_bytes(b.t_enc.char_words))

    q_stream = q_words[:q_total].astype(np.uint32)
    qbw = BitWriter()
    quality.write_header(qbw, b.q_tables, q_sub, q_stream.shape[0])
    qbw.flush()
    quality_sec = qbw.getvalue() + words_to_bytes(q_stream)

    d_stream = d_words[:d_total].astype(np.uint32)
    dbw = BitWriter()
    dna.write_header(dbw, b.d_plan, d_sub, d_stream.shape[0], a.is_delta)
    dbw.flush()
    dna_sec = dbw.getvalue() + words_to_bytes(d_stream)

    out = bytearray()
    for sec in (meta.getvalue(), title_sec, quality_sec, dna_sec):
        out += len(sec).to_bytes(4, "big")
        out += sec
    return bytes(out)


# -- decode -----------------------------------------------------------------

def _check_tables(lens2d: np.ndarray, singletons: np.ndarray,
                  what: str, cfg: CodecConfig) -> None:
    """Reject corrupt decode tables at parse time (copied from
    phyngsc_tpu/pipeline/subblock.py:729-741): code lengths beyond
    cfg.max_code_len and singleton symbols outside the alphabet."""
    if lens2d.size and int(lens2d.max()) > cfg.max_code_len:
        raise ValueError(
            f"corrupt {what} table: code length exceeds max_code_len")
    s = np.asarray(singletons)
    if s.size and int(s.max()) >= 256:
        raise ValueError(
            f"corrupt {what} table: singleton symbol out of range")


class _DParsed:
    """Host-side parse of one sub-block payload: everything the device
    decode needs, as numpy arrays and tables."""

    __slots__ = ("R", "Lt", "L", "Rp", "G", "variable", "is_delta", "crc",
                 "lens_np", "titles_np", "tlens_np", "q_tables", "q_sub",
                 "q_words", "d_plan", "d_sub", "d_words")


def _decode_parse(data: bytes, cfg: CodecConfig, executor=None) -> _DParsed:
    """executor: optional ThreadPoolExecutor — the title decode then runs on
    a worker thread and p.titles_np is a Future (p.tlens_np None)."""
    p = _DParsed()
    sections = []
    off = 0
    for _ in range(4):
        n = int.from_bytes(data[off : off + 4], "big")
        sections.append(data[off + 4 : off + 4 + n])
        off += 4 + n
    meta_sec, title_sec, quality_sec, dna_sec = sections

    br = BitReader(meta_sec)
    R = p.R = br.get_uint(4)
    Lt = p.Lt = br.get_bits(16)
    p.L = bucket_length(Lt)
    flags = br.get_byte()
    p.variable = bool(flags & FLAG_VARIABLE_LENGTH)
    p.is_delta = bool(flags & FLAG_DELTA)
    p.crc = br.get_uint(4) if flags & FLAG_CRC else None
    if p.variable:
        w = br.get_byte()
        br.align()
        p.lens_np = _unpack_fixed_np(
            br.get_bytes(((R * w) + 7) // 8), w, R).astype(np.int32)
        if R and int(p.lens_np.max()) > Lt:
            raise ValueError("corrupt meta: a record length exceeds the "
                             "stored maximum")
    else:
        br.align()
        p.lens_np = np.full(R, Lt, np.int32)
    G = p.G = cfg.records_per_substream

    br = BitReader(title_sec)
    t_plan, n_fixed, n_char, t_sub = title.read_header(br, R)
    br.align()
    fixed_words = bytes_to_words(br.get_bytes(4 * n_fixed))
    char_words = bytes_to_words(br.get_bytes(4 * n_char))
    if executor is not None and R:
        p.titles_np = executor.submit(
            title.decode, t_plan, fixed_words, char_words, t_sub, R, cfg)
        p.tlens_np = None
    else:
        p.titles_np, p.tlens_np = title.decode(
            t_plan, fixed_words, char_words, t_sub, R, cfg)

    # quality first: it carries the ambiguity transfer
    br = BitReader(quality_sec)
    p.q_tables, p.q_sub, q_total = quality.read_header(br)
    br.align()
    _check_tables(p.q_tables.lens, p.q_tables.singletons, "quality", cfg)
    # Rp comes from the stored substream table (agnostic to the encoder's
    # bucketing)
    p.Rp = p.q_sub.shape[0] * G if p.q_sub.shape[0] else bucket_records(R, G)
    if p.Rp < R or (R and not p.q_sub.shape[0]):
        raise ValueError(
            f"corrupt quality substream table: capacity {p.Rp} < {R} records")

    dbr = BitReader(dna_sec)
    p.d_plan, p.d_sub, d_total, is_delta_hdr = dna.read_header(dbr)
    p.is_delta = p.is_delta or is_delta_hdr
    if p.d_plan.mode != dna.MODE_PLAIN:
        _check_tables(p.d_plan.lens_tab[None, :],
                      np.array([p.d_plan.singleton], np.int32), "DNA", cfg)
    if p.d_sub.shape[0] != p.q_sub.shape[0]:
        raise ValueError(
            "corrupt container: DNA substream table length "
            f"{p.d_sub.shape[0]} != quality's {p.q_sub.shape[0]}")
    dbr.align()
    p.q_words = bytes_to_words(br.get_bytes(4 * q_total))
    p.d_words = bytes_to_words(dbr.get_bytes(4 * d_total))
    return p


class _DStage:
    """Decode stage A result: the restored (2, Rp, L) planes pending fetch."""

    __slots__ = ("R", "lens_np", "titles_np", "tlens_np", "blob", "crc")


def _decode_device(p: _DParsed, cfg: CodecConfig, device) -> torch.Tensor:
    """Both word planes (K5) -> quality walk (K2, or K3 for variable lengths)
    -> keep mask -> DNA walk (K3) -> ambiguity restore -> delta untranslate,
    as phyngsc_tpu's _decode_walk_fused under PHYNGSC_DENSIFY=dma. Returns
    the (2, Rp, L) uint8 seq/qual planes on the device."""
    if not p.R:
        return torch.zeros((2, 0, p.L), dtype=torch.uint8, device=device)
    # both tables are checked before anything is uploaded
    q_wmax, sp = bitpack.plane_geometry(p.q_sub, p.G, p.L, cfg.max_code_len)
    d_wmax, _ = bitpack.plane_geometry(p.d_sub, p.G, p.L, cfg.max_code_len)
    V = 1 << cfg.max_code_len
    lens = _record_lens(p.lens_np, p.Rp, device)
    q_luts = (p.q_tables.luts(cfg.max_code_len) if p.q_tables.n_trees
              else np.zeros((1, V), np.int32))
    q_plane = bitpack.dense_words(_upload_words(p.q_words, device),
                                  _to_device(bitpack.lane_table(p.q_sub),
                                             device), q_wmax, sp)
    if p.variable:
        qual_t = quality.decode_walk_masked(
            q_plane, lens, q_luts, p.L, p.G, cfg.max_code_len,
            legacy=cfg.legacy_tail_trees)
    else:
        qual_t = quality.decode_walk(
            q_plane, lens, q_luts, p.L, p.Lt, p.G, cfg.max_code_len,
            legacy=cfg.legacy_tail_trees)
    keep = (qual_t < 128) & quality.valid_mask(lens, p.L)
    d_plane = bitpack.dense_words(_upload_words(p.d_words, device),
                                  _to_device(bitpack.lane_table(p.d_sub),
                                             device), d_wmax, sp)
    if p.d_plan.mode == dna.MODE_PLAIN:
        dna_syms = dna.decode_plain_walk(d_plane, keep, p.G)
    else:
        dna_syms = dna.decode_huffman_walk(
            d_plane, keep, p.d_plan.luts(cfg.max_code_len)[0], p.G,
            cfg.max_code_len)
    seq, qual = dna.restore_ambiguity(dna_syms, qual_t, lens)
    if p.is_delta:
        seq = dna.delta_untranslate(seq, lens)
    return torch.stack([seq, qual])


def decode_stage_a(data: bytes, cfg: CodecConfig, device,
                   executor=None) -> _DStage:
    p = _decode_parse(data, cfg, executor)
    st = _DStage()
    st.R, st.lens_np, st.crc = p.R, p.lens_np, p.crc
    st.titles_np, st.tlens_np = p.titles_np, p.tlens_np
    st.blob = _decode_device(p, cfg, device)
    return st


def decode_stage_b(st: _DStage) -> bytes:
    both = st.blob.cpu().numpy()  # the one decode fetch
    seq, qual = both[0, : st.R], both[1, : st.R]
    if st.tlens_np is None:        # title decode ran on a worker thread
        st.titles_np, st.tlens_np = st.titles_np.result()
    out = _reassemble(st.R, st.lens_np, st.titles_np, st.tlens_np, seq, qual)
    if st.crc is not None:
        import zlib

        if zlib.crc32(out) != st.crc:
            raise ValueError(
                "sub-block checksum mismatch: decoded bytes differ from the "
                "original input (corrupt container or codec defect)")
    return out


def _reassemble(R, lens_np, titles_np, tlens_np, seq_np, qual_np) -> bytes:
    """FASTQ text from the planes (copied from
    phyngsc_tpu/pipeline/subblock.py:1385): native per-record memcpy when
    available, else a vectorized numpy scatter."""
    rec_bytes = tlens_np.astype(np.int64) + 1 + lens_np.astype(np.int64) + 1 + 2 + lens_np.astype(np.int64) + 1
    offs = np.concatenate([[0], np.cumsum(rec_bytes)])
    if R:
        from phyngsc_tpu_torch.utils import native

        res = native.fastq_assemble(titles_np[:R], tlens_np[:R], seq_np[:R],
                                    qual_np[:R], lens_np[:R], offs[:-1],
                                    int(offs[-1]))
        if res is not None:
            return res
    out = np.zeros(int(offs[-1]), np.uint8)

    def scatter(mat, mlens, base):
        Wm = mat.shape[1]
        if Wm == 0 or R == 0:
            return
        pos = np.arange(Wm, dtype=np.int64)
        m = pos[None, :] < mlens[:, None]
        flat = (base[:, None] + pos[None, :])[m]
        out[flat] = mat[:R][m]

    base_t = offs[:-1]
    scatter(titles_np, tlens_np.astype(np.int64), base_t)
    out[base_t + tlens_np] = 0x0A
    base_s = base_t + tlens_np + 1
    scatter(seq_np, lens_np.astype(np.int64), base_s)
    out[base_s + lens_np] = 0x0A
    base_p = base_s + lens_np + 1
    out[base_p] = ord("+")
    out[base_p + 1] = 0x0A
    base_q = base_p + 2
    scatter(qual_np, lens_np.astype(np.int64), base_q)
    out[base_q + lens_np] = 0x0A
    return out.tobytes()

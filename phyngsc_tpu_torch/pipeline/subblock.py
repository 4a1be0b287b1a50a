"""Sub-block encode/decode (port of phyngsc_tpu/pipeline/subblock.py).

One sub-block of records -> self-contained bytes, section layout

    [meta][title][quality][dna]   (each u32-length-prefixed)

byte-identical to phyngsc_tpu. Encode: stage_a gathers the planes on the
host, packs the R live rows of the seq/qual planes (ops/transfer) and
uploads the words in one copy; the device unpacks them into the (Rp, L)
planes and runs the ambiguity transfer (after the SOLiD colour-space
translation, for delta sub-blocks) and both histograms (K1); stage_b
builds and fuses the code tables on the host, uploads them in one copy and
packs both streams on the device (code lookups on K4) into one blob of
32-bit words; stage_c fetches it and assembles the sections. Decode:
_decode_parse is host code; decode_stage_a uploads the sub-block's
inputs in one copy (the linear word streams, their lane tables, the code
lengths of the walk tables as nibbles, the lengths when they vary, the
output alphabet's index table), builds the walk tables there from the
code lengths (K6), lays each stream out as its (Wmax, Sp) word plane
(K5), decodes
quality (K2 for uniform lengths, K3 with per-position trees for variable
lengths) then DNA (K3) from the planes, and packs the live rows for the
fetch: kept-symbol indices and raw qualities (qual8 mode), or restored
symbol indices and qualities in 6 or 8 bits; decode_stage_b fetches them,
unpacks them on the host and reassembles FASTQ text. Delta sub-blocks and
alphabets past 32 symbols fetch the restored (2, Rp, L) planes. Every read
length the container holds (up to 65535) is taken. With a
parallel.mesh.ShardedSubblockCodec each stage runs per shard: stage A and
B on each shard's Rp / n rows on its device (the raw planes uploaded, the
counts summed), the decode on each shard's contiguous range of whole lanes
(decode_lanes; the raw planes fetched). Execution is asynchronous, as
phyngsc_tpu's is (its jax.device_put and _host_async): a sub-block's
device work runs on the task's streams (device.task_streams, handed out by
the drivers; stage_a, stage_b's packing and decode_stage_a enter them,
stage_c and decode_stage_b only wait on their fetches), every upload is one non-blocking copy from pinned staging
(_to_device), and each fetch starts as soon as its producer is queued (the
counts at the end of stage_a, the blobs at the end of stage_b and of
decode_stage_a: device.fetch_async) and waits on its own event alone, so
no host thread waits for another sub-block's work. encode_subblock /
decode_subblock compose the stages as one task. Under PHYNGSC_TIMING the
stages add their seconds and the host<->device bytes to TIMING, with
phyngsc_tpu's labels.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import (Staging, fetch_async, on_device,
                                     resolve, task_streams, upload,
                                     use_streams)
from phyngsc_tpu_torch.utils.bitio import BitReader, BitWriter
from phyngsc_tpu_torch.utils.fastq import FastqFormatError, RecordIndex
from phyngsc_tpu_torch.utils.shapes import bucket_length, bucket_records
from phyngsc_tpu_torch.models import dna, quality, title
from phyngsc_tpu_torch.ops import bitpack, lookup, tables, transfer
from phyngsc_tpu_torch.ops.bitpack_host import bytes_to_words, words_to_bytes

FLAG_VARIABLE_LENGTH = 1
FLAG_DELTA = 2
FLAG_CRC = 4

#: stage timing sink, set by the drivers under PHYNGSC_TIMING (else None):
#: label -> accumulated seconds, and h2d_bytes / d2h_bytes -> bytes moved
#: between host and device. The labels are phyngsc_tpu's (pipeline/
#: subblock.py:131-150); updates go through one lock, since stages A and C
#: and the decode's stage B run on the drivers' worker threads.
TIMING = None
_TIMING_LOCK = threading.Lock()


def _add(key: str, value: float) -> None:
    timing = TIMING
    if timing is not None:
        with _TIMING_LOCK:
            timing[key] = timing.get(key, 0.0) + value


def _tick(label: str, t0: float) -> float:
    """Add the seconds since t0 to `label`; returns the new start. Without
    a sink it reads no clock."""
    if TIMING is None:
        return t0
    now = time.perf_counter()
    _add(label, now - t0)
    return now


def _acct(key: str, nbytes: int) -> None:
    """Transfer-byte accounting: h2d_bytes / d2h_bytes."""
    if TIMING is not None:
        _add(key, float(nbytes))


def timing_line(timing: dict) -> str:
    """The sink as k=v pairs in label order: seconds as 0.00s, bytes as
    integers."""
    return " ".join(f"{k}={int(v)}" if k.endswith("_bytes") else f"{k}={v:.2f}s"
                    for k, v in sorted(timing.items()))


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


def _to_device(a, device):
    """The sub-block's one funnel of host-to-device copies, each counted in
    h2d_bytes: a host array, or a filled device.Staging (then its pieces
    come back), in one copy (device.upload: non-blocking, from pinned
    memory, on the current stream)."""
    _acct("h2d_bytes", a.nbytes)
    if isinstance(a, Staging):
        return a.send()
    return upload([a], device)[0]


def _upload_together(arrays, device) -> list:
    """Host arrays -> device tensors of the same dtypes and shapes, made by
    one host-to-device copy: each array is written once, at a 16-byte
    offset, into the pinned staging buffer (the kernels load 16 bytes at a
    time)."""
    return _to_device(Staging.of(arrays, device), device)


def _upload_words(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> int32 device tensor holding the same bits."""
    return _to_device(np.asarray(words, np.uint32).view(np.int32), device)


def _fetch(p) -> np.ndarray:
    """The host array of a device.Pending fetch, once its own event has
    completed; counted in d2h_bytes."""
    a = p.result()
    _acct("d2h_bytes", a.nbytes)
    return a


def _is_variable(lens_np: np.ndarray) -> bool:
    return bool(lens_np.shape[0]) and not bool(np.all(lens_np == lens_np[0]))


def _record_lens(lens_np: np.ndarray, Rp: int, device,
                 lo: int = 0) -> torch.Tensor:
    """(Rp,) int32 lengths of records lo .. lo + Rp - 1 on the device, 0 for
    padding: computed there when every record has the same length, else
    uploaded."""
    R = lens_np.shape[0]
    live = min(max(R - lo, 0), Rp)
    if not _is_variable(lens_np):
        Lt = int(lens_np[0]) if R else 0
        r = torch.arange(Rp, device=device)
        return torch.where(r < live, Lt, 0).to(torch.int32)
    pad = np.zeros(Rp, np.int32)
    pad[:live] = lens_np[lo:lo + live]
    return _to_device(pad, device)


def _upload_rows(plane: np.ndarray, lo: int, rows: int,
                 device) -> torch.Tensor:
    """Rows lo .. lo + rows - 1 of a host (R, L) plane on the device, zero
    past row R."""
    out = torch.zeros((rows, plane.shape[1]), dtype=torch.uint8,
                      device=device)
    live = min(max(plane.shape[0] - lo, 0), rows)
    if live:
        out[:live] = _to_device(plane[lo:lo + live], device)
    return out


def _upload_packed(seq_np: np.ndarray, qual_np: np.ndarray,
                   lens_np: np.ndarray, Rp: int, device) -> tuple:
    """The host (R, L) planes packed (ops/transfer) and uploaded in one copy
    [seq words | qual words], unpacked into rows 0 .. R - 1 of zeroed
    (Rp, L) planes, the columns past each record's length zeroed again (the
    packer writes 'A' / chr(33) there): the raw planes exactly. Returns
    (the sequence words' mode, the (2, Rp, L) uint8 seq/qual planes, the
    (Rp,) lengths) on `device`."""
    R, L = seq_np.shape
    s_mode, s_words = transfer.pack_seq_np(seq_np)
    q_mode, q_words = transfer.pack_qual_np(qual_np)
    ns = s_words.shape[0]
    # both packers' words written straight into the pinned staging buffer
    staged = Staging([((ns + q_words.shape[0],), np.int32)], device, align=4)
    staged.views[0].view(np.uint32)[:ns] = s_words
    staged.views[0].view(np.uint32)[ns:] = q_words
    (words,) = _to_device(staged, device)
    lens = _record_lens(lens_np, Rp, device)
    planes = torch.zeros((2, Rp, L), dtype=torch.uint8, device=device)
    valid = quality.valid_mask(lens[:R], L)
    planes[0, :R] = torch.where(
        valid, transfer.unpack_seq(words[:ns], s_mode, R, L), 0)
    planes[1, :R] = torch.where(
        valid, transfer.unpack_qual(words[ns:], q_mode, R, L), 0)
    return s_mode, planes, lens


def analyze_rows(seq: torch.Tensor, qual: torch.Tensor, lens: torch.Tensor,
                 small: bool, live: int):
    """Ambiguity transfer of (rows, L) planes on one device and both
    histograms (K1) of their first `live` rows: (qual_t, keep, quality
    counts (min(L, 256), 256), DNA counts (256,)). small: every byte of the
    sub-block's bases is < 128."""
    qual_t, keep, _ = dna.transfer_ambiguity(seq, qual, lens)
    return (qual_t, keep, quality.analyze(qual_t[:live], lens[:live]),
            dna.analyze(seq[:live], keep[:live], small_alpha=small))


def encode_rows(qual_t, keep, seq, lens, tables, G: int, q_cap: int,
                d_cap: int, mode: int, q_group: int, d_group: int,
                q_off: int, d_off: int) -> torch.Tensor:
    """Pack both streams of (rows, L) planes on one device with the fused
    tables `tables` there (quality table, tree ids[, DNA table]): one blob
    of 32-bit words (int32 holding the uint32 bits, as phyngsc_tpu's
    _encode_all fetches them) [q_words (q_cap) | d_words (d_cap) | q_sub
    (S) | d_sub (S) | q_total | d_total], S = rows / G."""
    q_tab, q_tree, *d_tab = tables
    q_words, q_sub, q_total = quality.encode_device(
        qual_t, lens, q_tab, q_tree, G, q_cap, q_group, q_off)
    d_words, d_sub, d_total = dna.encode_device(
        seq, keep, d_tab[0] if d_tab else None, mode, G, d_cap, d_group,
        d_off)
    return torch.cat([q_words, d_words, q_sub, d_sub, q_total.view(1),
                      d_total.view(1)]).to(torch.int32)


class _StageA:
    """Host gather + device analyze dispatched on the task's streams
    (device.task_streams, or None: the current streams), the counts'
    fetch started (counts_blob, a device.Pending). seq, lens, qual_t and
    keep are tensors, or with a codec lists of each shard's rows on its
    device."""

    __slots__ = ("R", "Lt", "L", "Rp", "lens_np", "tlens_np", "titles_np",
                 "is_delta", "seq", "lens", "qual_t", "keep", "counts_blob",
                 "n_q_counts", "t_future", "crc", "streams")


class _StageB:
    """Tables built, stream packing dispatched, its fetch started: one
    device.Pending blob a shard."""

    __slots__ = ("a", "q_tables", "d_plan", "t_enc", "blobs", "blob_layout")


def stage_a(buf: np.ndarray, idx: RecordIndex, cfg: CodecConfig,
            device, executor=None, rp=None, codec=None,
            streams=None) -> _StageA:
    """executor: optional ThreadPoolExecutor for the title encode. rp: the
    padded record count; the driver picks it from its shapes.BucketCtx on
    its own thread in task order (the picks depend on history, so output
    bytes would otherwise depend on timing). Default: bucket_records.
    codec: optional parallel.mesh.ShardedSubblockCodec; each shard's rows
    then go to its own device (`device` is unused). streams: the task's
    streams (device.task_streams), on which the task's device work runs;
    None: the current streams. The counts' fetch starts here, as soon as
    the histograms are queued (phyngsc_tpu's _host_async)."""
    st = _StageA()
    st.t_future = None
    st.crc = None
    st.streams = streams
    R = st.R = idx.n_records
    G = cfg.records_per_substream
    lens_np = st.lens_np = idx.seq_len.astype(np.int32)
    Lt = st.Lt = int(lens_np.max()) if R else 1
    L = st.L = bucket_length(Lt)
    n_shards = codec.n_data if codec is not None else 1
    Rp = st.Rp = rp if rp is not None else bucket_records(R, G, n_shards)
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

    def upload_rows(dev, lo, rows):
        """Rows lo .. lo + rows - 1: the raw planes (zero padding rows) and
        the lengths on dev, after the delta translation."""
        seq = _upload_rows(seq_np, lo, rows, dev)
        qual = _upload_rows(qual_np, lo, rows, dev)
        lens = _record_lens(lens_np, rows, dev, lo)
        if st.is_delta:
            seq = dna.delta_translate(seq, lens)
        return seq, qual, lens

    with use_streams(streams):
        if codec is not None:
            parts = []
            for dev, lo, hi in codec.row_ranges(Rp):
                with on_device(dev):
                    parts.append(upload_rows(dev, lo, hi - lo))
            st.seq, qual, st.lens = (list(x) for x in zip(*parts))
            counts, st.qual_t, st.keep = codec.analyze(
                st.seq, qual, st.lens, int(seq_np.max(initial=0)) < 128)
        else:
            s_mode, planes, st.lens = _upload_packed(seq_np, qual_np,
                                                     lens_np, Rp, device)
            st.seq, qual = planes[0], planes[1]
            if st.is_delta:
                st.seq = dna.delta_translate(st.seq, st.lens)
            # the histograms read the R live rows only (contiguous views):
            # the padding rows' masks are zero, so the counts are the same
            st.qual_t, st.keep, q_counts, d_counts = analyze_rows(
                st.seq, qual, st.lens,
                transfer.seq_alpha_small(s_mode, seq_np), R)
            counts = torch.cat([q_counts.reshape(-1), d_counts.reshape(-1)])
        st.counts_blob = fetch_async(counts)
    st.n_q_counts = min(L, quality.MAX_TREES) * quality.ALPHABET
    if executor is not None:
        st.t_future = executor.submit(title.encode, st.titles_np, tlens_np, cfg)
    return st


def stage_b(a: _StageA, cfg: CodecConfig, codec=None) -> _StageB:
    """codec: the parallel.mesh.ShardedSubblockCodec stage A ran with, if
    any. The packing runs on stage A's task streams; the blobs' fetches
    start as soon as it is queued."""
    t0 = time.perf_counter() if TIMING is not None else 0.0
    st = _StageB()
    st.a = a
    G = cfg.records_per_substream
    counts = _fetch(a.counts_blob)  # the one stage-A fetch
    t0 = _tick("b.counts_fetch", t0)
    q_counts = counts[: a.n_q_counts].reshape(-1, quality.ALPHABET)
    d_counts = counts[a.n_q_counts :]
    st.q_tables, q_group = quality.build_tables_adaptive(q_counts, cfg)
    st.d_plan = dna.plan(d_counts, cfg)
    huffman_dna = st.d_plan.mode == dna.MODE_HUFFMAN
    d_group = (lookup.group_for(int(st.d_plan.lens_tab.max()) or 1)
               if huffman_dna else 2)
    # fuse the code tables on the host, sliced to the occupied alphabet
    # window as the JAX encoder slices them (header serialization keeps the
    # full tables); they go to the device with the quality tree ids in one
    # copy
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
    t0 = _tick("b.tables", t0)

    S = a.Rp // G
    # a shard's stream needs at most the whole sub-block's words and at most
    # the worst case of its own rows
    rows = a.Rp // (codec.n_data if codec is not None else 1)
    worst = _word_cap(rows, a.L, G)
    q_cap = _exact_cap(q_counts, quality.lens_rows_for(st.q_tables,
                                                       q_counts.shape[0]),
                       S, worst)
    d_cap = _exact_cap(d_counts, st.d_plan.lens_tab if huffman_dna
                       else np.full(256, 2, np.int64), S, worst)
    args = (G, q_cap, d_cap, st.d_plan.mode, q_group, d_group, q_off, d_off)
    with use_streams(a.streams):
        if codec is not None:
            blobs = codec.encode(a.qual_t, a.keep, a.seq, a.lens, tables,
                                 *args)
        else:
            blobs = [encode_rows(a.qual_t, a.keep, a.seq, a.lens,
                                 _upload_together(tables, a.seq.device),
                                 *args)]
        st.blobs = [fetch_async(b) for b in blobs]
    st.blob_layout = (q_cap, d_cap, rows // G)
    t0 = _tick("b.encode_dispatch", t0)
    # title is host-heavy: runs on a worker thread started in stage A (or
    # inline here) while the device packs quality/dna
    st.t_enc = (a.t_future.result() if a.t_future is not None
                else title.encode(a.titles_np, a.tlens_np, cfg))
    _tick("b.title", t0)
    return st


def stage_c(b: _StageB, cfg: CodecConfig) -> bytes:
    a = b.a
    t0 = time.perf_counter() if TIMING is not None else 0.0
    # the stage-B fetch, one a shard: each waits for its own event only
    blobs = [_fetch(x).view(np.uint32) for x in b.blobs]
    _tick("c.fetch", t0)
    nqw, ndw, S = b.blob_layout
    # substreams never cross a shard: the tables concatenate and each
    # shard's words, trimmed to its total, follow the previous shard's
    q_sub, d_sub, q_parts, d_parts = [], [], [], []
    for blob in blobs:
        q_total, d_total = (int(x) for x in blob[nqw + ndw + 2 * S :])
        q_parts.append(blob[:q_total])
        d_parts.append(blob[nqw : nqw + d_total])
        q_sub.append(blob[nqw + ndw : nqw + ndw + S])
        d_sub.append(blob[nqw + ndw + S : nqw + ndw + 2 * S])
    q_sub = np.concatenate(q_sub).astype(np.int32)
    d_sub = np.concatenate(d_sub).astype(np.int32)

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

    q_stream = np.concatenate(q_parts).astype(np.uint32)
    qbw = BitWriter()
    quality.write_header(qbw, b.q_tables, q_sub, q_stream.shape[0])
    qbw.flush()
    quality_sec = qbw.getvalue() + words_to_bytes(q_stream)

    d_stream = np.concatenate(d_parts).astype(np.uint32)
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
                 "q_words", "d_plan", "d_sub", "d_words", "out_alpha",
                 "d_alpha", "q6")


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
    _output_alphabets(p)
    return p


def _output_alphabets(p: _DParsed) -> None:
    """p.out_alpha, p.d_alpha and p.q6 of the packed decode fetch (copied
    from phyngsc_tpu/pipeline/subblock.py:886-923)."""
    R = p.R
    # restored-output alphabet for the packed D2H fetch: provably complete —
    # kept positions hold DNA-plan symbols (plain mode only fires on pure
    # ACGT, dna.plan:217), transferred positions restore to AMB_CHAR chars
    # derivable from the quality tables' >=128 symbols
    if p.d_plan.mode == dna.MODE_PLAIN:
        dsyms = {65, 67, 71, 84}
    else:
        dsyms = set(np.flatnonzero(p.d_plan.lens_tab).tolist())
        if p.d_plan.singleton >= 0:
            dsyms.add(int(p.d_plan.singleton))
    qpresent = set(np.flatnonzero(
        np.count_nonzero(p.q_tables.lens, axis=0)).tolist())
    qpresent |= {int(s) for s in p.q_tables.singletons if s >= 0}
    restored_q = [33]
    rest_chars = set()
    for s in qpresent:
        if s >= 128:
            code = min(max((s - 128 + 16) >> 3, 0), 16)
            rest_chars.add(int(dna.AMB_CHAR[code]))
            restored_q.append((s - 128 + 16) - (code << 3) + 33)
        else:
            restored_q.append(s)
    p.q6 = max(restored_q) <= 96
    # 32 covers ACGT + the full 15-char IUPAC ambiguity set with room to
    # spare; beyond that (exotic alphabets) the raw u8 plane is shipped
    alpha = sorted(dsyms | rest_chars)
    p.out_alpha = (np.array(alpha, np.uint8)
                   if 0 < len(alpha) <= 32 and R else None)
    # qual8 fetch ships KEPT symbols only, so its index plane uses the DNA
    # alphabet's width (2-3 bits typical) — not the restored alphabet's.
    # It only pays off when transfers exist (rest_chars nonempty): a rich
    # kept alphabet WITHOUT transfers costs the same wire either way, and
    # the small mode's device restore is then an identity
    da = sorted(dsyms)
    p.d_alpha = (np.array(da, np.uint8)
                 if (p.out_alpha is not None and rest_chars
                     and 0 < len(da) <= 32) else None)


# _qual8_mode and _out_width are copied from phyngsc_tpu/pipeline/
# subblock.py:926-930 and :1127-1132.

def _qual8_mode(p: _DParsed) -> bool:
    """Rich restored alphabets (> 8 symbols = IUPAC-bearing sub-blocks)
    ship pre-restore planes and restore on host (_decode_tail qual8)."""
    return bool(p.out_alpha is not None and not p.is_delta
                and p.out_alpha.shape[0] > 8 and p.d_alpha is not None)


def _out_width(n_alpha: int) -> int:
    if n_alpha <= 4:
        return 2
    if n_alpha <= 8:
        return 3
    return 4 if n_alpha <= 16 else 5


# _OUT_PER, _out_fetch_words and _lane_unpack_np are copied from
# phyngsc_tpu/pipeline/subblock.py:288-313.

#: lane widths -> values per uint32 word (same layout as ops/transfer)
_OUT_PER = {2: 16, 3: 10, 4: 8, 5: 6, 6: 5, 8: 4}


def _out_fetch_words(n: int, w: int, q6: bool) -> tuple:
    per_s = _OUT_PER[w]
    per_q = 5 if q6 else 4
    return (n + per_s - 1) // per_s, (n + per_q - 1) // per_q


def _lane_unpack_np(words: np.ndarray, w: int, n: int) -> np.ndarray:
    per = _OUT_PER[w]
    shifts = (32 - w * (np.arange(per) + 1)).astype(np.uint32)
    lanes = (words[:, None] >> shifts[None, :]) & np.uint32((1 << w) - 1)
    return lanes.reshape(-1)[:n]


class _OutMeta:
    """How a non-delta sub-block's live rows are packed for the fetch
    (phyngsc_tpu's _pack_out / _decode_tail): alpha, the alphabet indexed
    (p.d_alpha in qual8 mode, else p.out_alpha); w, the index width; qual8:
    kept symbols and raw 8-bit qual_t, the ambiguity restored on the host;
    else restored symbols and q - 33 in 6 bits when q6, else 8 bits."""

    __slots__ = ("alpha", "w", "q6", "qual8")

    def __init__(self, p: _DParsed):
        self.qual8 = _qual8_mode(p)
        self.alpha = p.d_alpha if self.qual8 else p.out_alpha
        self.w = _out_width(self.alpha.shape[0])
        self.q6 = bool(p.q6) and not self.qual8

    def index_table(self) -> np.ndarray:
        """(256,) uint8 byte -> alphabet index (0 for other bytes), for one
        gather on the device."""
        tab = np.zeros(256, np.uint8)
        tab[self.alpha] = np.arange(self.alpha.shape[0])
        return tab


def _out_meta(p: _DParsed):
    """_OutMeta of a sub-block whose decode fetches packed rows, else None
    (delta sub-blocks, alphabets past 32 symbols, no records)."""
    if p.out_alpha is None or p.is_delta:
        return None
    return _OutMeta(p)


def _pack_out(seq: torch.Tensor, qual: torch.Tensor, index_tab: torch.Tensor,
              meta: _OutMeta) -> torch.Tensor:
    """(rows, L) uint8 symbols and qualities -> the fetch's int32 words
    [seq: w-bit alphabet indices | qual: q - 33 (0 below 33) in 6 bits when
    meta.q6, else the bytes], as phyngsc_tpu's _pack_out lays them out; the
    byte -> index map is one gather through index_tab."""
    q = qual.reshape(-1).long()
    if meta.q6:
        qw = transfer.pack_lanes(torch.where(q < 33, 0, q - 33), 6)
    else:
        qw = transfer.pack_lanes(q, 8)
    sw = transfer.pack_lanes(index_tab[seq.reshape(-1).long()], meta.w)
    return torch.cat([sw, qw])


class _DStage:
    """Decode stage A result, its fetch started (blobs: device.Pending, one
    a shard): the packed live rows (one blob; out_meta an _OutMeta), or
    the restored (2, rows, L) planes of each shard in row order (out_meta
    None)."""

    __slots__ = ("R", "L", "lens_np", "titles_np", "tlens_np", "blobs", "crc",
                 "out_meta")


#: an absent piece of the decode's upload
_NONE = np.zeros(0, np.uint8)


def decode_wires(p: _DParsed, cfg: CodecConfig) -> tuple:
    """The decode tables of a parsed sub-block as its upload carries them
    (ops/tables.py lens_wire: the lens4 words and the host's two-level
    layout): (quality, DNA or None in plain mode). Corrupt lengths raise
    here, before anything is uploaded."""
    bits = cfg.max_code_len
    q = tables.lens_wire(p.q_tables.lens, p.q_tables.singletons, bits,
                         kernels.masked_ids(p.L) if p.variable
                         else max(p.Lt, 1))
    d = (tables.lens_wire(p.d_plan.lens_tab[None, :], [p.d_plan.singleton],
                          bits) if p.d_plan.mode != dna.MODE_PLAIN else None)
    return q, d


def decode_lanes(p: _DParsed, cfg: CodecConfig, device, s0: int, s1: int,
                 wires: tuple, out_meta=None) -> torch.Tensor:
    """Lanes (substreams) s0 .. s1 - 1 of a parsed sub-block, records
    s0*G .. s1*G - 1, decoded on `device`: both streams' walk tables built
    there from the code lengths (K6, one launch) -> both word planes (K5)
    -> quality walk (K2, or K3 for variable lengths) -> keep mask -> DNA
    walk (K3) -> ambiguity restore -> delta untranslate, as phyngsc_tpu's
    _decode_walk_fused under PHYNGSC_DENSIFY=dma. wires: decode_wires(p,
    cfg). Every input goes up in one copy: both streams' words from the
    first word of lane s0 and their lane tables (bitpack.lane_table), each
    table's lens4 words and layout rows, the live records' lengths when
    they vary, dna.DECODE_TABLES and,
    with out_meta, its index table. Returns
    the (2, (s1 - s0)*G, L) uint8 seq/qual planes there, or with out_meta
    (an _OutMeta) the live rows packed by _pack_out, the ambiguity left to
    the host in qual8 mode."""
    G, bits = p.G, cfg.max_code_len
    q_sub, d_sub = p.q_sub[s0:s1], p.d_sub[s0:s1]
    q_wmax, sp = bitpack.plane_geometry(q_sub, G, p.L, bits)
    d_wmax, _ = bitpack.plane_geometry(d_sub, G, p.L, bits)
    rows = (s1 - s0) * G
    live = min(max(p.R - s0 * G, 0), rows)
    q_wire, d_wire = wires

    def words(all_words, sub_all, sub):
        w0 = int(np.sum(sub_all[:s0], dtype=np.int64))
        w1 = w0 + int(np.sum(sub, dtype=np.int64))
        return np.asarray(all_words[w0:w1], np.uint32).view(np.int32)

    # the sub-block's one H2D copy; absent pieces are empty
    (q_words, q_lanes, d_words, d_lanes, dna_tabs, q_lens, q_rows, d_lens,
     d_rows, lens16, index_tab) = _upload_together([
         words(p.q_words, p.q_sub, q_sub), bitpack.lane_table(q_sub),
         words(p.d_words, p.d_sub, d_sub), bitpack.lane_table(d_sub),
         dna.DECODE_TABLES, *q_wire.pieces(),
         *(d_wire.pieces() if d_wire else (_NONE, _NONE)),
         # < 2^16 (the meta section's 16-bit Lt bounds them)
         p.lens_np[s0 * G:s0 * G + live].astype(np.uint16).view(np.int16)
         if p.variable else _NONE,
         _NONE if out_meta is None else out_meta.index_table()], device)
    if p.variable:
        lens = torch.zeros(rows, dtype=torch.int32, device=device)
        lens[:live] = lens16.int() & 0xFFFF
    else:
        lens = _record_lens(p.lens_np, rows, device, s0 * G)
    dna_tabs = dna.device_tables(dna_tabs)

    q_walk, d_walk = tables.walk_luts_both(
        (q_wire, q_lens, q_rows), (d_wire, d_lens, d_rows) if d_wire else None)
    q_plane = bitpack.dense_words(q_words, q_lanes, q_wmax, sp)
    if p.variable:
        qual_t = quality.decode_walk_masked(
            q_plane, lens, q_walk, p.L, G, bits,
            legacy=cfg.legacy_tail_trees)
    else:
        qual_t = quality.decode_walk(
            q_plane, lens, q_walk, p.L, p.Lt, G, bits,
            legacy=cfg.legacy_tail_trees)
    keep = (qual_t < 128) & quality.valid_mask(lens, p.L)
    d_plane = bitpack.dense_words(d_words, d_lanes, d_wmax, sp)
    if d_wire:
        dna_syms = dna.decode_huffman_walk(d_plane, keep, d_walk, G, bits)
    else:
        dna_syms = dna.decode_plain_walk(d_plane, keep, G, dna_tabs["acgt"])
    if out_meta is not None and out_meta.qual8:
        return _pack_out(dna_syms[:live], qual_t[:live], index_tab, out_meta)
    seq, qual = dna.restore_ambiguity(dna_syms, qual_t, lens,
                                      dna_tabs["amb_char"])
    if out_meta is not None:
        return _pack_out(seq[:live], qual[:live], index_tab, out_meta)
    if p.is_delta:
        seq = dna.delta_untranslate(seq, lens, dna_tabs["nuc_index"])
    return torch.stack([seq, qual])


def _decode_device(p: _DParsed, cfg: CodecConfig, device,
                   codec=None) -> tuple:
    """(blobs, out_meta) of the sub-block, pending fetch. One device: the
    packed live rows (out_meta = _out_meta(p)), or the restored (2, Rp, L)
    planes where out_meta is None. With a codec
    (parallel.mesh.ShardedSubblockCodec): each shard's contiguous range of
    whole lanes on its own device, restored planes in row order."""
    if not p.R:
        return [torch.zeros((2, 0, p.L), dtype=torch.uint8,
                            device=device)], None
    # both tables are checked before anything is uploaded
    for sub in (p.q_sub, p.d_sub):
        bitpack.plane_geometry(sub, p.G, p.L, cfg.max_code_len)
    wires = decode_wires(p, cfg)
    if codec is not None:
        return codec.decode_walk(p, cfg, wires), None
    meta = _out_meta(p)
    return [decode_lanes(p, cfg, device, 0, p.q_sub.shape[0], wires,
                         meta)], meta


def decode_stage_a(data: bytes, cfg: CodecConfig, device,
                   executor=None, codec=None, streams=None) -> _DStage:
    """Parse on the host, then dispatch the decode on the task's streams
    (device.task_streams; None: the current streams) and start the fetch
    of its output as soon as it is queued (phyngsc_tpu's _host_async)."""
    t0 = time.perf_counter() if TIMING is not None else 0.0
    p = _decode_parse(data, cfg, executor)
    t0 = _tick("d.parse", t0)
    st = _DStage()
    st.R, st.L, st.lens_np, st.crc = p.R, p.L, p.lens_np, p.crc
    st.titles_np, st.tlens_np = p.titles_np, p.tlens_np
    with use_streams(streams):
        blobs, st.out_meta = _decode_device(p, cfg, device, codec)
        st.blobs = [fetch_async(b) for b in blobs]
    _tick("d.device_dispatch", t0)
    return st


def _unpack_out(words: np.ndarray, meta: _OutMeta, R: int, L: int) -> tuple:
    """The fetched words of _pack_out -> (R, L) uint8 seq/qual planes,
    through native.decode_tail or its numpy fallback (copied from
    phyngsc_tpu/pipeline/subblock.py:629-665): qual8 restores the
    ambiguity here, where qualities >= 128 mark the transferred
    positions."""
    from phyngsc_tpu_torch.utils import native

    n, w, alpha = R * L, meta.w, meta.alpha
    q6, qual8 = meta.q6, meta.qual8
    n_sw, n_qw = _out_fetch_words(n, w, q6)
    qb = 6 if q6 else 8
    a32 = np.zeros(32, np.uint8)
    a32[: alpha.shape[0]] = alpha
    nt = native.decode_tail(words[:n_sw], words[n_sw:n_sw + n_qw], n, w, qb,
                            plus33=q6, qual8=qual8, alpha=a32,
                            amb=dna.AMB_CHAR)
    if nt is not None:
        return nt[0].reshape(R, L), nt[1].reshape(R, L)
    # numpy fallback (native lib absent): identical math
    idx = _lane_unpack_np(words[:n_sw], w, n)
    q = _lane_unpack_np(words[n_sw:n_sw + n_qw], qb, n)
    if qual8:
        # host-side ambiguity restore (inverse of
        # phyNGSC.cpp:573-588): the fetched planes are PRE-restore —
        # kept-symbol alphabet indices and raw qual_t, whose symbols
        # >= 128 mark transferred positions (tasks.cpp:1084-1087).
        # int16 throughout: the values fit and the plane is
        # megabytes per sub-block
        qt = q.astype(np.int16)
        moved = qt >= 128
        code = np.clip((qt - 112) >> 3, 0, 16)
        seq = np.where(moved, dna.AMB_CHAR[code], alpha[idx])
        qual = np.where(moved, (qt - 112 - (code << 3) + 33
                                ).astype(np.int16), qt)
    else:
        seq = alpha[idx]
        qual = q + 33 if q6 else q
    return (seq.astype(np.uint8).reshape(R, L),
            qual.astype(np.uint8).reshape(R, L))


def decode_stage_b(st: _DStage) -> bytes:
    t0 = time.perf_counter() if TIMING is not None else 0.0
    parts = [_fetch(b) for b in st.blobs]  # the decode fetch, one a shard
    t0 = _tick("d.fetch", t0)
    if st.out_meta is not None:
        seq, qual = _unpack_out(parts[0].view(np.uint32), st.out_meta, st.R,
                                st.L)
    else:
        both = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        seq, qual = both[0, : st.R], both[1, : st.R]
    if st.tlens_np is None:        # title decode ran on a worker thread
        st.titles_np, st.tlens_np = st.titles_np.result()
    out = _reassemble(st.R, st.lens_np, st.titles_np, st.tlens_np, seq, qual)
    _tick("d.reassemble", t0)
    if st.crc is not None:
        import zlib

        if zlib.crc32(out) != st.crc:
            raise ValueError(
                "sub-block checksum mismatch: decoded bytes differ from the "
                "original input (corrupt container or codec defect)")
    return out


def encode_subblock(buf: np.ndarray, idx: RecordIndex, cfg: CodecConfig,
                    device="cuda") -> bytes:
    """One sub-block of records -> its bytes: the three stages composed
    as one task on a stream of its own (phyngsc_tpu's encode_subblock; the
    compress driver runs them software-pipelined across sub-blocks)."""
    device = resolve(device)
    a = stage_a(buf, idx, cfg, device, streams=task_streams([device]))
    return stage_c(stage_b(a, cfg), cfg)


def decode_subblock(data: bytes, cfg: CodecConfig, device="cuda") -> bytes:
    """Inverse of encode_subblock -> FASTQ text bytes, one task on a stream
    of its own (phyngsc_tpu's decode_subblock)."""
    device = resolve(device)
    return decode_stage_b(decode_stage_a(data, cfg, device,
                                         streams=task_streams([device])))


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

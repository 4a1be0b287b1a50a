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
no host thread waits for another sub-block's work. On one device each
stage's device work is one step of static shapes, phyngsc_tpu's one
executable a stage: analyze_all, encode_all and decode_walk_fused, keyed
by AnalyzeKey / EncodeKey / DecodeKey (the JAX package's static arguments
and its bucketed sizes, promoted by the drivers' shapes.BucketCtx); the
upload fills the prefix of a leased static input and each fetch takes
its output's live prefix, and on a card the step is a CUDA graph captured
once a key and replayed (graphs.py); on the CPU it runs directly. The
sharded codec calls the same bodies (analyze_rows, encode_rows,
decode_lanes) op by op. encode_subblock / decode_subblock compose the
stages as one task. Under PHYNGSC_TIMING the stages add their seconds and
the host<->device bytes to TIMING, with phyngsc_tpu's labels, and record
their spans (utils/logging.py's span recorder, whose one entry this module
is: the drivers, the stages and the title codec's tasks record through
span, task and recorded here; recorded_calls() gives the kept calls).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from phyngsc_tpu_torch import graphs, kernels
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import (Staging, fetch_async, layout_bytes,
                                     on_device, resolve, task_streams, upload,
                                     use_streams, views)
from phyngsc_tpu_torch.utils.bitio import BitReader, BitWriter
from phyngsc_tpu_torch.utils.fastq import FastqFormatError, RecordIndex
from phyngsc_tpu_torch.utils.logging import (  # noqa: F401
    count, counting, recorded, recorded_calls, span, task)
from phyngsc_tpu_torch.utils.shapes import (BucketCtx, bucket_length,
                                            bucket_records)
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


#: event counts beside the stage sink, set with it by the compress driver
#: (else None): q_tables.native (sub-blocks whose quality table search ran
#: in the host runtime), q_tables.candidates (the table sets it built),
#: t_encode.native (sub-blocks whose titles the host runtime encoded in
#: one call).
#: They stay out of _add, whose every label is seconds.
COUNTS = None


def _count(key: str, n: int) -> None:
    counts = COUNTS
    if counts is not None:
        with _TIMING_LOCK:
            counts[key] = counts.get(key, 0) + n


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


def _added(label: str, seconds: float) -> None:
    # _add looked up at each call, so that a wrapper installed over it sees
    # the spans' seconds
    _add(label, seconds)


def timed_span(label: str, *, wait: bool = False, sub: int | None = None):
    """The span of one of TIMING's labels: its seconds go to _add at its
    end."""
    return span(label, wait=wait, sub=sub, done=_added)


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


#: rungs a doubling of the ladder that sizes long variable-length planes
RUNGS = 4


def ladder(n: int) -> int:
    """The least rung 2^k * (1 + j / RUNGS), j < RUNGS, at or above n >= 1:
    RUNGS sizes a doubling, each less than 1 + 1 / RUNGS of what it holds
    (past RUNGS), and a multiple of 2^(k - 2) where 2^k < n."""
    if n <= RUNGS:
        return max(n, 1)
    step = (1 << ((n - 1).bit_length() - 1)) // RUNGS
    return -(-n // step) * step


def plane_length(L: int, variable: bool) -> int:
    """The position axis of a sub-block's planes and stage keys on one
    device, for the format's bucketed length L (bucket_length(Lt)): L for
    uniform lengths and for variable lengths of up to quality.MAX_TREES
    positions (their keys as ever), else the ladder's rung at or above L,
    so that long reads of any lengths share a few planes (65,536 at most).
    Positions past L emit no bits, and the quality trees keep grouping the
    format's L positions (analyze_all and the decode read L from their
    upload's header), so the bytes do not change."""
    return ladder(L) if variable and L > quality.MAX_TREES else L


def _rung(n: int, on: bool) -> int:
    """A size of a laddered sub-block's key at its ladder rung (on), else
    n."""
    return ladder(n) if on else n


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


def _upload_together(arrays, device, into=None) -> list:
    """Host arrays -> device tensors of the same dtypes and shapes, made by
    one host-to-device copy: each array is written once, at a 16-byte
    offset, into the pinned staging buffer (the kernels load 16 bytes at a
    time). into: a uint8 device buffer (a graph's static input) whose
    prefix the copy fills, instead of a new tensor."""
    return _to_device(Staging.of(arrays, device, into=into), device)


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


def analyze_rows(seq: torch.Tensor, qual: torch.Tensor, lens: torch.Tensor,
                 small: bool, span_len=None):
    """Ambiguity transfer of (rows, L) planes on one device and both
    histograms (K1) over every row (padding rows have length 0, so they
    count nothing): (qual_t, keep, quality counts (min(L, 256), 256), DNA
    counts (256,)). small: every byte of the sub-block's bases is < 128.
    span_len: the format's L of a laddered plane (a 0-d device tensor),
    whose positions the quality trees group; None: L."""
    qual_t, keep, _ = dna.transfer_ambiguity(seq, qual, lens)
    return (qual_t, keep, quality.analyze(qual_t, lens, span_len),
            dna.analyze(seq, keep, small_alpha=small))


class AnalyzeKey(NamedTuple):
    """The static arguments of analyze_all (phyngsc_tpu's _analyze_all
    static_argnames, with the sizes its traced shapes fix): L the planes'
    width (plane_length); Lt None for variable lengths (uploaded, else made
    from the live count); n_exc, the bucketed exception words of
    SEQ_2BIT_EXC (transfer._exc_bucket)."""

    Rp: int
    L: int
    Lt: int | None
    seq_mode: int
    qual_mode: int
    n_exc: int
    is_delta: bool
    small: bool

    def n_words(self) -> int:
        """The word capacity: both planes of Rp rows and the exceptions."""
        cells = self.Rp * self.L
        return (transfer.n_words(cells, "seq", self.seq_mode) + self.n_exc
                + transfer.n_words(cells, "qual", self.qual_mode))

    def specs(self, n_words: int) -> list:
        """Stage A's upload: the live record count (and padding), the
        lengths when they vary, then the words (capacity n_words())."""
        return [((4,), np.int32), ((self.Rp if self.Lt is None else 0,),
                                  np.int32), ((n_words,), np.int32)]


def _laddered(key) -> bool:
    """Whether a stage key's planes are on the ladder (plane_length): its
    quality trees then group the format's L, which the upload carries,
    and its graphs share their stage's pool (graphs.lease shared)."""
    return key.Lt is None and key.L > quality.MAX_TREES


def analyze_all(hdr: torch.Tensor, lens_in: torch.Tensor,
                words: torch.Tensor, key: AnalyzeKey) -> tuple:
    """Stage A's device step, phyngsc_tpu's _analyze_all: the upload (hdr:
    [R, the format's L, ...] int32; lens_in: the (Rp,) lengths when they
    vary; words: the
    sequence words of the R live rows [and their exceptions], then the
    quality words) -> the (Rp, L) planes, the ambiguity transfer, both
    histograms. Shapes and every host value come from `key`: R is read on
    the device, the quality words start where the live rows' sequence words
    end (one gather), and the rows past R unpack from whatever the buffer
    holds there and are zeroed by their length 0. Returns (seq, qual_t,
    keep, lens, counts: quality then DNA, int32)."""
    Rp, L = key.Rp, key.L
    dev = words.device
    R = hdr[0].long()
    if key.Lt is None:
        lens = lens_in
    else:
        lens = torch.where(torch.arange(Rp, device=dev) < R, key.Lt,
                           0).to(torch.int32)
    exc = key.seq_mode == transfer.SEQ_2BIT_EXC
    mode = transfer.SEQ_2BIT if exc else key.seq_mode
    per = 32 // transfer._width("seq", mode)
    seq = transfer.unpack_seq(words[:transfer.n_words(Rp * L, "seq", mode)],
                              mode, Rp, L)
    q_at = (R * L + per - 1) // per  # the live rows' sequence words
    if exc:
        ew = transfer.words_at(words, q_at, key.n_exc)
        seq = transfer.apply_exceptions(seq.reshape(-1), ew,
                                        R * L).reshape(Rp, L)
        q_at = q_at + key.n_exc
    qual = transfer.unpack_qual(transfer.words_at(
        words, q_at, transfer.n_words(Rp * L, "qual", key.qual_mode)),
        key.qual_mode, Rp, L)
    valid = quality.valid_mask(lens, L)
    seq = torch.where(valid, seq, 0)
    qual = torch.where(valid, qual, 0)
    if key.is_delta:
        seq = dna.delta_translate(seq, lens)
    qual_t, keep, q_counts, d_counts = analyze_rows(
        seq, qual, lens, key.small, hdr[1] if _laddered(key) else None)
    return seq, qual_t, keep, lens, torch.cat([q_counts.reshape(-1),
                                               d_counts.reshape(-1)])


class EncodeKey(NamedTuple):
    """The static arguments of encode_all (phyngsc_tpu's _encode_all
    static_argnames, its code tables' shapes) and the stage-A key whose
    outputs it reads."""

    analyze: AnalyzeKey
    tables: tuple   # the shapes of the quality table, its ids[, DNA table]
    mode: int
    G: int
    q_cap: int
    d_cap: int
    q_group: int
    d_group: int


def encode_all(qual_t, keep, seq, lens, q_tab, q_tree, d_tab, offs, *,
               G: int, q_cap: int, d_cap: int, mode: int, q_group: int,
               d_group: int) -> torch.Tensor:
    """Stage B's device step, phyngsc_tpu's _encode_all: both streams of
    (rows, L) planes packed with the fused tables on the device (quality
    table, tree ids, DNA table or None in plain mode) and the alphabet
    windows' origins offs = (q_off, d_off) (ints, or a (2,) int32 tensor on
    the device) into one blob of 32-bit words (int32 holding the uint32
    bits) [q_words (q_cap) | d_words (d_cap) | q_sub (S) | d_sub (S) |
    q_total | d_total], S = rows / G; words past a stream's total are 0."""
    q_words, q_sub, q_total = quality.encode_device(
        qual_t, lens, q_tab, q_tree, G, q_cap, q_group, offs[0])
    d_words, d_sub, d_total = dna.encode_device(
        seq, keep, d_tab, mode, G, d_cap, d_group, offs[1])
    return torch.cat([q_words, d_words, q_sub, d_sub, q_total.view(1),
                      d_total.view(1)]).to(torch.int32)


def encode_rows(qual_t, keep, seq, lens, tables, G: int, q_cap: int,
                d_cap: int, mode: int, q_group: int, d_group: int,
                q_off: int, d_off: int) -> torch.Tensor:
    """encode_all of one shard's rows with its uploaded `tables` (quality
    table, tree ids[, DNA table]) and host window origins (the sharded
    codec's call)."""
    q_tab, q_tree, *d_tab = tables
    return encode_all(qual_t, keep, seq, lens, q_tab, q_tree,
                      d_tab[0] if d_tab else None, (q_off, d_off), G=G,
                      q_cap=q_cap, d_cap=d_cap, mode=mode, q_group=q_group,
                      d_group=d_group)


class _StageA:
    """Host gather + device analyze dispatched on the task's streams
    (device.task_streams, or None: the current streams), the counts'
    fetch started (counts_blob, a device.Pending). seq, lens, qual_t and
    keep are tensors, or with a codec lists of each shard's rows on its
    device."""

    __slots__ = ("R", "Lt", "L", "W", "Rp", "lens_np", "tlens_np",
                 "titles_np", "is_delta", "seq", "lens", "qual_t", "keep",
                 "counts_blob", "n_q_counts", "t_future", "crc", "streams",
                 "key")


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
    None: the current streams. One device: the packed live rows go up in
    one copy into analyze_all's input (graphs.lease: a graph's static
    input on a card, leased until its outputs are copied out). The counts'
    fetch starts here, as soon as the histograms are queued (phyngsc_tpu's
    _host_async)."""
    st = _StageA()
    st.t_future = None
    st.crc = None
    st.streams = streams
    st.key = None
    R = st.R = idx.n_records
    G = cfg.records_per_substream
    lens_np = st.lens_np = idx.seq_len.astype(np.int32)
    Lt = st.Lt = int(lens_np.max()) if R else 1
    L = st.L = bucket_length(Lt)
    # the planes' width: the sharded codec's steps take the format's L
    W = st.W = (L if codec is not None
                else plane_length(L, _is_variable(lens_np)))
    n_shards = codec.n_data if codec is not None else 1
    Rp = st.Rp = rp if rp is not None else bucket_records(R, G, n_shards)
    if Lt > 0xFFFF:
        raise FastqFormatError(
            f"read length {Lt} exceeds the container's 65535 limit")
    tlens_np = st.tlens_np = (idx.title_end - idx.title_start).astype(np.int32)
    TL = int(tlens_np.max()) if R else 1
    from phyngsc_tpu_torch.utils import native as _native

    with span("a.gather"):
        g3 = (_native.gather3(buf, idx.title_start, tlens_np, TL,
                              idx.seq_start, idx.qual_start, lens_np, W)
              if R else None)
        if g3 is not None:
            st.titles_np, seq_np, qual_np, qmax = g3
        else:
            seq_np = _gather_matrix(buf, idx.seq_start,
                                    lens_np.astype(np.int64), W)
            qual_np = _gather_matrix(buf, idx.qual_start,
                                     lens_np.astype(np.int64), W)
            st.titles_np = _gather_matrix(buf, idx.title_start,
                                          tlens_np.astype(np.int64), TL)
            qmax = int(qual_np.max()) if R else 0
        if R and qmax >= 128:
            raise FastqFormatError(
                "quality byte >= 128 in input: outside printable phred+33 "
                "and reserved for the ambiguity transfer (phyNGSC.cpp:579 "
                "encoding)")
        st.is_delta = dna.detect_delta(seq_np, lens_np)
    if cfg.checksum and R:
        import zlib

        with span("a.crc"):
            text = buf[int(idx.title_start[0]) : int(idx.qual_end[-1]) + 1]
            st.crc = zlib.crc32(np.ascontiguousarray(text))

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
            with span("a.upload_analyze"):
                parts = []
                for dev, lo, hi in codec.row_ranges(Rp):
                    with on_device(dev):
                        parts.append(upload_rows(dev, lo, hi - lo))
                st.seq, qual, st.lens = (list(x) for x in zip(*parts))
                counts, st.qual_t, st.keep = codec.analyze(
                    st.seq, qual, st.lens, int(seq_np.max(initial=0)) < 128)
        else:
            counts = _analyze_device(st, seq_np, qual_np, device)
        st.counts_blob = fetch_async(counts)
    st.n_q_counts = min(L, quality.MAX_TREES) * quality.ALPHABET
    if executor is not None:
        st.t_future = executor.submit(task(title.encode, "t.encode"),
                                      st.titles_np, tlens_np, cfg)
    return st


def _analyze_device(st: _StageA, seq_np: np.ndarray, qual_np: np.ndarray,
                    device) -> torch.Tensor:
    """Stage A on one device: the host (R, W) planes packed (ops/transfer)
    into pinned staging, then uploaded with the live count (and the
    lengths when they vary) in one copy into a leased static input, and
    analyze_all run on it; st.key, the outputs and the counts (returned)
    set, copied out of a graph's static outputs before the lease goes. The
    planes are st.W wide; the header carries the format's L."""
    R, W, Rp = st.R, st.W, st.Rp
    with span("a.pack"):
        s_mode, s_words = transfer.pack_seq_np(seq_np)
        q_mode, q_words = transfer.pack_qual_np(qual_np)
        n_exc = (s_words.shape[0] - transfer.n_words(R * W, "seq",
                                                     transfer.SEQ_2BIT)
                 if s_mode == transfer.SEQ_2BIT_EXC else 0)
        variable = _is_variable(st.lens_np)
        key = st.key = AnalyzeKey(Rp, W, None if variable else st.Lt, s_mode,
                                  q_mode, n_exc, st.is_delta,
                                  transfer.seq_alpha_small(s_mode, seq_np))
    with span("a.upload_analyze"):
        cap = key.specs(key.n_words())
        ns = s_words.shape[0]
        # the header, the lengths and both packers' words, written straight
        # into the pinned staging buffer
        staged = Staging(key.specs(ns + q_words.shape[0]), device, align=4)
        hdr, lens_in, words = staged.views
        hdr[:] = (R, st.L, 0, 0)
        if variable:
            lens_in[:R] = st.lens_np
            lens_in[R:] = 0
        words.view(np.uint32)[:ns] = s_words
        words.view(np.uint32)[ns:] = q_words
        ls = graphs.lease(device, "analyze_all", key, layout_bytes(cap, 4),
                          shared=_laddered(key))
        try:
            _to_device(staged.into(ls.inputs), device)
            args = views(ls.inputs, cap, 4)
            out = ls.run(lambda: analyze_all(*args, key))
            if ls.static:  # the task's own, before the next replay
                out = [t.clone() for t in out]
            st.seq, st.qual_t, st.keep, st.lens, counts = out
            del out
        except BaseException:
            ls.release(ok=False)
            raise
        ls.release()
    return counts


def stage_b(a: _StageA, cfg: CodecConfig, codec=None,
            buckets=None) -> _StageB:
    """codec: the parallel.mesh.ShardedSubblockCodec stage A ran with, if
    any. buckets: the driver's shapes.BucketCtx (stage B runs on the
    driver's thread, in task order), from which one device's encode caps
    are promoted. The packing runs on stage A's task streams; the blobs'
    fetches start as soon as it is queued."""
    st = _StageB()
    st.a = a
    G = cfg.records_per_substream
    with timed_span("b.counts_fetch", wait=True):
        counts = _fetch(a.counts_blob)  # the one stage-A fetch
    with timed_span("b.tables"):
        q_counts = counts[: a.n_q_counts].reshape(-1, quality.ALPHABET)
        d_counts = counts[a.n_q_counts :]
        with span("b.tables.quality"):
            q_search = {}
            st.q_tables, q_group = quality.build_tables_adaptive(
                q_counts, cfg, q_search)
        _count("q_tables.native", q_search["native"])
        _count("q_tables.candidates", q_search["candidates"])
        with span("b.tables.dna"):
            st.d_plan = dna.plan(d_counts, cfg)
        huffman_dna = st.d_plan.mode == dna.MODE_HUFFMAN
        d_group = (lookup.group_for(int(st.d_plan.lens_tab.max()) or 1)
                   if huffman_dna else 2)
        # fuse the code tables on the host, sliced to the occupied alphabet
        # window as the JAX encoder slices them (header serialization keeps
        # the full tables); they go to the device with the quality tree ids
        # in one copy
        with span("b.tables.fuse"):
            q_off, q_A = lookup.window_np(q_counts)
            tables = list(quality.encode_tables(
                st.q_tables.codes[:, q_off:q_off + q_A],
                st.q_tables.lens[:, q_off:q_off + q_A], a.W, a.L))
            d_off = 0
            if huffman_dna:
                d_off, d_A = lookup.window_np(d_counts.reshape(1, -1))
                tables.append(lookup.fused_table_np(
                    st.d_plan.codes_tab[None, d_off:d_off + d_A],
                    st.d_plan.lens_tab[None, d_off:d_off + d_A]
                ).view(np.int16))

    with timed_span("b.encode_dispatch"):
        S = a.Rp // G
        # a shard's stream needs at most the whole sub-block's words and at
        # most the worst case of its own rows
        rows = a.Rp // (codec.n_data if codec is not None else 1)
        worst = _word_cap(rows, a.W, G)
        q_cap = _exact_cap(q_counts, quality.lens_rows_for(
            st.q_tables, q_counts.shape[0]), S, worst)
        d_cap = _exact_cap(d_counts, st.d_plan.lens_tab if huffman_dna
                           else np.full(256, 2, np.int64), S, worst)
        with use_streams(a.streams):
            if codec is not None:
                blobs = codec.encode(a.qual_t, a.keep, a.seq, a.lens, tables,
                                     G, q_cap, d_cap, st.d_plan.mode,
                                     q_group, d_group, q_off, d_off)
                st.blobs = [fetch_async(b) for b in blobs]
            else:
                st.blobs = [_encode_device(a, tables, q_off, d_off, worst,
                                           q_cap, d_cap, st.d_plan.mode, G,
                                           q_group, d_group, buckets)]
        st.blob_layout = (q_cap, d_cap, rows // G)
    # title is host-heavy: runs on a worker thread started in stage A (or
    # inline here) while the device packs quality/dna
    with timed_span("b.title", wait=a.t_future is not None):
        st.t_enc = (a.t_future.result() if a.t_future is not None
                    else title.encode(a.titles_np, a.tlens_np, cfg))
    _count("t_encode.native", int(st.t_enc.native))
    return st


def _encode_device(a: _StageA, tables: list, q_off: int, d_off: int,
                   worst: int, q_cap: int, d_cap: int, mode: int, G: int,
                   q_group: int, d_group: int, buckets):
    """Stage B on one device: stage A's planes copied into encode_all's
    static input (graphs.lease) where it is a graph's, and the tables and
    the window origins uploaded after them in one copy; the caps promoted
    as phyngsc_tpu promotes them (BucketCtx.pick_words, keyed by Rp; a
    laddered sub-block's from their ladder rungs); encode_all run, and the
    fetch of the blob's pieces up to the exact caps (stage_c reads exactly
    today's layout) started before the lease goes. Returns the Pending."""
    qc, dc = q_cap, d_cap
    if buckets is not None:
        on = _laddered(a.key)
        qc = buckets.pick_words(f"enc_q:{a.Rp}",
                                min(_rung(q_cap, on), worst), worst)
        dc = buckets.pick_words(f"enc_d:{a.Rp}",
                                min(_rung(d_cap, on), worst), worst)
    pieces = [*tables, np.array([q_off, d_off], np.int32)]
    key = EncodeKey(a.key, tuple(t.shape for t in tables), mode, G, qc, dc,
                    q_group, d_group)
    planes = [a.qual_t, a.keep, a.seq, a.lens]
    p_specs = [(tuple(t.shape), _NP_DTYPES[t.dtype]) for t in planes]
    at = layout_bytes(p_specs)
    ls = graphs.lease(a.seq.device, "encode_all", key, at + layout_bytes(
        [(t.shape, t.dtype) for t in pieces]), shared=_laddered(a.key))
    try:
        if ls.static:
            for v, t in zip(views(ls.inputs, p_specs), planes):
                v.copy_(t)
            planes = views(ls.inputs, p_specs)
        ups = _upload_together(pieces, a.seq.device, into=ls.inputs[at:])
        q_tab, q_tree, *d_tab = ups[:-1]
        blob = ls.run(lambda: encode_all(
            *planes, q_tab, q_tree, d_tab[0] if d_tab else None, ups[-1],
            G=G, q_cap=qc, d_cap=dc, mode=mode, q_group=q_group,
            d_group=d_group))
        pending = fetch_async(blob[:q_cap], blob[qc:qc + d_cap],
                              blob[qc + dc:])
        del blob  # none of the instance's outputs held past the lease
    except BaseException:
        ls.release(ok=False)
        raise
    ls.release()
    return pending


#: numpy dtypes of stage A's outputs, for views of a static input
_NP_DTYPES = {torch.uint8: np.uint8, torch.bool: np.bool_,
              torch.int32: np.int32}


def stage_c(b: _StageB, cfg: CodecConfig) -> bytes:
    with timed_span("c.fetch", wait=True):
        # the stage-B fetch, one a shard: each waits for its own event only
        blobs = [_fetch(x).view(np.uint32) for x in b.blobs]
    with span("c.assemble"):
        return _assemble(b, blobs)


def _assemble(b: _StageB, blobs: list) -> bytes:
    """Stage C's sections from the fetched blobs."""
    a = b.a
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

    __slots__ = ("R", "Lt", "L", "W", "Rp", "G", "variable", "is_delta",
                 "crc", "lens_np", "titles_np", "tlens_np", "q_tables",
                 "q_sub", "q_words", "d_plan", "d_sub", "d_words",
                 "out_alpha", "d_alpha", "q6")


def _decode_parse(data: bytes, cfg: CodecConfig, executor=None) -> _DParsed:
    """executor: optional ThreadPoolExecutor — the title decode then runs on
    a worker thread and p.titles_np is a Future (p.tlens_np None)."""
    p = _DParsed()
    with span("d.parse.meta"):
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
        p.L = p.W = bucket_length(Lt)  # W: the planes' (_decode_device)
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

    with span("d.parse.title"):
        br = BitReader(title_sec)
        t_plan, n_fixed, n_char, t_sub = title.read_header(br, R)
        br.align()
        fixed_words = bytes_to_words(br.get_bytes(4 * n_fixed))
        char_words = bytes_to_words(br.get_bytes(4 * n_char))
        if executor is not None and R:
            p.titles_np = executor.submit(
                task(title.decode, "t.decode"), t_plan, fixed_words,
                char_words, t_sub, R, cfg)
            p.tlens_np = None
        else:
            p.titles_np, p.tlens_np = title.decode(
                t_plan, fixed_words, char_words, t_sub, R, cfg)

    # quality first: it carries the ambiguity transfer
    with span("d.parse.quality"):
        br = BitReader(quality_sec)
        p.q_tables, p.q_sub, q_total = quality.read_header(br)
        br.align()
        _check_tables(p.q_tables.lens, p.q_tables.singletons, "quality",
                      cfg)
        # Rp comes from the stored substream table (agnostic to the
        # encoder's bucketing)
        p.Rp = (p.q_sub.shape[0] * G if p.q_sub.shape[0]
                else bucket_records(R, G))
        if p.Rp < R or (R and not p.q_sub.shape[0]):
            raise ValueError(f"corrupt quality substream table: capacity "
                             f"{p.Rp} < {R} records")

    with span("d.parse.dna"):
        dbr = BitReader(dna_sec)
        p.d_plan, p.d_sub, d_total, is_delta_hdr = dna.read_header(dbr)
        p.is_delta = p.is_delta or is_delta_hdr
        if p.d_plan.mode != dna.MODE_PLAIN:
            _check_tables(p.d_plan.lens_tab[None, :],
                          np.array([p.d_plan.singleton], np.int32), "DNA",
                          cfg)
        if p.d_sub.shape[0] != p.q_sub.shape[0]:
            raise ValueError(
                "corrupt container: DNA substream table length "
                f"{p.d_sub.shape[0]} != quality's {p.q_sub.shape[0]}")
        dbr.align()
    with span("d.parse.words"):
        p.q_words = bytes_to_words(br.get_bytes(4 * q_total))
        p.d_words = bytes_to_words(dbr.get_bytes(4 * d_total))
    with span("d.parse.alphabets"):
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
                         kernels.masked_ids(p.W) if p.variable
                         else max(p.Lt, 1))
    d = (tables.lens_wire(p.d_plan.lens_tab[None, :], [p.d_plan.singleton],
                          bits) if p.d_plan.mode != dna.MODE_PLAIN else None)
    return q, d


class OutKey(NamedTuple):
    """The static part of an _OutMeta: index width, 6-bit quality, qual8."""

    w: int
    q6: bool
    qual8: bool


class DecodeKey(NamedTuple):
    """The static arguments of decode_walk_fused (phyngsc_tpu's
    _decode_walk_fused static_argnames under PHYNGSC_DENSIFY=dma): rows =
    S * G decoded; L the planes' width (plane_length); Lt None for
    variable lengths; n_words, the word buffer's
    capacity; q and d, each stream's walk-table shape (n_trees, k, own,
    n_blocks, n: the launch arguments K6, K2 and K3 take by value), d None
    in plain mode; the planes' Wmax and Sp; out, the packed fetch's OutKey
    (None: the restored planes)."""

    rows: int
    S: int
    G: int
    L: int
    Lt: int | None
    bits: int
    legacy: bool
    n_words: int
    q: tuple
    d: tuple | None
    q_wmax: int
    d_wmax: int
    sp: int
    out: OutKey | None
    is_delta: bool


def _table_shape(wire) -> tuple | None:
    if wire is None:
        return None
    lay = wire.layout
    return (wire.n_trees, lay.k, lay.own, lay.n_blocks, lay.n)


def _padded(n: int) -> int:
    """phyngsc_tpu's decode word pad (subblock.py _padded): 16K-word
    granularity with 8 words of slack, at least one granule."""
    bucket = 1 << 14
    return max((n + 8 + bucket - 1) // bucket * bucket, bucket)


def _widen(wire, kind: str, Rp: int, n_ids: int, buckets):
    """The LensWire with its two-level layout widened (ops/tables.py
    widened) to the blocks of its own that buckets.pick_words gives kind
    at Rp, from the power of two at or above its own: sub-blocks of one
    shape then share the walks' table sizes. Layouts with a shared block
    of escapes are already static (their own fills the budget); so is
    k = 0."""
    lay = wire.layout
    if not lay.k or lay.own != lay.n_blocks:
        return wire
    most = tables.widest(lay, wire.lut_bits, kernels.table_budget(n_ids))
    natural = min(1 << max(lay.own - 1, 0).bit_length(), most)
    own = buckets.pick_words(f"{kind}:{Rp}:{wire.n_trees}:{lay.k}", natural,
                             most)
    return dataclasses.replace(
        wire, layout=tables.widened(lay, own, wire.lut_bits))


def _decode_inputs(p: _DParsed, cfg: CodecConfig, s0: int, s1: int,
                   wires: tuple, out_meta, buckets=None) -> tuple:
    """The decode of lanes s0 .. s1 - 1 as decode_walk_fused takes it:
    (key, the upload's host pieces, the word capacity, the wires). Pieces:
    the live record count (and padding), both lane tables
    (bitpack.lane_table; the DNA lanes' starts past the quality words),
    dna.DECODE_TABLES, each table's lens4 words and layout rows (absent for
    plain DNA), the lengths as uint16 when they vary (0 past the live
    records), out_meta's index table, then both streams' words from the
    first word of lane s0. With the driver's buckets (BucketCtx, on its
    thread in task order) the word capacity, the plane heights and the
    walk tables' layouts are promoted as phyngsc_tpu's decode promotes
    its word pads and plane heights (keyed by Rp; a laddered sub-block's
    from their ladder rungs); else they are exact. The planes are p.W
    wide; the header carries the format's L."""
    G, bits, W = p.G, cfg.max_code_len, p.W
    q_sub, d_sub = p.q_sub[s0:s1], p.d_sub[s0:s1]
    q_wmax, sp = bitpack.plane_geometry(q_sub, G, p.L, bits)
    d_wmax, _ = bitpack.plane_geometry(d_sub, G, p.L, bits)
    S = s1 - s0
    rows = S * G
    live = min(max(p.R - s0 * G, 0), rows)

    def words(all_words, sub_all, sub):
        w0 = int(np.sum(sub_all[:s0], dtype=np.int64))
        w1 = w0 + int(np.sum(sub, dtype=np.int64))
        return np.asarray(all_words[w0:w1], np.uint32).view(np.int32)

    q_words = words(p.q_words, p.q_sub, q_sub)
    d_words = words(p.d_words, p.d_sub, d_sub)
    nq = q_words.shape[0]
    cap = nq + d_words.shape[0]
    q_wire, d_wire = wires
    if buckets is not None:
        on = p.variable and W > quality.MAX_TREES
        cap = (buckets.pick_words(f"dec_q:{p.Rp}", _rung(_padded(nq), on))
               + buckets.pick_words(f"dec_d:{p.Rp}", _rung(
                   _padded(d_words.shape[0]), on)))
        q_wmax = buckets.pick_words(f"wmax_q:{p.Rp}", _rung(q_wmax, on))
        d_wmax = buckets.pick_words(f"wmax_d:{p.Rp}", _rung(d_wmax, on))
        q_wire = _widen(q_wire, "own_q", p.Rp, kernels.masked_ids(W)
                        if p.variable else max(p.Lt, 1), buckets)
        if d_wire is not None:
            d_wire = _widen(d_wire, "own_d", p.Rp, 1, buckets)
    d_lanes = bitpack.lane_table(d_sub)
    d_lanes[0] += nq
    lens16 = _NONE
    if p.variable:
        # < 2^16 (the meta section's 16-bit Lt bounds them)
        lens16 = np.zeros(rows, np.uint16)
        lens16[:live] = p.lens_np[s0 * G:s0 * G + live]
        lens16 = lens16.view(np.int16)
    pieces = [np.array([live, p.L, 0, 0], np.int32),
              bitpack.lane_table(q_sub),
              d_lanes, dna.DECODE_TABLES, *q_wire.pieces(),
              *(d_wire.pieces() if d_wire else (_NONE, _NONE)), lens16,
              _NONE if out_meta is None else out_meta.index_table(),
              np.concatenate([q_words, d_words])]
    key = DecodeKey(
        rows, S, G, W, None if p.variable else p.Lt, bits,
        bool(cfg.legacy_tail_trees), cap, _table_shape(q_wire),
        _table_shape(d_wire), q_wmax, d_wmax, sp,
        None if out_meta is None else OutKey(out_meta.w, out_meta.q6,
                                             out_meta.qual8),
        bool(p.is_delta))
    return key, pieces, cap, (q_wire, d_wire)


def decode_walk_fused(pieces, key: DecodeKey, wires: tuple) -> torch.Tensor:
    """The decode's device step, phyngsc_tpu's _decode_walk_fused under
    PHYNGSC_DENSIFY=dma, on the pieces of _decode_inputs on one device (the
    words up to key.n_words): both streams' walk tables built there from
    the code lengths (K6, one launch) -> both word planes (K5, one buffer
    of words) -> quality walk (K2, or K3 for variable lengths) -> keep mask
    -> DNA walk (K3) -> ambiguity restore -> delta untranslate. Returns,
    with key.out, every row packed by _pack_out (rows past the live count
    are 0, so the live rows' words are a prefix of each part; the
    ambiguity left to the host in qual8 mode), else the (2, rows, L)
    uint8 seq/qual planes. wires: the LensWires the key was made with."""
    (hdr, q_lanes, d_lanes, dna_tabs, q_lens, q_rows, d_lens, d_rows, lens16,
     index_tab, words) = pieces
    G, L, bits = key.G, key.L, key.bits
    if key.Lt is None:
        lens = lens16.int() & 0xFFFF
    else:
        r = torch.arange(key.rows, device=words.device)
        lens = torch.where(r < hdr[0], key.Lt, 0).to(torch.int32)
    dna_tabs = dna.device_tables(dna_tabs)
    q_wire, d_wire = wires
    q_walk, d_walk = tables.walk_luts_both(
        (q_wire, q_lens, q_rows), (d_wire, d_lens, d_rows) if d_wire else None)
    q_plane = bitpack.dense_words(words, q_lanes, key.q_wmax, key.sp)
    if key.Lt is None:
        qual_t = quality.decode_walk_masked(
            q_plane, lens, q_walk, L, G, bits, legacy=key.legacy,
            span_len=hdr[1] if _laddered(key) else None)
    else:
        qual_t = quality.decode_walk(
            q_plane, lens, q_walk, L, key.Lt, G, bits, legacy=key.legacy)
    keep = (qual_t < 128) & quality.valid_mask(lens, L)
    d_plane = bitpack.dense_words(words, d_lanes, key.d_wmax, key.sp)
    if d_wire:
        dna_syms = dna.decode_huffman_walk(d_plane, keep, d_walk, G, bits)
    else:
        dna_syms = dna.decode_plain_walk(d_plane, keep, G, dna_tabs["acgt"])
    if key.out is not None and key.out.qual8:
        return _pack_out(dna_syms, qual_t, index_tab, key.out)
    seq, qual = dna.restore_ambiguity(dna_syms, qual_t, lens,
                                      dna_tabs["amb_char"])
    if key.out is not None:
        return _pack_out(seq, qual, index_tab, key.out)
    if key.is_delta:
        seq = dna.delta_untranslate(seq, lens, dna_tabs["nuc_index"])
    return torch.stack([seq, qual])


def decode_lanes(p: _DParsed, cfg: CodecConfig, device, s0: int, s1: int,
                 wires: tuple) -> torch.Tensor:
    """decode_walk_fused of lanes s0 .. s1 - 1 (records s0*G .. s1*G - 1)
    on `device`, its inputs uploaded in one copy at their exact sizes (the
    sharded codec's call): the restored (2, (s1 - s0)*G, L) planes."""
    key, pieces, _, wires = _decode_inputs(p, cfg, s0, s1, wires, None)
    return decode_walk_fused(_upload_together(pieces, device), key, wires)


#: the walks' chain floor: one step, a table load and a shift, takes 30
#: cycles of an H100's 1.98 GHz clock (PERF.md section 6)
STEP_S = 30 / 1.98e9


def walk_counts(p: _DParsed) -> dict:
    """The two walk launches of a decoded sub-block, from its lengths and
    its substream table: for the quality walk (K2, or K3 with a tree a
    position) and the DNA walk (K3), the lanes, their steps summed and the
    longest lane's. A quality step decodes one symbol; a DNA step one
    symbol (Huffman; an upper bound where bases moved into quality) or,
    plain 2-bit, the kept symbols of one 16-slot group of the lane's slots
    (record r's at r * W, csrc/walk.cu) that holds any."""
    S, G = p.q_sub.shape[0], p.G
    lens = np.zeros(S * G, np.int64)
    lens[:p.R] = p.lens_np
    q = lens.reshape(S, G).sum(axis=1)
    d = q
    if p.d_plan.mode == dna.MODE_PLAIN:
        first = np.arange(S * G, dtype=np.int64) * p.W // 16
        last = (np.arange(S * G, dtype=np.int64) * p.W + lens - 1) // 16
        groups = np.where(lens > 0, last - first + 1, 0)
        # a group that the lane's previous record ends in counts once
        groups[1:] -= ((lens[1:] > 0) & (lens[:-1] > 0)
                       & (first[1:] == last[:-1])
                       & (np.arange(1, S * G) % G != 0))
        d = groups.reshape(S, G).sum(axis=1)
    out = {}
    for k, v in (("q", q), ("d", d)):
        out[f"walk.{k}.lanes"] = S
        out[f"walk.{k}.steps"] = int(v.sum())
        out[f"walk.{k}.longest"] = int(v.max(initial=0))
    return out


def _decode_device(p: _DParsed, cfg: CodecConfig, device, codec=None,
                   buckets=None) -> tuple:
    """(fetches, out_meta) of the sub-block, each fetch a device.Pending.
    One device: the packed live rows (out_meta = _out_meta(p)), or the
    restored (2, Rp, W) planes where out_meta is None, by decode_walk_fused
    on a leased static input (graphs.lease), released once the fetch is
    queued; p.W set (plane_length), and the walks' counts added to the
    span d.launch (walk_counts). With a codec
    (parallel.mesh.ShardedSubblockCodec): each shard's contiguous range of
    whole lanes on its own device, restored planes in row order."""
    if not p.R:
        return [fetch_async(torch.zeros((2, 0, p.L), dtype=torch.uint8,
                                        device=device))], None
    with span("d.wires"):
        # both tables are checked before anything is uploaded
        for sub in (p.q_sub, p.d_sub):
            bitpack.plane_geometry(sub, p.G, p.L, cfg.max_code_len)
        if codec is None:
            p.W = plane_length(p.L, p.variable)
        wires = decode_wires(p, cfg)
    if codec is not None:
        with span("d.launch"):
            return [fetch_async(b)
                    for b in codec.decode_walk(p, cfg, wires)], None
    with span("d.inputs"):
        meta = _out_meta(p)
        key, pieces, cap, wires = _decode_inputs(p, cfg, 0, p.q_sub.shape[0],
                                                 wires, meta, buckets)
    with span("d.launch"):
        if counting():
            count(**walk_counts(p))
        specs = ([(a.shape, a.dtype) for a in pieces[:-1]]
                 + [((cap,), np.int32)])
        ls = graphs.lease(device, "decode_walk_fused", key,
                          layout_bytes(specs), shared=_laddered(key))
        try:
            _upload_together(pieces, device, into=ls.inputs)
            args = views(ls.inputs, specs)
            out = ls.run(lambda: decode_walk_fused(args, key, wires))
            if meta is None:
                pending = fetch_async(out)
            else:  # the live rows' prefix of each part
                n_sw, _ = _out_fetch_words(key.rows * p.W, meta.w, meta.q6)
                s_live, q_live = _out_fetch_words(p.R * p.W, meta.w, meta.q6)
                pending = fetch_async(out[:s_live], out[n_sw:n_sw + q_live])
            del out  # none of the instance's outputs held past the lease
        except BaseException:
            ls.release(ok=False)
            raise
        ls.release()
    return [pending], meta


def decode_stage_a(data: bytes, cfg: CodecConfig, device,
                   executor=None, codec=None, streams=None,
                   buckets=None) -> _DStage:
    """Parse on the host, then dispatch the decode on the task's streams
    (device.task_streams; None: the current streams) and start the fetch
    of its output as soon as it is queued (phyngsc_tpu's _host_async).
    buckets: the driver's BucketCtx (phyngsc_tpu's decompress.py keeps
    one a run), picked here on the driver's thread in task order."""
    with timed_span("d.parse"):
        p = _decode_parse(data, cfg, executor)
    with timed_span("d.device_dispatch"):
        st = _DStage()
        st.R, st.lens_np, st.crc = p.R, p.lens_np, p.crc
        st.titles_np, st.tlens_np = p.titles_np, p.tlens_np
        with use_streams(streams):
            st.blobs, st.out_meta = _decode_device(p, cfg, device, codec,
                                                   buckets)
        st.L = p.W
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
    with timed_span("d.fetch", wait=True):
        # the decode fetch, one a shard
        parts = [_fetch(b) for b in st.blobs]
    with timed_span("d.reassemble"):
        with span("d.unpack"):
            if st.out_meta is not None:
                seq, qual = _unpack_out(parts[0].view(np.uint32),
                                        st.out_meta, st.R, st.L)
            else:
                both = (parts[0] if len(parts) == 1
                        else np.concatenate(parts, axis=1))
                seq, qual = both[0, : st.R], both[1, : st.R]
        if st.tlens_np is None:        # title decode ran on a worker thread
            with span("d.title_wait", wait=True):
                st.titles_np, st.tlens_np = st.titles_np.result()
        with span("d.fastq"):
            out = _reassemble(st.R, st.lens_np, st.titles_np, st.tlens_np,
                              seq, qual)
    if st.crc is not None:
        import zlib

        with span("d.crc"):
            ok = zlib.crc32(out) == st.crc
        if not ok:
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
                                         streams=task_streams([device]),
                                         buckets=BucketCtx()))


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

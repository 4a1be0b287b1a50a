"""Compression driver (port of phyngsc_tpu/pipeline/compress.py).

Partitions the input into writer regions, indexes records in bounded
windows, encodes sub-blocks through the port's subblock stages
(software-pipelined: host stages A and C on a thread pool, stage B and every
bucket decision on the calling thread in task order; each sub-block's
device work on the streams of the next of pipeline_depth + 1 task slots,
handed out in task order, and each fetch waiting on its own event only:
device.py), frames them into fixed-size blocks and writes the
footer. compress_file streams a memmapped input to a file; stats_out
collects a CompressStats per writer. With cfg.data_shards > 1 every
sub-block's rows split over that many devices (parallel/mesh.py
ShardedSubblockCodec); the container is the JAX package's at the same
shard count. Under PHYNGSC_TIMING the driver sums the stage split
(subblock.TIMING) and the event counts (subblock.COUNTS) and logs them in
one line, and each call records its
spans (subblock.recorded_calls): the calling thread's drv.* steps and
stage_b, the pool's stage_a, stage_c and title tasks. The host partitioning,
indexing, framing and footer are the port's copies of phyngsc_tpu's modules
(container/, parallel/, utils/); the driver functions,
CompressStats and resolve_substream are copied from
phyngsc_tpu/pipeline/compress.py (which imports jax).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import io
import os
import threading
import time
from typing import List, Optional

import numpy as np

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.container import block as blockmod
from phyngsc_tpu_torch.container import footer as footermod
from phyngsc_tpu_torch.parallel.mesh import codec_for
from phyngsc_tpu_torch.parallel.partition import (partition_regions,
                                                  split_subblocks)
from phyngsc_tpu_torch.utils.fastq import FastqFormatError, index_records
from phyngsc_tpu_torch.utils.logging import info
from phyngsc_tpu_torch.utils.shapes import BucketCtx, bucket_length
from phyngsc_tpu_torch.device import StreamRing, resolve
from phyngsc_tpu_torch.pipeline import subblock as sbmod


@dataclasses.dataclass
class CompressStats:
    """Per-writer report, the analogue of the reference's exit table
    (COMP_TIME / N_BLOCK / N_SUBBLOCKS, phyNGSC.cpp:1062-1066)."""
    writer_id: int
    seconds: float
    n_blocks: int
    n_subblocks: int
    input_bytes: int
    output_bytes: int


def iter_subblock_tasks(buf: np.ndarray, regions, cfg: CodecConfig):
    """Lazily yield (writer_pos, absolute RecordIndex slice) tasks, indexing
    each region in windows of cfg.index_window_bytes (at least one
    sub-block's worth); windows begin at record boundaries."""
    win = max(cfg.index_window_bytes, cfg.subblock_input_bytes)
    for w, reg in enumerate(regions):
        if reg.end <= reg.start:
            continue
        pos = reg.start
        while pos < reg.end:
            hi = min(pos + win, reg.end)
            idx = index_records(buf[pos:hi])
            if idx.n_records == 0:
                if hi >= reg.end:
                    break  # trailing bytes with no complete record
                raise FastqFormatError(
                    f"no complete record in a {win}-byte index window at "
                    f"offset {pos}: record larger than index_window_bytes")
            consumed = idx.end_offset  # window-relative
            for name in ("title_start", "title_end", "seq_start", "seq_end",
                         "qual_start", "qual_end"):
                setattr(idx, name, getattr(idx, name) + pos)
            rec_sizes = (idx.qual_end + 1 - idx.title_start).astype(np.int64)
            for sl in split_subblocks(rec_sizes, cfg):
                yield w, idx.slice(sl.start, sl.stop)
            pos += consumed


def compress_bytes(data: bytes, cfg: Optional[CodecConfig] = None,
                   n_writers: int = 1, device="cuda",
                   stats_out: Optional[list] = None) -> bytes:
    return compress_array(np.frombuffer(data, dtype=np.uint8), cfg,
                          n_writers, device, stats_out)


@sbmod.recorded("compress")
def compress_array(buf: np.ndarray, cfg: Optional[CodecConfig] = None,
                   n_writers: int = 1, device="cuda",
                   stats_out: Optional[list] = None) -> bytes:
    sink = io.BytesIO()
    compress_to_file(buf, sink, cfg, n_writers, device, stats_out)
    with sbmod.span("drv.output"):
        result = sink.getvalue()
        del sink  # freed inside the span, not as the frame ends
    return result


@sbmod.recorded("compress")
def encode_subblocks_pipelined(buf: np.ndarray, regions, cfg: CodecConfig,
                               sink, device,
                               writer_seconds: Optional[list] = None,
                               codec=None) -> int:
    """Software-pipelined A/B/C encode over every sub-block of `regions`;
    calls sink(region_pos, payload) on the calling thread in task order and
    adds each stage's seconds to writer_seconds[region_pos]. codec:
    optional parallel.mesh.ShardedSubblockCodec (then `device` is unused).
    Returns the task count."""
    span = sbmod.span
    with span("drv.setup"):
        device = resolve(device) if codec is None else None
        buckets = BucketCtx()  # history-dependent: picked in task order only
        G = cfg.records_per_substream
        n_shards = codec.n_data if codec is not None else 1
        if writer_seconds is None:
            writer_seconds = [0.0] * len(regions)
        t_lock = threading.Lock()
        timing = {} if os.environ.get("PHYNGSC_TIMING") else None
        sbmod.TIMING = timing
        sbmod.COUNTS = counts = {} if timing is not None else None
        t_start = time.perf_counter()
        depth = max(cfg.pipeline_depth, 1)
        # each sub-block's task streams, handed out in task order
        ring = StreamRing(codec.devices if codec is not None else [device],
                          depth + 1)
        workers = cfg.host_workers or (os.cpu_count() or 2)
        executor = cf.ThreadPoolExecutor(max_workers=max(2, workers))
        tasks = iter_subblock_tasks(buf, regions, cfg)

    def _timed(label, w, i, fn, *args):
        t0 = time.perf_counter()
        with sbmod.timed_span(label, sub=i):
            r = fn(*args)
        dt = time.perf_counter() - t0
        with t_lock:
            writer_seconds[w] += dt
        return r

    a_q: List = []  # [(writer_pos, task index, Future[_StageA])]
    b_q: List = []  # [(writer_pos, task index, Future[bytes])]
    n_tasks = 0
    with executor:

        def _advance_b():
            w, i, fa = a_q.pop(0)
            with span("drv.wait_a", wait=True, sub=i):
                a = fa.result()
            # stage B, then its seconds added to the sinks, whose locks
            # the pool's tasks take too: a wait for them is the loop's
            with span("drv.stage_b", sub=i):
                b = _timed("stage_b", w, i, sbmod.stage_b, a, cfg, codec,
                           buckets)
            with span("drv.submit", sub=i):
                b_q.append((w, i, executor.submit(
                    sbmod.task(_timed), "stage_c", w, i, sbmod.stage_c, b,
                    cfg)))

        def _advance_c():
            w, i, fc = b_q.pop(0)
            with span("drv.wait_c", wait=True, sub=i):
                payload = fc.result()
            with span("drv.sink", sub=i):
                sink(w, payload)

        while True:
            with span("drv.index"):
                nxt = next(tasks, None)
            if nxt is None:
                break
            w, idx_slice = nxt
            i, n_tasks = n_tasks, n_tasks + 1
            with span("drv.submit", sub=i):
                rp = buckets.pick(idx_slice.n_records, G, n_shards)
                a_q.append((w, i, executor.submit(
                    sbmod.task(_timed), "stage_a", w, i, sbmod.stage_a, buf,
                    idx_slice, cfg, device, executor, rp, codec,
                    ring.take())))
            if len(a_q) >= depth:
                _advance_b()
            if len(b_q) >= depth:
                _advance_c()
        while a_q:
            _advance_b()
        while b_q:
            _advance_c()
        with span("drv.close"):
            executor.shutdown()
            if timing is not None:
                info("pipeline timing: %s total=%.2fs tasks=%d %s",
                     sbmod.timing_line(timing),
                     time.perf_counter() - t_start, n_tasks,
                     " ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return n_tasks


def resolve_substream(buf: np.ndarray, cfg: CodecConfig) -> CodecConfig:
    """Apply CodecConfig.auto_substream: peek the first record's read length
    and shrink records_per_substream for long reads (bucketed L > 256), so a
    walk takes about 8192 steps. The resolved value lands in the footer, so
    decompression follows it."""
    if not cfg.auto_substream or buf.shape[0] == 0:
        return cfg
    b = buf[: 1 << 16].tobytes()
    t_end = b.find(b"\n")
    s_end = b.find(b"\n", t_end + 1) if t_end >= 0 else -1
    if t_end < 0 or s_end < 0:
        return cfg
    L0 = bucket_length(s_end - t_end - 1)
    if L0 <= 256:
        return cfg
    g = 8
    while g * 2 * L0 <= 8192:
        g *= 2
    g = min(cfg.records_per_substream, max(8, g))
    if g == cfg.records_per_substream:
        return cfg
    return dataclasses.replace(cfg, records_per_substream=g)


@sbmod.recorded("compress")
def compress_to_file(buf: np.ndarray, out, cfg: Optional[CodecConfig] = None,
                     n_writers: int = 1, device="cuda",
                     stats_out: Optional[list] = None) -> None:
    """Streaming driver: writes each fixed-size block to `out` (any
    .write()-able) the moment it fills, then the footer. Memory stays
    O(pipeline_depth sub-blocks + one partial block) whatever the input
    size; `buf` may be an np.memmap. stats_out, a list, receives one
    CompressStats per writer. device: one device, or with cfg.data_shards
    > 1 the shards' devices (parallel/mesh.py shard_devices)."""
    with sbmod.span("drv.setup"):
        cfg = resolve_substream(buf, cfg or CodecConfig())
        device, codec = codec_for(device, cfg)
        regions = partition_regions(buf, n_writers, cfg)
        assemblers = [blockmod.BlockAssembler(reg.writer_id, cfg.block_size)
                      for reg in regions]
    finished = [False] * len(regions)
    cbo: List[int] = []
    last_block_sizes = [0] * len(regions)
    n_subblocks = [0] * len(regions)
    out_bytes = [0] * len(regions)

    def _write_block(b: blockmod.Block) -> None:
        cbo.append(b.writer_id)
        last_block_sizes[b.writer_id] = len(b.payload)
        out_bytes[b.writer_id] += len(b.payload)
        out.write(b.payload)

    def _finish_writer(w: int) -> None:
        if not finished[w]:
            finished[w] = True
            for b in assemblers[w].finish():
                _write_block(b)

    def _sink(w: int, payload: bytes) -> None:
        # a payload for writer w means earlier writers are done — emit
        # their final partial blocks first, keeping writer-major order
        for v in range(w):
            _finish_writer(v)
        n_subblocks[w] += 1
        for b in assemblers[w].add(payload):
            _write_block(b)

    writer_seconds = [0.0] * len(regions)
    encode_subblocks_pipelined(buf, regions, cfg, _sink, device,
                               writer_seconds, codec)
    with sbmod.span("drv.finish"):
        for w in range(len(regions)):
            _finish_writer(w)

        if stats_out is not None:
            for w, reg in enumerate(regions):
                stats_out.append(CompressStats(
                    writer_id=reg.writer_id,
                    seconds=writer_seconds[w],
                    n_blocks=assemblers[w].n_blocks,
                    n_subblocks=n_subblocks[w],
                    input_bytes=reg.end - reg.start,
                    output_bytes=out_bytes[w],
                ))

        foot = footermod.Footer(
            fastq_size=int(buf.shape[0]),
            block_size=cfg.block_size,
            n_writers=n_writers,
            overlaps=[r.overlap_used for r in regions],
            writer_block_counts=[a.n_blocks for a in assemblers],
            last_block_sizes=last_block_sizes,
            cbo=cbo,
            records_per_substream=cfg.records_per_substream,
            max_code_len=cfg.max_code_len,
        )
        out.write(footermod.write_footer(foot))


@sbmod.recorded("compress")
def compress_file(in_path: str, out_path: str,
                  cfg: Optional[CodecConfig] = None, n_writers: int = 1,
                  stats_out: Optional[list] = None, device="cuda") -> None:
    """Bounded-memory file-to-file compression: memmapped input, blocks
    written as they fill, so host memory is flat in the input size."""
    buf = (np.memmap(in_path, dtype=np.uint8, mode="r")
           if os.path.getsize(in_path) else np.zeros(0, np.uint8))
    with open(out_path, "wb") as f:
        compress_to_file(buf, f, cfg, n_writers, device, stats_out)

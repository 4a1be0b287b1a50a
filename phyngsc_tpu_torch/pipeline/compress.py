"""Compression driver (port of phyngsc_tpu/pipeline/compress.py).

Partitions the input into writer regions, indexes records in bounded
windows, encodes sub-blocks through the port's subblock stages
(software-pipelined: host stages A and C on a thread pool, stage B and every
bucket decision on the calling thread in task order, all device work on
PyTorch's current stream), frames them into fixed-size blocks and writes the
footer. The host partitioning, indexing, framing and footer are
phyngsc_tpu's own modules; the driver functions and resolve_substream are
copied from phyngsc_tpu/pipeline/compress.py (which imports jax). Sharded
encode (data_shards > 1) is a later slice.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import io
import os
from typing import List, Optional

import numpy as np

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.container import block as blockmod
from phyngsc_tpu.container import footer as footermod
from phyngsc_tpu.parallel.partition import partition_regions, split_subblocks
from phyngsc_tpu.utils.fastq import FastqFormatError, index_records
from phyngsc_tpu.utils.shapes import BucketCtx, bucket_length
from phyngsc_tpu_torch import host_runtime
from phyngsc_tpu_torch.device import resolve
from phyngsc_tpu_torch.pipeline import subblock as sbmod


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
                   n_writers: int = 1, device="cuda") -> bytes:
    return compress_array(np.frombuffer(data, dtype=np.uint8), cfg,
                          n_writers, device)


def compress_array(buf: np.ndarray, cfg: Optional[CodecConfig] = None,
                   n_writers: int = 1, device="cuda") -> bytes:
    sink = io.BytesIO()
    compress_to_file(buf, sink, cfg, n_writers, device)
    return sink.getvalue()


def encode_subblocks_pipelined(buf: np.ndarray, regions, cfg: CodecConfig,
                               sink, device) -> int:
    """Software-pipelined A/B/C encode over every sub-block of `regions`;
    calls sink(region_pos, payload) on the calling thread in task order.
    Returns the task count."""
    device = resolve(device)
    buckets = BucketCtx()  # history-dependent: picked in task order only
    G = cfg.records_per_substream
    a_q: List = []  # [(writer_pos, Future[_StageA])]
    b_q: List = []  # [(writer_pos, Future[bytes])]
    n_tasks = 0
    workers = cfg.host_workers or (os.cpu_count() or 2)
    with cf.ThreadPoolExecutor(max_workers=max(2, workers)) as executor:

        def _advance_b():
            w, fa = a_q.pop(0)
            b = sbmod.stage_b(fa.result(), cfg)
            b_q.append((w, executor.submit(sbmod.stage_c, b, cfg)))

        def _advance_c():
            w, fc = b_q.pop(0)
            sink(w, fc.result())

        depth = max(cfg.pipeline_depth, 1)
        for w, idx_slice in iter_subblock_tasks(buf, regions, cfg):
            n_tasks += 1
            rp = buckets.pick(idx_slice.n_records, G)
            a_q.append((w, executor.submit(
                sbmod.stage_a, buf, idx_slice, cfg, device, executor, rp)))
            if len(a_q) >= depth:
                _advance_b()
            if len(b_q) >= depth:
                _advance_c()
        while a_q:
            _advance_b()
        while b_q:
            _advance_c()
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


def compress_to_file(buf: np.ndarray, out, cfg: Optional[CodecConfig] = None,
                     n_writers: int = 1, device="cuda") -> None:
    """Streaming driver: writes each fixed-size block to `out` (any
    .write()-able) the moment it fills, then the footer."""
    cfg = resolve_substream(buf, cfg or CodecConfig())
    if cfg.data_shards > 1:
        raise sbmod._not_in_slice("sharded encode (data_shards > 1)")
    host_runtime.ensure()
    regions = partition_regions(buf, n_writers, cfg)
    assemblers = [blockmod.BlockAssembler(reg.writer_id, cfg.block_size)
                  for reg in regions]
    finished = [False] * len(regions)
    cbo: List[int] = []
    last_block_sizes = [0] * len(regions)

    def _write_block(b: blockmod.Block) -> None:
        cbo.append(b.writer_id)
        last_block_sizes[b.writer_id] = len(b.payload)
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
        for b in assemblers[w].add(payload):
            _write_block(b)

    encode_subblocks_pipelined(buf, regions, cfg, _sink, device)
    for w in range(len(regions)):
        _finish_writer(w)

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

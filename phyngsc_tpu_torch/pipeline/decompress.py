"""Decompression driver (port of phyngsc_tpu/pipeline/decompress.py).

Reads the footer, walks blocks in file order, stitches split sub-blocks,
decodes each sub-block through the port's subblock stages (device dispatch
on the calling thread, fetch + FASTQ reassembly on a thread pool, chunks
completed in order) and places each chunk at its writer's output offset.
The driver functions are copied from phyngsc_tpu/pipeline/decompress.py
(which imports jax); the multi-process writer filter and sharded decode are
later slices.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from typing import Optional

import numpy as np

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.container import block as blockmod
from phyngsc_tpu.container import footer as footermod
from phyngsc_tpu_torch import host_runtime
from phyngsc_tpu_torch.device import resolve
from phyngsc_tpu_torch.pipeline import subblock as sbmod


def writer_output_starts(foot: footermod.Footer) -> list:
    """Absolute FASTQ offset of each writer's first record, reconstructed
    from the footer exactly as partition_regions computed it."""
    starts = []
    for w in range(foot.n_writers):
        a = foot.fastq_size * w // foot.n_writers + foot.overlaps[w]
        starts.append(max(a, starts[-1]) if starts else a)
    return starts


def _read_footer_any(data) -> footermod.Footer:
    if isinstance(data, np.ndarray):
        tail = footermod.footer_region_size(data.shape[0])
        return footermod.read_footer(bytes(data[-tail:]))
    return footermod.read_footer(data)


def _decode_stream(data, foot: footermod.Footer, cfg: Optional[CodecConfig],
                   write_at, device) -> None:
    """Calls write_at(offset, chunk) for every decoded sub-block, holding at
    most pipeline_depth sub-blocks in flight."""
    device = resolve(device)
    cfg = cfg or CodecConfig()
    if cfg.data_shards > 1:
        raise sbmod._not_in_slice("sharded decode (data_shards > 1)")
    host_runtime.ensure()
    legacy_trees = foot.version <= 3
    if (foot.records_per_substream != cfg.records_per_substream
            or foot.max_code_len != cfg.max_code_len
            or cfg.legacy_tail_trees != legacy_trees):
        # container geometry + version compat win over the caller's config
        cfg = dataclasses.replace(
            cfg,
            records_per_substream=foot.records_per_substream,
            max_code_len=foot.max_code_len,
            legacy_tail_trees=legacy_trees,
        )
    sizes = foot.block_sizes_in_file_order()
    starts = writer_output_starts(foot)
    cursor = list(starts)  # next output offset per writer

    def blocks():
        off = 0
        for size, wid in zip(sizes, foot.cbo):
            yield wid, bytes(data[off : off + size])  # one block at a time
            off += size

    written = 0
    pending = []  # [(wid, Future[bytes])]

    def _drain_one():
        nonlocal written
        w, fut = pending.pop(0)
        chunk = fut.result()
        write_at(cursor[w], chunk)
        cursor[w] += len(chunk)
        written += len(chunk)
        lim = starts[w + 1] if w + 1 < len(starts) else foot.fastq_size
        if cursor[w] > lim:
            raise ValueError(
                f"writer {w} decoded past its region ({cursor[w]} > {lim}): "
                "corrupt container")

    workers = cfg.host_workers or (os.cpu_count() or 2)
    with cf.ThreadPoolExecutor(max_workers=max(2, workers)) as executor:
        for wid, payload in blockmod.iter_subblocks(blocks()):
            st = sbmod.decode_stage_a(payload, cfg, device, executor)
            pending.append((wid, executor.submit(sbmod.decode_stage_b, st)))
            if len(pending) >= max(cfg.pipeline_depth, 1):
                _drain_one()
        while pending:
            _drain_one()

    if written != foot.fastq_size:
        raise ValueError(
            f"decompressed size {written} != footer fastq_size "
            f"{foot.fastq_size}")


def decompress_bytes(data, cfg: Optional[CodecConfig] = None,
                     device="cuda") -> bytes:
    """`data` is bytes or any buffer. Chunks are assembled only after the
    decoded total matched the footer's fastq_size, and must tile the output
    exactly."""
    foot = _read_footer_any(data)
    chunks = []

    def write_at(off: int, chunk: bytes) -> None:
        chunks.append((off, chunk))

    _decode_stream(data, foot, cfg, write_at, device)
    pos = 0
    for off, chunk in sorted(chunks, key=lambda c: c[0]):
        if off != pos:
            raise ValueError(
                f"corrupt container: decoded chunks do not tile the output "
                f"(gap/overlap at {pos} vs {off})")
        pos += len(chunk)
    out = bytearray(foot.fastq_size)
    for off, chunk in chunks:
        out[off : off + len(chunk)] = chunk
    return bytes(out)

"""Decompression driver (port of phyngsc_tpu/pipeline/decompress.py).

Reads the footer, walks blocks in file order, stitches split sub-blocks,
decodes each sub-block through the port's subblock stages (device dispatch
on the calling thread, fetch + FASTQ reassembly on a thread pool, chunks
completed in order) and places each chunk at its writer's output offset.
decompress_file memmaps the container and pwrites each chunk at its
absolute offset; writer_filter decodes only the chosen writers' blocks (the
multi-process driver's share). With cfg.data_shards > 1 each sub-block's
lanes split over that many devices (parallel/mesh.py). Under PHYNGSC_TIMING
the stage split (subblock.TIMING) is logged in one line. The driver
functions are copied from phyngsc_tpu/pipeline/decompress.py (which imports
jax).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from typing import Optional

import numpy as np

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.container import block as blockmod
from phyngsc_tpu_torch.container import footer as footermod
from phyngsc_tpu_torch.parallel.mesh import codec_for
from phyngsc_tpu_torch.pipeline import subblock as sbmod
from phyngsc_tpu_torch.utils.logging import info


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
                   write_at, device, writer_filter=None) -> None:
    """Calls write_at(offset, chunk) for every decoded sub-block, holding at
    most pipeline_depth sub-blocks in flight. writer_filter: optional set of
    writer ids whose blocks alone are decoded (a writer's sub-blocks never
    split across another writer's blocks, so the filtered stream stitches
    the same way). device: one device, or with cfg.data_shards > 1 the
    shards' devices (parallel/mesh.py shard_devices)."""
    cfg = cfg or CodecConfig()
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
    device, codec = codec_for(device, cfg)
    sizes = foot.block_sizes_in_file_order()
    starts = writer_output_starts(foot)
    timing = sbmod.TIMING = {} if os.environ.get("PHYNGSC_TIMING") else None
    t_start = time.perf_counter()
    n_tasks = 0
    cursor = list(starts)  # next output offset per writer

    def blocks():
        off = 0
        for size, wid in zip(sizes, foot.cbo):
            if writer_filter is None or wid in writer_filter:
                yield wid, bytes(data[off : off + size])  # one at a time
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
            n_tasks += 1
            st = sbmod.decode_stage_a(payload, cfg, device, executor, codec)
            pending.append((wid, executor.submit(sbmod.decode_stage_b, st)))
            if len(pending) >= max(cfg.pipeline_depth, 1):
                _drain_one()
        while pending:
            _drain_one()

    if writer_filter is None:
        expect = foot.fastq_size
    else:
        expect = sum(
            (starts[w + 1] if w + 1 < len(starts) else foot.fastq_size)
            - starts[w] for w in writer_filter)
    if written != expect:
        raise ValueError(
            f"decompressed size {written} != expected {expect} "
            f"(footer fastq_size {foot.fastq_size})")
    if timing is not None:
        info("decode timing: %s total=%.2fs tasks=%d",
             sbmod.timing_line(timing), time.perf_counter() - t_start,
             n_tasks)


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


def decompress_file(in_path: str, out_path: str,
                    cfg: Optional[CodecConfig] = None, device="cuda") -> None:
    """Bounded-memory file-to-file decompression: the container is
    memmapped and each decoded chunk is pwritten at its absolute offset, so
    host memory is flat in the file size. The file is sized only after the
    decoded total matched the footer (a corrupt footer cannot make a huge
    sparse file)."""
    data = np.memmap(in_path, dtype=np.uint8, mode="r")
    foot = _read_footer_any(data)
    fd = os.open(out_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        _decode_stream(data, foot, cfg,
                       lambda off, chunk: os.pwrite(fd, chunk, off), device)
        os.ftruncate(fd, foot.fastq_size)
    finally:
        os.close(fd)

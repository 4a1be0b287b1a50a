"""Multi-process compression driver (port of phyngsc_tpu/parallel/distributed.py).

The reference's scale-out is MPI ranks over a shared file: `File_read_at`
sharded reads, `File_write_shared` unordered appends, timestamp footer
ordering (C13/C14). Here each process owns a working region
(parallel/partition.py), compresses it on its own device, then:

1. every process all-gathers the per-process total block bytes (the Gather
   of phyNGSC.cpp:964),
2. an exclusive prefix sum gives each process a deterministic byte offset,
3. each process `pwrite`s its own blocks at its offset (no shared file
   pointer, no timestamps, no ordering pass),
4. process 0 writes the footer from the gathered block counts.

Only host metadata crosses processes (four int64 a process, and barriers),
so the process group is gloo on the CPU and on cards alike; no device data
moves between processes, and any number of processes may share one card.
Run one process per rank:

    python -m phyngsc_tpu_torch.parallel.distributed \\
        --coordinator HOST:PORT --num-processes N --process-id I \\
        [--device cuda|cpu] [--decompress] in.fastq out.ngsct

A process's device is cuda:{rank % device_count} for --device cuda. N local
processes on the CPU stand in for several hosts
(tests/test_torch_distributed.py).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.container import block as blockmod
from phyngsc_tpu_torch.container import footer as footermod
from phyngsc_tpu_torch.device import resolve
from phyngsc_tpu_torch.parallel.offsets import process_allgather, rank_and_size
from phyngsc_tpu_torch.parallel.partition import partition_regions
from phyngsc_tpu_torch.utils import native
from phyngsc_tpu_torch.utils.logging import info


def process_device(device, rank: int) -> torch.device:
    """The device of process `rank`: a CUDA device without an index means
    card rank % device_count; any other device is taken as given."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def compress_file_distributed(in_path: str, out_path: str,
                              cfg: Optional[CodecConfig] = None,
                              device="cuda", group=None) -> None:
    """Collective: every process of `group` (default: the world) calls this
    with the same arguments, after torch.distributed.init_process_group
    (gloo); raises without one. The container equals the single-process
    one with as many writers as processes."""
    import torch.distributed as dist

    from phyngsc_tpu_torch.pipeline.compress import (
        encode_subblocks_pipelined, resolve_substream)

    cfg = cfg or CodecConfig()
    pid, n_proc = rank_and_size(group)
    device = process_device(device, pid)

    # memory-map instead of reading: each process pages in only its own
    # working region (± the boundary-alignment windows partition_regions
    # scans) — the File_read_at sharding of phyNGSC.cpp:249 via the page
    # cache
    size = os.path.getsize(in_path)
    buf = np.memmap(in_path, np.uint8, "r") if size else np.zeros(0, np.uint8)
    # deterministic across processes: every rank peeks the same first record
    cfg = resolve_substream(buf, cfg)
    regions = partition_regions(buf, n_proc, cfg)
    reg = regions[pid]

    # blocks spool to a local file as they fill (bounded memory: the final
    # offset is known only once every process's total is gathered)
    spool_path = f"{out_path}.w{pid}.spool"
    n_blocks = 0
    last_block_size = 0
    my_bytes = 0
    t0 = time.perf_counter()
    with open(spool_path, "wb") as spool:
        asm = blockmod.BlockAssembler(pid, cfg.block_size)

        def _emit(b: blockmod.Block) -> None:
            nonlocal n_blocks, last_block_size, my_bytes
            n_blocks += 1
            last_block_size = len(b.payload)
            my_bytes += len(b.payload)
            spool.write(b.payload)

        def _sink(_w: int, payload: bytes) -> None:
            for b in asm.add(payload):
                _emit(b)

        # the single-process pipelined driver, restricted to this region
        encode_subblocks_pipelined(buf, [reg], cfg, _sink, device)
        for b in asm.finish():
            _emit(b)
    enc_s = time.perf_counter() - t0
    info("process %d: encoded %.2f MB in %.2fs (%.1f MB/s) on %s",
         pid, (reg.end - reg.start) / 1e6, enc_s,
         (reg.end - reg.start) / max(enc_s, 1e-9) / 1e6, device)

    # --- the offset protocol (replaces C13's timestamps) -------------------
    sizes = process_allgather([my_bytes, n_blocks, last_block_size,
                               reg.overlap_used], group)
    my_offset = int(np.sum(sizes[:pid, 0]))
    total_blocks_bytes = int(np.sum(sizes[:, 0]))

    if pid == 0:
        # create + size the file, then let everyone pwrite
        cbo = [w for w in range(n_proc) for _ in range(int(sizes[w, 1]))]
        foot = footermod.Footer(
            fastq_size=size, block_size=cfg.block_size,
            n_writers=n_proc,
            overlaps=[int(x) for x in sizes[:, 3]],
            writer_block_counts=[int(x) for x in sizes[:, 1]],
            last_block_sizes=[int(x) for x in sizes[:, 2]],
            cbo=cbo,
            records_per_substream=cfg.records_per_substream,
            max_code_len=cfg.max_code_len,
        )
        with open(out_path, "wb") as f:
            f.truncate(total_blocks_bytes)
            f.seek(total_blocks_bytes)
            f.write(footermod.write_footer(foot))
    dist.barrier(group)  # the file exists

    # copy the spool into place at the agreed offset (chunked: O(1) RAM)
    fd = os.open(out_path, os.O_WRONLY)
    try:
        pos = my_offset
        with open(spool_path, "rb") as spool:
            while True:
                chunk = spool.read(8 << 20)
                if not chunk:
                    break
                os.pwrite(fd, chunk, pos)
                pos += len(chunk)
    finally:
        os.close(fd)
    os.unlink(spool_path)
    dist.barrier(group)  # every block is written
    info("process %d/%d wrote %d blocks (%d bytes) at offset %d; host "
         "runtime %s", pid, n_proc, n_blocks, my_bytes, my_offset,
         native.loaded_path())


def decompress_file_distributed(in_path: str, out_path: str,
                                cfg: Optional[CodecConfig] = None,
                                device="cuda", group=None) -> None:
    """Collective: the mirror of compress_file_distributed. Writers are
    assigned round-robin to processes; each process decodes only its
    writers' block ranges (footer CBO + per-writer sizes) and pwrites every
    chunk at its absolute output offset."""
    import torch.distributed as dist

    from phyngsc_tpu_torch.pipeline.decompress import (_decode_stream,
                                                       _read_footer_any)

    pid, n_proc = rank_and_size(group)
    device = process_device(device, pid)
    data = np.memmap(in_path, dtype=np.uint8, mode="r")
    foot = _read_footer_any(data)
    mine = set(range(pid, foot.n_writers, n_proc))

    if pid == 0:
        with open(out_path, "wb"):
            pass  # create/truncate; pwrites below extend it
    dist.barrier(group)

    t0 = time.perf_counter()
    fd = os.open(out_path, os.O_WRONLY)
    try:
        if mine:
            _decode_stream(data, foot, cfg,
                           lambda off, chunk: os.pwrite(fd, chunk, off),
                           device, writer_filter=mine)
        if pid == 0:
            os.ftruncate(fd, foot.fastq_size)
    finally:
        os.close(fd)
    dec_s = time.perf_counter() - t0
    dist.barrier(group)
    info("process %d/%d decoded writers %s in %.2fs on %s; host runtime %s",
         pid, n_proc, sorted(mine), dec_s, device, native.loaded_path())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m phyngsc_tpu_torch.parallel.distributed",
        description="one process of a multi-process compress / decompress")
    ap.add_argument("--coordinator", required=True,
                    help="HOST:PORT of process 0's rendezvous")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--decompress", action="store_true",
                    help="decode input (.ngsct) to output (.fastq) instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda (card rank %% device_count; the default) or "
                         "cpu")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id)
    try:
        if args.decompress:
            decompress_file_distributed(args.input, args.output,
                                        device=args.device)
        else:
            compress_file_distributed(args.input, args.output,
                                      device=args.device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

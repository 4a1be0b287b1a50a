# Copied from phyngsc_tpu/config.py; imports point at phyngsc_tpu_torch.
"""Codec configuration.

The reference hard-codes its geometry as compile-time constants (defs.h:20-21
8 MiB buffers, phyNGSC.cpp:48 overlap=500, :51 records_per_th=100000,
structures.h:25-26 Huffman caps 512/256, tasks.cpp:25-26 stat caps). Here they
are a dataclass because block/batch geometry is the main TPU tuning knob
(SURVEY §5 config note).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    # --- container geometry -------------------------------------------------
    #: Fixed output block size in bytes, header included (reference: 8 MiB,
    #: defs.h:21). Sub-blocks crossing the boundary are split (phyNGSC.cpp:852).
    block_size: int = 8 << 20
    #: Target uncompressed bytes per sub-block (reference reads 8 MiB chunks,
    #: defs.h:20). Each sub-block is one device batch.
    subblock_input_bytes: int = 8 << 20
    #: Max records per sub-block (reference: ~100k/rank-buffer, phyNGSC.cpp:51).
    max_records_per_subblock: int = 1 << 17
    #: Overlap window when aligning working regions to record starts
    #: (reference: fixed 500 B, phyNGSC.cpp:48 — here configurable; it caps
    #: the max record size at region boundaries).
    region_overlap: int = 4096
    #: Record-index window: each writer region is indexed in windows of at
    #: most this many bytes (clamped up to subblock_input_bytes), so index
    #: memory is O(window) — not O(region) — and a 100 GB input streams
    #: (the reference's 8 MiB read loop, phyNGSC.cpp:249, made tunable).
    index_window_bytes: int = 64 << 20

    # --- entropy coding -----------------------------------------------------
    #: Maximum Huffman code length. Length-limited codes make device encode a
    #: pure table lookup and decode a single 2^max_code_len LUT (the
    #: reference's unbounded-depth trees + bit-walk, huffman.cpp:18-85, do
    #: not map to TPU). Codes group k = 32 // max_code_len per scatter
    #: element (ops/lookup.group_codes); 12 bits measured the same device
    #: throughput as 10 with ~1.6% better ratio on ERR-style data.
    max_code_len: int = 12
    #: Records per decode substream. Each substream decodes independently
    #: (vectorized across VPU lanes); its packed words start word-aligned and
    #: its word offset is stored in the stream header.
    records_per_substream: int = 64
    #: Long-read substream policy: the decode walk runs G*L sequential steps
    #: over S = R/G parallel lanes, so at 1000 bp the 36 bp-tuned G=64 means
    #: 64000 steps over few lanes (measured 55 MB/s device decode). When the
    #: first record's read length exceeds 256, the compress drivers shrink G
    #: toward ~8192 total steps (power of two, >= 8, never above the
    #: configured records_per_substream); the footer records the resolved
    #: value, so decode needs nothing. Set False to pin G exactly.
    auto_substream: bool = True
    #: Cap on per-position statistics for title char fields (reference caps at
    #: 128 positions, tasks.cpp:25).
    max_stat_positions: int = 128
    #: Store a crc32 of each sub-block's original record bytes in the meta
    #: section and verify it on decode (the reference reserved CRC hooks but
    #: compiled them out, defs.h:35-46).
    checksum: bool = True
    #: Decode-side compatibility switch, set by the decompress driver from
    #: the container footer version: v1-v3 map every quality position
    #: >= MAX_TREES to the last tree; v4+ groups adjacent positions
    #: proportionally (quality.tree_of_position). Identical for reads
    #: <= 256 bp. Never set this for encoding — writers always emit v4.
    legacy_tail_trees: bool = False

    # --- parallelism --------------------------------------------------------
    #: Name of the record (data-parallel) mesh axis.
    data_axis: str = "data"
    #: Name of the position (sequence-parallel) mesh axis.
    seq_axis: str = "seq"
    #: Number of data-parallel shards for the stream encoders (1 = single
    #: chip). Shard boundaries align with substreams, so the container format
    #: is identical for any shard count.
    data_shards: int = 1
    #: Software-pipeline depth across sub-blocks (in-flight device batches).
    #: Deep enough to hide device→host fetch latency; each in-flight
    #: sub-block holds its device buffers (~4x the raw sub-block bytes).
    pipeline_depth: int = 4
    #: Host worker threads for the host-heavy pipeline stages (record gather/
    #: title encode in stage A, section assembly in stage C). 0 = one per
    #: CPU. The reference burns P ranks × T OpenMP threads of host CPU
    #: (phyNGSC.cpp:57-59,254); here host stages of different sub-blocks run
    #: concurrently on this pool while device work stays in task order.
    host_workers: int = 0

    def __post_init__(self) -> None:
        if self.max_code_len > 12:
            raise ValueError(
                "max_code_len > 12 breaks the fused MXU lookup (ops/lookup.py "
                "CODE_BITS) — alphabets here are <= 256 so 12 bits lose "
                "nothing measurable"
            )
        if self.block_size < (1 << 16):
            raise ValueError("block_size too small for header framing")
        if self.records_per_substream < 1:
            raise ValueError("records_per_substream must be >= 1")
        if self.index_window_bytes < (1 << 16):
            raise ValueError("index_window_bytes must be >= 64 KiB")


DEFAULT_CONFIG = CodecConfig()

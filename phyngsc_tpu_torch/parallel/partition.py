# Copied from phyngsc_tpu/parallel/partition.py; imports point at phyngsc_tpu_torch.
"""Working-region partitioning.

Equivalent of the reference's region math + record alignment scan (C2,
phyNGSC.cpp:113-164): the input splits into `n_writers` byte regions of
~equal size; each non-zero region start scans forward for the first full
record start ('\\n' followed by '@'). Differences from the reference, both
deliberate: the overlap window is configurable (the fixed 500 B cap at
region boundaries is quirk #5 in SURVEY §7) and regions tile exactly — writer
w owns records starting in [a_w, a_{w+1}), so no record is compressed twice.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.utils.fastq import align_region_start


@dataclasses.dataclass
class Region:
    writer_id: int
    start: int          # aligned to a record start
    end: int            # == next region's start (exclusive)
    overlap_used: int   # bytes scanned past the nominal boundary


def partition_regions(buf: np.ndarray, n_writers: int,
                      cfg: CodecConfig) -> List[Region]:
    size = int(buf.shape[0])
    if n_writers < 1:
        raise ValueError("n_writers must be >= 1")
    nominal = [size * w // n_writers for w in range(n_writers)] + [size]
    starts = []
    for w in range(n_writers):
        a = align_region_start(buf, nominal[w], cfg.region_overlap)
        if a < 0 or a > size:
            # no record begins near this boundary (tiny file) — empty region
            a = size
        starts.append(a)
    starts.append(size)
    # enforce monotonicity (tiny files can alias boundaries)
    for w in range(1, n_writers + 1):
        starts[w] = max(starts[w], starts[w - 1])
    return [
        Region(w, starts[w], starts[w + 1], starts[w] - nominal[w])
        for w in range(n_writers)
    ]


def split_subblocks(record_sizes: np.ndarray, cfg: CodecConfig) -> List[slice]:
    """Group a region's records into sub-block record ranges bounded by
    `subblock_input_bytes` raw input and `max_records_per_subblock` records
    (the reference's 8 MiB read buffer + ~100k record cap, phyNGSC.cpp:51)."""
    n = record_sizes.shape[0]
    out: List[slice] = []
    lo = 0
    cum = np.concatenate([[0], np.cumsum(record_sizes, dtype=np.int64)])
    while lo < n:
        hi_bytes = int(
            np.searchsorted(cum, cum[lo] + cfg.subblock_input_bytes, side="right") - 1
        )
        hi = min(max(hi_bytes, lo + 1), lo + cfg.max_records_per_subblock, n)
        out.append(slice(lo, hi))
        lo = hi
    return out

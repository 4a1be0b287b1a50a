"""What decides `correct`: the window's answers against the plain
reference, once the window has closed.

The configuration's guarantee is a lossless round trip: decompress gives
back the input byte for byte, and each sub-block's crc32 holds. So every
number compared is a count of wrong bytes or failed calls, and every limit
is 0 (an exact comparison):

- calls_raised: the window's calls that raised.
- decompress_bytes_wrong: over every decompress call, the bytes that
  differ from the input it round-tripped, plus the difference in length.
- container_bytes_wrong: over every compress call, the bytes by which the
  plain reference's decode of its container (reference/ngsct.py, which
  reads the format alone and checks each crc32) differs from the input;
  a container the reference rejects counts all the input's bytes. The
  reference decodes each distinct container once, in chunks of sub-blocks
  on up to 8 worker processes; a call whose container equals an earlier
  one of the same input takes that one's reading.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.reference.ngsct import decode_containers

LIMITS = {"calls_raised": 0, "decompress_bytes_wrong": 0,
          "container_bytes_wrong": 0}


def bytes_wrong(got, want: bytes) -> int:
    """The bytes of `got` that differ from `want`, plus the length
    difference; a failure to decode (an exception) counts every byte."""
    if got is None or isinstance(got, Exception):
        return len(want)
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(want, np.uint8)
    n = min(a.shape[0], b.shape[0])
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(a.shape[0] - b.shape[0])


def judge(run, inputs: list) -> tuple:
    """-> ({name: {"value", "limit"}}, the number of failed calls)."""
    raised = sum(c.error is not None for c in run.calls)
    dec_wrong = 0
    failed = raised
    distinct = []  # (input index, container)
    which = []     # per compress call: its distinct container
    for c in run.calls:
        if c.error is not None:
            continue
        if c.kind == "decompress":
            w = bytes_wrong(c.out, inputs[c.index])
            dec_wrong += w
            failed += w > 0
            continue
        for j, (i, blob) in enumerate(distinct):
            if i == c.index and blob == c.out:
                which.append(j)
                break
        else:
            distinct.append((c.index, c.out))
            which.append(len(distinct) - 1)
    decoded = decode_containers([blob for _, blob in distinct],
                                workers=min(8, len(os.sched_getaffinity(0))))
    per = [bytes_wrong(t, inputs[i]) for t, (i, _) in zip(decoded, distinct)]
    cont_wrong = sum(per[j] for j in which)
    failed += sum(per[j] > 0 for j in which)
    values = {"calls_raised": raised, "decompress_bytes_wrong": dec_wrong,
              "container_bytes_wrong": cont_wrong}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    return checks, failed

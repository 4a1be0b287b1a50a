# Copied from phyngsc_tpu/container/block.py; imports point at phyngsc_tpu_torch.
"""Fixed-size block framing with split sub-blocks.

Capability equivalent of the reference block/container format (C11,
structures.h:310-333, phyNGSC.cpp:843-903): compressed sub-blocks are packed
into fixed-size blocks (default 8 MiB, header included); a sub-block that
crosses the boundary is split, flagged on both sides (the reference's
FSBS/LSBS bits, defs.h:82-86). Each block header carries its writer id so a
block is self-describing — the metadata the reference's timestamp protocol
relied on (C13) — but here block *placement* is deterministic (offset prefix
sums, parallel/offsets.py), so no verification pass is needed.

Header layout (byte-aligned, big-endian):
  [writer_id: u16][n_entries: u8][flags: u8][entry sizes: u32 × n_entries]
flags bit0 = first entry is the tail of a split sub-block
flags bit1 = last entry is the head of a split sub-block
A short final block per writer is allowed; blocks with 255 entries may be
zero-padded to the fixed size (entry sizes tell the reader what to skip).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

FLAG_FIRST_IS_TAIL = 1
FLAG_LAST_IS_HEAD = 2
MAX_ENTRIES = 255


def header_size(n_entries: int) -> int:
    return 2 + 1 + 1 + 4 * n_entries


@dataclasses.dataclass
class Block:
    writer_id: int
    payload: bytes  # exactly block_size, or shorter for a writer's last block


def _emit(writer_id: int, entries: List[bytes], first_is_tail: bool,
          last_is_head: bool, block_size: int, pad: bool) -> Block:
    flags = (FLAG_FIRST_IS_TAIL if first_is_tail else 0) | (
        FLAG_LAST_IS_HEAD if last_is_head else 0
    )
    head = bytearray()
    head += writer_id.to_bytes(2, "big")
    head += len(entries).to_bytes(1, "big")
    head += flags.to_bytes(1, "big")
    for e in entries:
        head += len(e).to_bytes(4, "big")
    body = bytes(head) + b"".join(entries)
    if pad and len(body) < block_size:
        body += b"\x00" * (block_size - len(body))
    assert len(body) <= block_size
    return Block(writer_id, body)


class BlockAssembler:
    """Incremental block framing: feed sub-blocks with add(), collect
    completed fixed-size blocks as they fill, finish() for the final short
    block. Streams — holds at most one partial block, so drivers can write
    each block out the moment it completes (the reference writes each 8 MiB
    block inside its region loop, phyNGSC.cpp:875; this is the same bounded
    memory behavior with deterministic placement). pack_blocks() is the
    collect-everything wrapper; both produce identical bytes."""

    def __init__(self, writer_id: int, block_size: int):
        self.writer_id = writer_id
        self.block_size = block_size
        self._entries: List[bytes] = []
        self._used = header_size(0)
        self._first_is_tail = False
        self._last_is_head = False
        self.n_blocks = 0

    def _close(self, pad: bool) -> Block:
        b = _emit(self.writer_id, self._entries, self._first_is_tail,
                  self._last_is_head, self.block_size, pad)
        self._entries = []
        self._used = header_size(0)
        self._first_is_tail = self._last_is_head
        self._last_is_head = False
        self.n_blocks += 1
        return b

    def add(self, subblock: bytes) -> Iterator[Block]:
        """Feed one compressed sub-block; yields any blocks that filled."""
        data = subblock
        while True:
            room = self.block_size - self._used - 4  # 4 = entry size field
            if room <= 0 or len(self._entries) >= MAX_ENTRIES:
                yield self._close(pad=True)
                continue
            if len(data) <= room:
                self._entries.append(data)
                self._used += 4 + len(data)
                return
            self._entries.append(data[:room])
            self._used += 4 + room
            data = data[room:]
            self._last_is_head = True
            yield self._close(pad=False)  # emits exactly block_size

    def finish(self) -> Iterator[Block]:
        """Emit the final partial block (always at least one block per
        writer, even when no sub-blocks were added)."""
        if self._entries or not self.n_blocks:
            yield self._close(pad=False)


def pack_blocks(writer_id: int, subblocks: Sequence[bytes],
                block_size: int) -> List[Block]:
    """Frame a writer's compressed sub-blocks into fixed-size blocks.

    All blocks are exactly block_size except the last. Sub-blocks larger than
    the remaining space are split across consecutive blocks (possibly more
    than two for sub-blocks larger than a whole block).
    """
    asm = BlockAssembler(writer_id, block_size)
    blocks: List[Block] = []
    for sb in subblocks:
        blocks.extend(asm.add(sb))
    blocks.extend(asm.finish())
    return blocks


def parse_block(data: bytes) -> Tuple[int, int, List[bytes]]:
    """→ (writer_id, flags, entries)."""
    writer_id = int.from_bytes(data[0:2], "big")
    n = data[2]
    flags = data[3]
    sizes = [
        int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(n)
    ]
    off = header_size(n)
    entries = []
    for s in sizes:
        entries.append(data[off : off + s])
        off += s
    return writer_id, flags, entries


def iter_subblocks(blocks_in_file_order: Iterator[Tuple[int, bytes]]):
    """Reassemble split sub-blocks.

    Takes (writer_id, block_bytes) in file order, yields
    (writer_id, subblock_bytes) in each writer's original order. Split pieces
    are stitched per writer (same-writer blocks are consecutive *per writer*
    in file order, whatever the global interleaving — the reference stitches
    the same way across same-rank blocks, phyNGSC.cpp:852-897 decode mirror).
    """
    pending: dict = {}
    for wid, data in blocks_in_file_order:
        _, flags, entries = parse_block(data)
        if not entries:
            continue
        start = 0
        if flags & FLAG_FIRST_IS_TAIL:
            pending[wid] = pending.get(wid, b"") + entries[0]
            start = 1
            if not (flags & FLAG_LAST_IS_HEAD) or len(entries) > 1:
                if wid in pending:
                    yield wid, pending.pop(wid)
        elif wid in pending:
            raise ValueError(f"writer {wid}: dangling split sub-block")
        end = len(entries)
        if flags & FLAG_LAST_IS_HEAD:
            end -= 1
        for e in entries[start:end]:
            yield wid, e
        if flags & FLAG_LAST_IS_HEAD and end >= start:
            pending[wid] = pending.get(wid, b"") + entries[-1]
    if pending:
        raise ValueError("file ends with an unterminated split sub-block")

# Copied from phyngsc_tpu/utils/bitio.py; imports point at phyngsc_tpu_torch.
"""Host-side bit-granular I/O for headers, footers and stream framing.

Capability equivalent of the reference's BitStream/BitMemory pair
(bit_stream.h:80-277, bit_memory.h:21-93): MSB-first bit packing with byte
flushing. Unlike the reference there is a single implementation (the
BitStream/BitMemory split existed only for ownership semantics,
bit_memory.h:564-645) and writes go to a growable bytearray. Device-side bulk
bit packing lives in ops/bitpack.py; this class is for small, irregular
metadata only.
"""

from __future__ import annotations

import numpy as np


def bit_length(x: int) -> int:
    """Number of bits needed to represent x (>=1 even for x==0).

    Mirrors BitStream::BitLength semantics (bit_stream.h:268-277): the
    reference returns 1 for 0 so a width of zero is never emitted.
    """
    return max(1, int(x).bit_length())


class BitWriter:
    """MSB-first bit writer over a growable byte buffer."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # pending bits, MSB-aligned conceptually (value form)
        self._nbits = 0

    def put_bits(self, value: int, nbits: int) -> None:
        if nbits < 0:
            raise ValueError("nbits must be >= 0")
        if nbits == 0:
            return
        value = int(value)
        if value < 0 or value >> nbits:
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def put_bit(self, b: int) -> None:
        self.put_bits(1 if b else 0, 1)

    def put_byte(self, b: int) -> None:
        self.put_bits(b, 8)

    def put_uint(self, value: int, nbytes: int) -> None:
        """Big-endian aligned integer (mirrors PutWord's MSB-first layout,
        bit_stream.h:220-233, generalized to any width)."""
        self.put_bits(value, 8 * nbytes)

    def put_bytes(self, data: bytes) -> None:
        if self._nbits == 0:
            self._buf.extend(data)
        else:  # unaligned: go through the slow path
            for b in data:
                self.put_bits(b, 8)

    def flush(self) -> None:
        """Zero-pad to a byte boundary (FlushPartialWordBuffer equivalent,
        bit_stream.h:183-200)."""
        if self._nbits:
            self.put_bits(0, 8 - self._nbits)

    @property
    def bit_position(self) -> int:
        return 8 * len(self._buf) + self._nbits

    def getvalue(self) -> bytes:
        if self._nbits:
            raise ValueError("unflushed partial byte; call flush() first")
        return bytes(self._buf)


def put_uint_array(bw: "BitWriter", values, width: int) -> None:
    """Write len(values) fixed-width fields MSB-first (vectorized — a Python
    per-element loop costs ~1.5 µs/field, which adds up at thousands of
    substream-table entries per sub-block)."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    if n == 0 or width == 0:
        return
    bits = (values[:, None] >> np.arange(width - 1, -1, -1, dtype=np.uint64)[None, :]) & 1
    payload = np.packbits(bits.astype(np.uint8).reshape(-1))
    total = n * width
    bw.put_bits(int.from_bytes(payload.tobytes(), "big") >> (8 * payload.shape[0] - total),
                total)


def get_uint_array(br: "BitReader", n: int, width: int) -> np.ndarray:
    if n == 0 or width == 0:
        return np.zeros(n, np.int64)
    total = n * width
    raw = br.get_bits(total)
    nbytes = (total + 7) // 8
    data = (raw << (8 * nbytes - total)).to_bytes(nbytes, "big")
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:total]
    bits = bits.reshape(n, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1, dtype=np.int64)[None, :]).sum(axis=1)


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("_buf", "_pos", "_acc", "_nbits")

    def __init__(self, data) -> None:
        self._buf = memoryview(np.asarray(bytearray(data), dtype=np.uint8)).cast("B") \
            if not isinstance(data, (bytes, bytearray, memoryview)) else memoryview(data)
        self._pos = 0  # byte position of next unread byte
        self._acc = 0
        self._nbits = 0

    def get_bits(self, nbits: int) -> int:
        if nbits < 0:
            raise ValueError("nbits must be >= 0")
        while self._nbits < nbits:
            if self._pos >= len(self._buf):
                raise EOFError("bit buffer exhausted")
            self._acc = (self._acc << 8) | self._buf[self._pos]
            self._pos += 1
            self._nbits += 8
        self._nbits -= nbits
        out = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return out

    def peek_bits(self, nbits: int) -> int:
        """Next nbits without consuming; bits past the end read as 0 (a
        prefix-code LUT peeks full width near the flush padding)."""
        pos, acc, nb = self._pos, self._acc, self._nbits
        n = len(self._buf)
        while nb < nbits and pos < n:
            acc = (acc << 8) | self._buf[pos]
            pos += 1
            nb += 8
        if nb >= nbits:
            return (acc >> (nb - nbits)) & ((1 << nbits) - 1)
        return (acc << (nbits - nb)) & ((1 << nbits) - 1)

    def skip_bits(self, nbits: int) -> None:
        self.get_bits(nbits)

    def get_bit(self) -> int:
        return self.get_bits(1)

    def get_byte(self) -> int:
        return self.get_bits(8)

    def get_uint(self, nbytes: int) -> int:
        return self.get_bits(8 * nbytes)

    def get_bytes(self, n: int) -> bytes:
        if self._nbits == 0:
            if self._pos + n > len(self._buf):
                raise EOFError("bit buffer exhausted")
            out = bytes(self._buf[self._pos : self._pos + n])
            self._pos += n
            return out
        return bytes(self.get_bits(8) for _ in range(n))

    def align(self) -> None:
        """Drop bits up to the next byte boundary."""
        self._nbits = 0
        self._acc = 0

    @property
    def bit_position(self) -> int:
        return 8 * self._pos - self._nbits

    @property
    def exhausted(self) -> bool:
        return self._nbits == 0 and self._pos >= len(self._buf)

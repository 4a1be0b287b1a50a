"""Bit reading, canonical Huffman tables and the lane walk of the plain
reference decoder of the .ngsct container.

BitReader, get_uint_array and load_table are frozen copies of the host
code that writes the container's headers (utils/bitio.py and ops/huffman.py
of the codec). The decode tables and the walk are written here from the
format: codes are canonical (assigned in (length, symbol) order), each
substream ("lane") starts on a 32-bit word and holds its codes MSB-first,
one after the other, in record-major slot order. The walk steps every lane
at once, one symbol a step: numpy across lanes, never a symbol at a time.
"""

from __future__ import annotations

import numpy as np


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("_buf", "_pos", "_acc", "_nbits")

    def __init__(self, data) -> None:
        self._buf = memoryview(data)
        self._pos = 0
        self._acc = 0
        self._nbits = 0

    def get_bits(self, nbits: int) -> int:
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
            out = bytes(self._buf[self._pos:self._pos + n])
            self._pos += n
            return out
        return bytes(self.get_bits(8) for _ in range(n))

    def align(self) -> None:
        self._nbits = 0
        self._acc = 0


def get_uint_array(br: BitReader, n: int, width: int) -> np.ndarray:
    """n fixed-width fields, MSB-first."""
    if n == 0 or width == 0:
        return np.zeros(n, np.int64)
    total = n * width
    raw = br.get_bits(total)
    nbytes = (total + 7) // 8
    data = (raw << (8 * nbytes - total)).to_bytes(nbytes, "big")
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:total]
    bits = bits.reshape(n, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1, dtype=np.int64)).sum(axis=1)


def load_table(br: BitReader, alphabet: int):
    """A stored code-length table -> (lens (alphabet,) uint8, singleton):
    [n_present: 16b]; 1 present: [symbol: 16b], a zero-bit tree; more:
    [presence bitmap, byte-rounded][4b (len - 1) per present symbol]."""
    n_present = br.get_bits(16)
    lens = np.zeros(alphabet, np.uint8)
    if n_present == 0:
        return lens, -1
    if n_present == 1:
        return lens, br.get_bits(16)
    nbytes = (alphabet + 7) // 8
    mask = np.unpackbits(np.frombuffer(
        br.get_bits(8 * nbytes).to_bytes(nbytes, "big"), np.uint8))
    idx = np.flatnonzero(mask[:alphabet])
    if idx.shape[0] != n_present:
        raise ValueError("corrupt code table: presence bitmap disagrees")
    lens[idx] = get_uint_array(br, n_present, 4) + 1
    return lens, -1


def decode_lut(lens: np.ndarray, singleton: int, lut_bits: int) -> np.ndarray:
    """The (2^lut_bits,) table of one canonical code: window -> (length << 9)
    | symbol. The code of rank i in (length, symbol) order covers the
    2^(lut_bits - len) windows from the Kraft sum of the codes before it.
    A zero-bit tree gives its symbol everywhere, consuming nothing; windows
    past an incomplete code's end read 0."""
    size = 1 << lut_bits
    if singleton >= 0:
        return np.full(size, singleton, np.int64)
    lens = lens.astype(np.int64)
    present = np.flatnonzero(lens)
    if present.size and int(lens.max()) > lut_bits:
        raise ValueError("corrupt code table: a code longer than the LUT")
    order = present[np.lexsort((present, lens[present]))]
    width = np.int64(1) << (lut_bits - lens[order])
    if int(width.sum()) > size:
        raise ValueError("corrupt code table: Kraft sum above 1")
    entries = np.repeat((lens[order] << 9) | order, width)
    out = np.zeros(size, np.int64)
    out[:entries.shape[0]] = entries
    return out


def walk(words: np.ndarray, lane_word0: np.ndarray, lane_words: np.ndarray,
         lane_slot0: np.ndarray, lane_slots: np.ndarray,
         slot_lut: np.ndarray, luts: np.ndarray, lut_bits: int) -> np.ndarray:
    """Decode every lane of a stream set at once.

    words: the uint32 words of all streams, concatenated; lane s starts at
    word lane_word0[s], holds lane_words[s] words and lane_slots[s] symbols,
    which go to out[lane_slot0[s] : + lane_slots[s]]; slot j is looked up in
    table slot_lut[j] of luts, (n_tables, 2^lut_bits) entries (length << 9)
    | symbol. Returns the (n_slots,) symbols. Raises ValueError where a lane
    does not end in its last word (a window that no code covers consumes
    nothing, so its lane stops short)."""
    n_slots = int(slot_lut.shape[0])
    out = np.zeros(n_slots, np.int64)
    S = lane_slots.shape[0]
    if S == 0 or n_slots == 0:
        return out
    w = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    pairs = (w[:-1] << np.uint64(32)) | w[1:]  # 64 bits from each word on
    order = np.argsort(-lane_slots, kind="stable")  # longest lanes first
    n = lane_slots[order].astype(np.int64)
    pos = (lane_word0[order].astype(np.uint64) << np.uint64(5))
    slot0 = lane_slot0[order].astype(np.int64)
    flat = luts.reshape(-1).astype(np.uint64)
    tab = slot_lut.astype(np.uint64) << np.uint64(lut_bits)
    # lanes still walking at step t: a prefix of the sorted lanes
    active = np.searchsorted(-n, -np.arange(int(n[0])), side="left")
    shift = np.uint64(64 - lut_bits)
    five, low5, sym9, nine = (np.uint64(5), np.uint64(31), np.uint64(0x1FF),
                              np.uint64(9))
    for t in range(int(n[0])):
        k = active[t]
        p = pos[:k]
        sl = slot0[:k] + t
        e = flat[tab[sl] + ((pairs[p >> five] << (p & low5)) >> shift)]
        out[sl] = e & sym9
        p += e >> nine
    end = pos.astype(np.int64)
    first = lane_word0[order].astype(np.int64) * 32
    last = first + lane_words[order].astype(np.int64) * 32
    # a lane's codes fill its words but the last's padding (< 32 bits)
    if np.any(end > last) or np.any(
            (end <= last - 32) & (lane_words[order] > 0)):
        raise ValueError("corrupt substream: a lane's codes do not fill "
                         "its words")
    return out

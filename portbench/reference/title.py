"""The title section of a sub-block, read by the plain reference.

Titles are split on the separators " ._,=:/-#" into fields that every
record shares. A numeric field is a fixed-width value (or a delta) in the
fixed stream, a per-32-record block descriptor in the header (NUM_BLOCK),
or one symbol of a shared Huffman tree in the walk stream (NUM_HUF). A
char field is one Huffman tree per position (past the last tree, the last
one) in the walk stream, its length constant or in the fixed stream; with
block constancy only the first record of a constant 32-record block is
coded. The header layout is a frozen copy of the codec's title header
(models/title.py read_header); the decode is written here on the lane walk
of bits.py.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bits import (BitReader, decode_lut, get_uint_array,
                                      load_table, walk)

NUMERIC, CHAR = 0, 1
VALUE, DELTA, BLOCK, HUF = 0, 1, 2, 3
BLK_CONST, BLK_DELTA, BLK_RAW = 0, 1, 2
BLOCK_RECORDS = 32
ALPHABET = 256
_POW10 = np.array([10 ** k for k in range(1, 19)], np.int64)


def _unzigzag(z: int) -> int:
    return (z >> 1) ^ -(z & 1)


def _base(br: BitReader) -> int:
    v = br.get_uint(8)
    if v >= 1 << 63:
        raise ValueError("corrupt numeric base")
    return v


def _chunk_widths(width: int) -> list:
    if width == 0:
        return []
    n = (width + 15) // 16
    return [width - 16 * (n - 1)] + [16] * (n - 1)


def read_header(br: BitReader, R: int) -> dict:
    """-> {"seps", "fields", "n_fixed", "n_char", "sub"}; each field a dict."""
    F = br.get_bits(16)
    seps = bytes(br.get_byte() for _ in range(max(F - 1, 0)))
    fields = []
    for _ in range(F):
        if br.get_bit() == NUMERIC:
            mode = br.get_bit()
            width = br.get_bits(7)
            if width == 127:  # per-block descriptors
                wv, wd = br.get_bits(7), br.get_bits(7)
                if wv > 64 or wd > 64:
                    raise ValueError("corrupt block widths")
                base = _base(br)
                nB = (R + BLOCK_RECORDS - 1) // BLOCK_RECORDS
                flags = np.zeros(nB, np.int64)
                a = np.zeros(nB, np.int64)
                d = np.zeros(nB, np.int64)
                for b in range(nB):
                    flags[b] = br.get_bits(2)
                    if flags[b] != BLK_RAW:
                        a[b] = br.get_bits(wv)
                    if flags[b] == BLK_DELTA:
                        d[b] = br.get_bits(wd)
                cnt = np.clip(R - np.arange(nB) * BLOCK_RECORDS, 1,
                              BLOCK_RECORDS)
                raw = get_uint_array(br, int(cnt[flags == BLK_RAW].sum()), wv)
                fields.append({"kind": NUMERIC, "mode": BLOCK, "base": base,
                               "flags": flags, "a": a, "d": d, "raw": raw})
            elif width == 126:  # shared-tree Huffman
                hsub = br.get_bit()
                alpha = br.get_bits(10)
                if hsub == VALUE:
                    base, first = _base(br), 0
                else:
                    first = _base(br)
                    base = _unzigzag(_base(br))
                lens, sing = load_table(br, alpha)
                fields.append({"kind": NUMERIC, "mode": HUF, "hsub": hsub,
                               "base": base, "first": first, "lens": lens,
                               "sing": sing})
            else:
                if mode == VALUE:
                    base, first = _base(br), 0
                else:
                    first = _base(br)
                    base = _unzigzag(_base(br))
                fields.append({"kind": NUMERIC, "mode": mode, "base": base,
                               "first": first,
                               "chunks": _chunk_widths(width)})
        else:
            max_len = br.get_bits(16)
            if br.get_bit():
                const_len, len_width = br.get_bits(16), 0
            else:
                const_len, len_width = -1, br.get_bits(5)
            n_trees = br.get_bits(16)
            blk_const = None
            if n_trees == 0xFFFF:
                n_trees = br.get_bits(16)
                nB = (R + BLOCK_RECORDS - 1) // BLOCK_RECORDS
                blk_const = np.array([br.get_bit() for _ in range(nB)], bool)
            tables = [load_table(br, ALPHABET) for _ in range(n_trees)]
            fields.append({"kind": CHAR, "max_len": max_len,
                           "const_len": const_len, "len_width": len_width,
                           "tables": tables, "blk_const": blk_const})
    n_fixed = br.get_uint(4)
    n_char = br.get_uint(4)
    n_sub = br.get_bits(24)
    w = br.get_bits(6)
    sub = get_uint_array(br, n_sub, w)
    if int(sub.sum()) > n_char:
        raise ValueError("corrupt title substream table")
    return {"seps": seps, "fields": fields, "n_fixed": n_fixed,
            "n_char": n_char, "sub": sub}


def _fixed_chunks(words: np.ndarray, R: int, widths: list) -> np.ndarray:
    """(R, K) chunks: record r's chunk k at bit r * stride + the widths
    before k of the fixed stream."""
    K = len(widths)
    if not K or not R:
        return np.zeros((R, K), np.int64)
    wd = np.array(widths, np.int64)
    stride = int(wd.sum())
    off = (np.arange(R, dtype=np.int64)[:, None] * stride
           + (np.cumsum(wd) - wd)[None, :])
    w = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    pair = (w[off >> 5] << np.uint64(32)) | w[(off >> 5) + 1]
    top = (pair << (off & 31).astype(np.uint64)) >> np.uint64(32)
    top &= np.uint64(0xFFFFFFFF)
    val = top >> (np.uint64(32) - wd.astype(np.uint64))
    return val.astype(np.int64)


def _ndigits(v: np.ndarray) -> np.ndarray:
    return np.searchsorted(_POW10, np.maximum(v, 1), side="right") + 1


def _block_values(f: dict, R: int) -> np.ndarray:
    nB = f["flags"].shape[0]
    i = np.arange(BLOCK_RECORDS, dtype=np.int64)
    zz = f["d"]
    step = np.where(zz & 1, -((zz + 1) >> 1), zz >> 1)
    step = np.where(f["flags"] == BLK_DELTA, step, 0)
    V = (f["a"] + f["base"])[:, None] + step[:, None] * i[None, :]
    cnt = np.clip(R - np.arange(nB) * BLOCK_RECORDS, 1, BLOCK_RECORDS)
    raw = f["flags"] == BLK_RAW
    if raw.any():
        m = i[None, :] < cnt[raw][:, None]
        Vr = np.zeros((int(raw.sum()), BLOCK_RECORDS), np.int64)
        Vr[m] = f["raw"] + f["base"]
        V[raw] = Vr
    return V[i[None, :] < cnt[:, None]]


class TitleJob:
    """One sub-block's title section: read_header, then the fixed stream;
    the walk stream's lanes are handed to walk() in batches (slots()),
    and assemble() builds the titles from the walked symbols."""

    def __init__(self, section: bytes, R: int, G: int):
        br = BitReader(section)
        self.h = h = read_header(br, R)
        br.align()
        self.fixed = np.frombuffer(br.get_bytes(4 * h["n_fixed"]), ">u4")
        self.char = np.frombuffer(br.get_bytes(4 * h["n_char"]), ">u4")
        self.R, self.G = R, G
        widths = []
        for f in h["fields"]:
            if f["kind"] == NUMERIC and f["mode"] in (VALUE, DELTA):
                widths += f["chunks"]
            elif f["kind"] == CHAR and f["const_len"] < 0:
                widths.append(f["len_width"])
        chunks = _fixed_chunks(self.fixed, R, widths)
        F = len(h["fields"])
        self.vals, self.flen = {}, np.zeros((R, F), np.int64)
        k = 0
        for j, f in enumerate(h["fields"]):
            if f["kind"] == NUMERIC:
                if f["mode"] == HUF:
                    continue
                if f["mode"] == BLOCK:
                    v = _block_values(f, R)
                else:
                    enc = np.zeros(R, np.int64)
                    for wdt in f["chunks"]:
                        enc = (enc << wdt) | chunks[:, k]
                        k += 1
                    v = self._from_coded(enc, f, f["mode"])
                self.vals[j] = v
                self.flen[:, j] = _ndigits(v)
            elif f["const_len"] >= 0:
                self.flen[:, j] = f["const_len"]
            else:
                self.flen[:, j] = chunks[:, k]
                k += 1
        # the walk: per record, the walked fields in order, each its steps
        self.walked, trees, self.tables = [], [], []
        steps = []
        for j, f in enumerate(h["fields"]):
            if f["kind"] == CHAR and f["max_len"] > 0:
                s = self.flen[:, j].copy()
                if f["blk_const"] is not None:
                    s *= self._rep(f)
                n_t = len(f["tables"])
                trees.append((len(self.tables), n_t))
                self.tables += f["tables"]
            elif f["kind"] == NUMERIC and f["mode"] == HUF:
                s = np.ones(R, np.int64)
                trees.append((len(self.tables), 1))
                self.tables.append((f["lens"], f["sing"]))
            else:
                continue
            self.walked.append(j)
            steps.append(s)
        self.steps = (np.stack(steps, 1) if steps
                      else np.zeros((R, 0), np.int64))
        self.trees = trees

    def _from_coded(self, enc, f, mode):
        if mode == VALUE:
            return enc + f["base"]
        d = enc + f["base"]
        if d.shape[0]:
            d[0] = 0
        return np.cumsum(d) + f["first"]

    def _rep(self, f) -> np.ndarray:
        idx = np.arange(self.R)
        return (~f["blk_const"][idx // BLOCK_RECORDS]
                | (idx % BLOCK_RECORDS == 0))

    def slots(self, lut_bits: int):
        """-> (lane word counts, lane slot counts, (n_slots,) table of each
        slot (local), (n_tables, 2^lut_bits) LUTs)."""
        R, G = self.R, self.G
        per_rec = self.steps.sum(axis=1)
        n_lanes = self.h["sub"].shape[0]
        rec_lane = np.arange(R) // G
        lane_slots = np.bincount(rec_lane, per_rec, minlength=n_lanes)
        lane_slots = lane_slots.astype(np.int64)[:n_lanes]
        n = int(per_rec.sum())
        slot_lut = np.zeros(n, np.int64)
        # slot of (record r, walked field i, step p): the record's first
        # slot + the steps of the fields before i + p
        rec0 = np.cumsum(per_rec) - per_rec
        before = np.cumsum(self.steps, axis=1) - self.steps
        self.slot_base = rec0[:, None] + before
        for i, (t0, n_t) in enumerate(self.trees):
            s = self.steps[:, i]
            tot = int(s.sum())
            if not tot:
                continue
            p = np.arange(tot) - np.repeat(np.cumsum(s) - s, s)
            dst = np.repeat(self.slot_base[:, i], s) + p
            slot_lut[dst] = t0 + np.minimum(p, n_t - 1)
        luts = (np.stack([decode_lut(l, s, lut_bits) for l, s in self.tables])
                if self.tables else np.zeros((0, 1 << lut_bits), np.int64))
        return self.h["sub"], lane_slots, slot_lut, luts

    def assemble(self, syms: np.ndarray):
        """syms: the walked slots -> (titles (R, TL) uint8, tlens (R,))."""
        R, fields = self.R, self.h["fields"]
        contents = {}
        for i, j in enumerate(self.walked):
            f = fields[j]
            if f["kind"] == NUMERIC:
                v = self._from_coded(syms[self.slot_base[:, i]], f, f["hsub"])
                self.vals[j] = v
                self.flen[:, j] = _ndigits(v)
                continue
            W = int(self.flen[:, j].max()) if R else 0
            pos = np.arange(W)
            m = pos[None, :] < self.steps[:, i:i + 1]
            c = np.zeros((R, W), np.uint8)
            c[m] = syms[(self.slot_base[:, i:i + 1] + pos[None, :])[m]]
            if f["blk_const"] is not None:
                src = np.where(self._rep(f), np.arange(R),
                               np.arange(R) // BLOCK_RECORDS * BLOCK_RECORDS)
                c = c[src]
            contents[j] = c
        F = len(fields)
        tlens = self.flen.sum(axis=1) + max(F - 1, 0)
        TL = int(tlens.max()) if R else 0
        out = np.zeros((R, max(TL, 1)), np.uint8)
        col = np.zeros(R, np.int64)
        rows = np.arange(R)
        for j, f in enumerate(fields):
            fl = self.flen[:, j]
            W = int(fl.max()) if R else 0
            pos = np.arange(W)
            m = pos[None, :] < fl[:, None]
            if f["kind"] == NUMERIC:
                place = np.where(m, fl[:, None] - 1 - pos[None, :], 0)
                c = ((self.vals[j][:, None] // 10 ** place) % 10 + 48)
            else:
                c = contents.get(j, np.zeros((R, W), np.uint8))
            out[np.broadcast_to(rows[:, None], m.shape)[m],
                (col[:, None] + pos[None, :])[m]] = c[:, :W][m]
            col += fl
            if j < F - 1:
                out[rows, col] = self.h["seps"][j]
                col += 1
        return out[:, :TL], tlens

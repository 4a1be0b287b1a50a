"""DNA stream codec: ambiguity transfer, SOLiD colour-space delta
translation and 2-bit/Huffman coding (port of phyngsc_tpu/models/dna.py).

analyze runs on K1 (ops/histogram.py); the Huffman encode's code lookup on
K4 (ops/lookup.py); decode_plain_walk and decode_huffman_walk on K3
(ops/bitpack.py), over the word plane that K5 builds. Mode planning, delta
detection and the stream header are host code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.device import constant
from phyngsc_tpu_torch.utils.bitio import (BitReader, BitWriter, bit_length,
                                           get_uint_array, put_uint_array)
from phyngsc_tpu_torch.ops import bitpack, histogram, huffman, lookup

ALPHABET = 256

# The tables, detect_delta, DnaPlan, plan, write_header and read_header are
# copied from phyngsc_tpu/models/dna.py (host code in a module that imports
# jax).

# trans_amb_codes equivalent (phyNGSC.cpp:184-206): ACGT → 1, IUPAC → 2..16.
AMB_CODE = np.zeros(256, dtype=np.uint8)
for _c in b"ACGT":
    AMB_CODE[_c] = 1
for _i, _c in enumerate(b"YRWSKMDVHBNXU.-"):
    AMB_CODE[_c] = 2 + _i
# inverse: code → IUPAC character
AMB_CHAR = np.zeros(17, dtype=np.uint8)
for _s in range(256):
    if AMB_CODE[_s] >= 2:
        AMB_CHAR[AMB_CODE[_s]] = _s

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
NUC_INDEX = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(b"ACGT"):
    NUC_INDEX[_c] = _i

MODE_PLAIN = 0
MODE_HUFFMAN = 1


def valid_mask(lens: torch.Tensor, L: int) -> torch.Tensor:
    return torch.arange(L, device=lens.device)[None, :] < lens[:, None]


def _table(name: str, device) -> torch.Tensor:
    """The module's host table `name` as int64 on `device`, uploaded once a
    process (device.constant)."""
    return constant(f"dna.{name}",
                    lambda: globals()[name].astype(np.int64), device)


#: ACGT, AMB_CHAR and NUC_INDEX as one int64 host array, the decode's
#: tables; the decode uploads it with its other inputs and hands the
#: slices (device_tables) to decode_plain_walk, restore_ambiguity and
#: delta_untranslate, which otherwise upload their own
DECODE_TABLES = np.concatenate([ACGT, AMB_CHAR, NUC_INDEX]).astype(np.int64)


def device_tables(t: torch.Tensor) -> dict:
    """DECODE_TABLES on a device -> its tables by keyword."""
    return {"acgt": t[:4], "amb_char": t[4:21], "nuc_index": t[21:]}


# ---------------------------------------------------------------------------
# Ambiguity transfer
# ---------------------------------------------------------------------------

def transfer_ambiguity(seq: torch.Tensor, qual: torch.Tensor,
                       lens: torch.Tensor):
    """Apply the DNA→quality ambiguity transfer (phyNGSC.cpp:552-588).

    Returns (qual_out (R, L) uint8 with codes >= 128 at transferred spots,
    keep (R, L) bool — True where the symbol stays in the DNA stream,
    transferred (R,) bool — records whose ambiguity moved to quality)."""
    L = seq.shape[1]
    v = valid_mask(lens, L)
    code = _table("AMB_CODE", seq.device)[seq.long()]
    amb = (code >= 2) & v
    unknown = (code == 0) & v
    qual_ok = (qual >= 33) & (qual <= 40)
    possible = ~torch.any(unknown | (amb & ~qual_ok), dim=1)
    do = possible & torch.any(amb, dim=1)
    moved = do[:, None] & amb
    q = qual.long()
    qual_out = torch.where(moved, 128 + (code << 3) - 16 + (q - 33), q)
    return qual_out.to(torch.uint8), v & ~moved, do


def restore_ambiguity(dna: torch.Tensor, qual: torch.Tensor,
                      lens: torch.Tensor, amb_char=None):
    """Inverse transfer: quality symbols >= 128 expand back to (IUPAC char,
    original quality); dna holds the kept symbols at their positions.
    amb_char: AMB_CHAR on the device (int64), else uploaded here."""
    q = qual.long()
    moved = q >= 128
    code = ((q - 128 + 16) >> 3).clamp(0, 16)
    orig_q = (q - 128 + 16) - (code << 3) + 33
    if amb_char is None:
        amb_char = _table("AMB_CHAR", dna.device)
    amb_ch = amb_char[code]
    seq = torch.where(moved, amb_ch, dna.long())
    qual_out = torch.where(moved, orig_q, q)
    v = valid_mask(lens, qual.shape[1])
    return (torch.where(v, seq, 0).to(torch.uint8),
            torch.where(v, qual_out, 0).to(torch.uint8))


def detect_delta(seq_np: np.ndarray, lens_np: np.ndarray) -> bool:
    """Sub-block-level SOLiD delta detection: every record is nucleotide +
    pure '0'-'3' colors."""
    if seq_np.shape[0] == 0 or seq_np.shape[1] < 2:
        return False
    first = seq_np[0]
    if lens_np[0] < 2 or not (ord("0") <= first[1] <= ord("3")):
        return False
    v = np.arange(seq_np.shape[1])[None, :] < lens_np[:, None]
    heads_ok = np.isin(seq_np[:, 0], ACGT) | ~v[:, 0]
    tail = v & (np.arange(seq_np.shape[1])[None, :] >= 1)
    colors_ok = ~tail | ((seq_np >= ord("0")) & (seq_np <= ord("3")))
    return bool(np.all(heads_ok) and np.all(colors_ok))


def _prefix_xor2(d: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR along dim 1 of 2-bit values, bit by bit: the
    parity of a running count."""
    b0 = torch.cumsum(d & 1, dim=1) & 1
    b1 = torch.cumsum((d >> 1) & 1, dim=1) & 1
    return b0 | (b1 << 1)


def delta_translate(seq: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Colour digits -> nucleotides: out[:, 0] = seq[:, 0] and out[:, n] =
    DELTA_NEXT[out[:, n-1], d_n] (phyngsc_tpu/models/dna.py:67-78, the
    matrices of phyNGSC.cpp:497-502). The JAX package scans over positions;
    DELTA_NEXT[a, d] is a ^ d, so nucleotide n is the head's index XOR the
    prefix XOR of the digits, in whole-plane tensor ops. A non-ACGT head
    (only in rows the valid mask zeroes) indexes as 3, as the JAX gather
    wraps -1."""
    L = seq.shape[1]
    s = seq.long()
    start = _table("NUC_INDEX", seq.device)[s[:, 0]] & 3
    digits = (s[:, 1:] - ord("0")).clamp(0, 3)
    nucs = start[:, None] ^ _prefix_xor2(digits)
    out = torch.cat([s[:, :1], _table("ACGT", seq.device)[nucs]], dim=1)
    return torch.where(valid_mask(lens, L), out, 0).to(torch.uint8)


def delta_untranslate(seq: torch.Tensor, lens: torch.Tensor,
                      nuc_index=None) -> torch.Tensor:
    """Nucleotides -> colour digits, the exact inverse of delta_translate:
    colour n = DELTA_COLOR[nuc n-1, nuc n], which is their XOR. nuc_index:
    NUC_INDEX on the device (int64), else uploaded here."""
    L = seq.shape[1]
    s = seq.long()
    if nuc_index is None:
        nuc_index = _table("NUC_INDEX", seq.device)
    idx = nuc_index[s].clamp(0, 3)
    colors = (idx[:, :-1] ^ idx[:, 1:]) + ord("0")
    out = torch.cat([s[:, :1], colors], dim=1)
    return torch.where(valid_mask(lens, L), out, 0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Stream coding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DnaPlan:
    mode: int                   # MODE_PLAIN | MODE_HUFFMAN
    lens_tab: np.ndarray        # (256,) uint8 (huffman) — zeros for plain
    codes_tab: np.ndarray       # (256,) uint32
    singleton: int = -1         # zero-bit tree symbol (constant base stream)

    def luts(self, lut_bits: int) -> np.ndarray:
        sym, ln = huffman.decode_lut(self.lens_tab, lut_bits, self.singleton)
        return np.asarray((ln.astype(np.int32) << 9) | sym.astype(np.int32))[None, :]


def analyze(seq: torch.Tensor, keep: torch.Tensor,
            small_alpha: bool = False) -> torch.Tensor:
    """(256,) int32 histogram of DNA-stream symbols; small_alpha (every byte
    < 128) runs the 128-bin kernel and pads."""
    if small_alpha:
        h = histogram.global_histogram(seq, keep, 128)
        return torch.nn.functional.pad(h, (0, ALPHABET - 128))
    return histogram.global_histogram(seq, keep, ALPHABET)


def plan(counts: np.ndarray, cfg: CodecConfig) -> DnaPlan:
    counts = np.asarray(counts, dtype=np.int64)
    present = np.flatnonzero(counts)
    total = int(counts.sum())
    lens_tab = huffman.build_code_lengths(counts, cfg.max_code_len)
    cost_huf = int(np.sum(counts * lens_tab))
    only_acgt = bool(np.all(AMB_CODE[present] == 1)) if present.size else True
    if only_acgt and 2 * total <= cost_huf and present.size > 1:
        return DnaPlan(MODE_PLAIN, np.zeros(ALPHABET, np.uint8), np.zeros(ALPHABET, np.uint32))
    codes_tab = np.asarray(huffman.canonical_codes(lens_tab))
    return DnaPlan(MODE_HUFFMAN, lens_tab, codes_tab, huffman.singleton_of(counts))


# 2-bit symbol mapping for plain mode (A=0 C=1 G=2 T=3)
SYM2BIT = np.zeros(256, dtype=np.uint32)
for _i, _c in enumerate(b"ACGT"):
    SYM2BIT[_c] = _i


def encode_device(seq: torch.Tensor, keep: torch.Tensor,
                  tab: torch.Tensor | None, mode: int,
                  records_per_substream: int, n_words_cap: int,
                  group: int = 2, off: int = 0):
    """Pack kept DNA symbols. Returns (words (n_words_cap,) int64 holding
    uint32, sub_n_words (S,) int64, total_words 0-d int64). Plain mode packs
    16 bases per element and takes no table (tab None); Huffman mode looks
    codes up on K4 in tab, the (1, A) int16 fused code table
    (lookup.fused_table_np) sliced to an alphabet window at `off`, and
    groups `group` codes."""
    if mode == MODE_PLAIN:
        vals = _table("SYM2BIT", seq.device)[seq.long()]
        pc, pl = lookup.group_fixed2(vals, keep, 16)
    else:
        A = tab.shape[-1]
        sym = (seq.int() - off).clamp(0, A - 1).to(torch.uint8)
        codes, lens = lookup.split_fused(lookup.fused_lookup(sym, tab))
        codes = torch.where(keep, codes, 0)
        lens = torch.where(keep, lens, 0)
        pc, pl = lookup.group_codes(codes, lens, group)
    lay = bitpack.substream_layout(pl, records_per_substream)
    words = bitpack.pack_bits_scatter(pc, pl, lay["bit_offsets"], n_words_cap)
    return words, lay["sub_n_words"], lay["total_words"]


def decode_huffman_walk(plane: torch.Tensor, keep: torch.Tensor,
                        lut, records_per_substream: int,
                        lut_bits: int) -> torch.Tensor:
    """Huffman DNA decode on K3 (port of decode_huffman_walk): kept slots
    (record, position) consume the lane's next symbol. plane (Wmax, Sp)
    from bitpack.dense_words, keep (S*G, L) bool, lut the host
    (2^lut_bits,) int32 LUT (numpy or a CPU tensor) or a bitpack.WalkLuts
    of it on the device. Returns (S*G, L) uint8 (0 where not kept)."""
    R, L = keep.shape
    S = R // records_per_substream
    tree = torch.zeros(1, dtype=torch.int32, device=keep.device)
    luts = bitpack.walk_luts(lut, lut_bits, plane.device)
    syms = bitpack.walk_masked(plane, keep.reshape(S, -1), luts, tree,
                               plain2=False)
    return syms.reshape(R, L)


def decode_plain_walk(plane: torch.Tensor, keep: torch.Tensor,
                      records_per_substream: int, acgt=None) -> torch.Tensor:
    """2-bit plain DNA decode on K3 (plain2; port of decode_plain_walk).
    acgt: ACGT on the device (int64), else uploaded here. Returns (S*G, L)
    uint8 bases (0 where not kept)."""
    R, L = keep.shape
    S = R // records_per_substream
    syms = bitpack.walk_masked(plane, keep.reshape(S, -1), None, None,
                               plain2=True).reshape(R, L)
    if acgt is None:
        acgt = _table("ACGT", keep.device)
    return torch.where(keep, acgt[syms.long()], 0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Stream header
# ---------------------------------------------------------------------------

def write_header(bw: BitWriter, plan_: DnaPlan, sub_n_words: np.ndarray,
                 total_words: int, is_delta: bool) -> None:
    sub_n_words = np.asarray(sub_n_words)
    bw.put_bits(plan_.mode, 2)
    bw.put_bit(int(is_delta))
    bw.put_uint(int(total_words), 4)
    bw.put_bits(sub_n_words.shape[0], 24)
    w = bit_length(int(sub_n_words.max())) if sub_n_words.size else 1
    bw.put_bits(w, 6)
    put_uint_array(bw, sub_n_words, w)
    if plan_.mode == MODE_HUFFMAN:
        huffman.store_table(bw, plan_.lens_tab, plan_.singleton)


def read_header(br: BitReader):
    mode = br.get_bits(2)
    if mode > MODE_HUFFMAN:
        raise ValueError(f"corrupt DNA stream mode {mode}")
    is_delta = bool(br.get_bit())
    total_words = br.get_uint(4)
    n_sub = br.get_bits(24)
    w = br.get_bits(6)
    if w > 31:
        raise ValueError(f"corrupt substream-table width {w}")
    sub_n_words = get_uint_array(br, n_sub, w).astype(np.int32)
    if int(sub_n_words.sum()) > total_words:
        raise ValueError("corrupt DNA substream table (sum > total)")
    if mode == MODE_HUFFMAN:
        lens_tab, singleton = huffman.load_table(br, ALPHABET)
        codes_tab = np.asarray(huffman.canonical_codes(lens_tab))
    else:
        lens_tab = np.zeros(ALPHABET, np.uint8)
        codes_tab = np.zeros(ALPHABET, np.uint32)
        singleton = -1
    return DnaPlan(mode, lens_tab, codes_tab, singleton), sub_n_words, total_words, is_delta

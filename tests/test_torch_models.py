"""The port's encoders against phyngsc_tpu's (scatter pack on the CPU), fed
the same tables through convert.py: equal words, substream tables and
totals. Plus the ambiguity transfer / restore and the lookup, grouping and
layout pieces they are built from. Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import dna as jdna
from phyngsc_tpu.models import quality as jquality
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu.ops import lookup as jlookup
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import convert
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack, lookup

G = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _planes(n, L, seed, amb=0.01, style="ERR005195"):
    """(R, L) seq / qual planes + lens of synthetic reads, 1024 rows."""
    data = synthesize_fastq(n, read_len=L, style=style, seed=seed,
                            ambiguity_rate=amb).split(b"\n")
    seq = np.zeros((1024, L), np.uint8)
    qual = np.zeros((1024, L), np.uint8)
    seq[:n] = np.frombuffer(b"".join(data[1::4][:n]), np.uint8).reshape(n, L)
    qual[:n] = np.frombuffer(b"".join(data[3::4][:n]), np.uint8).reshape(n, L)
    lens = np.where(np.arange(1024) < n, L, 0).astype(np.int32)
    return seq, qual, lens


def _same(got, ref, total):
    """Port (words, sub, total) vs phyngsc_tpu's: equal up to the total."""
    words, sub, tot = got
    jw, jsub, jtot = (np.asarray(x) for x in ref)
    assert int(tot) == int(jtot) == total
    np.testing.assert_array_equal(sub.numpy(), jsub)
    np.testing.assert_array_equal(words.numpy()[:total].astype(np.uint32),
                                  jw[:total])


@pytest.mark.parametrize("amb", [0.002, 0.2])
def test_transfer_and_restore_match(amb):
    seq, qual, lens = _planes(700, 36, 11, amb)
    jq, jkeep, jdo = (np.asarray(x) for x in jdna.transfer_ambiguity(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lens)))
    q, keep, do = dna.transfer_ambiguity(_t(seq), _t(qual), _t(lens))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(do.numpy(), jdo)
    kept = np.where(jkeep, seq, 0)
    js, jqq = (np.asarray(x) for x in jdna.restore_ambiguity(
        jnp.asarray(kept), jnp.asarray(jq), jnp.asarray(lens)))
    s, qq = dna.restore_ambiguity(_t(kept), q, _t(lens))
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(qq.numpy(), jqq)
    np.testing.assert_array_equal(s.numpy(), seq)  # the transfer inverts
    np.testing.assert_array_equal(qq.numpy(), qual)


@pytest.mark.parametrize("n,L,style,window", [
    (700, 36, "ERR005195", False),
    (700, 36, "ERR005195", True),
    (300, 76, "SRR", True),
])
def test_quality_encode_matches(n, L, style, window):
    seq, qual, lens = _planes(n, L, n + L, style=style)
    jq, _, _ = jdna.transfer_ambiguity(jnp.asarray(seq), jnp.asarray(qual),
                                       jnp.asarray(lens))
    counts = np.asarray(jquality.analyze(jq, jnp.asarray(lens)))
    jt, group = jquality.build_tables_adaptive(counts, CodecConfig())
    pt = convert.quality_tables(jt)
    off, A = jlookup.window_np(counts) if window else (0, 256)
    cap = qual.size // 2 + 200
    ref = jquality.encode_device(
        jq, jnp.asarray(lens), jnp.asarray(jt.codes[:, off:off + A]),
        jnp.asarray(jt.lens[:, off:off + A]), G, cap, group, "scatter",
        np.int32(off) if window else None)
    got = quality.encode_device(
        _t(np.asarray(jq)), _t(lens), _t(pt.codes[:, off:off + A].astype(np.int64)),
        _t(pt.lens[:, off:off + A].astype(np.int64)), G, cap, group, off)
    _same(got, ref, int(ref[2]))


@pytest.mark.parametrize("alphabet,group", [(b"ACGT", 2), (b"ACGTN", 2),
                                            (b"ACGTN", 8)])
def test_dna_encode_matches(alphabet, group):
    rng = np.random.default_rng(len(alphabet) + group)
    seq = np.zeros((1024, 36), np.uint8)
    seq[:900] = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), size=(900, 36))]
    keep = np.zeros((1024, 36), bool)
    keep[:900] = rng.random((900, 36)) < 0.97
    jplan = jdna.plan(np.asarray(jdna.analyze(jnp.asarray(seq),
                                              jnp.asarray(keep))),
                      CodecConfig())
    plan = convert.dna_plan(jplan)
    assert plan.mode == (dna.MODE_PLAIN if alphabet == b"ACGT"
                         else dna.MODE_HUFFMAN)
    cap = seq.size // 2 + 200
    ref = jdna.encode_device(
        jnp.asarray(seq), jnp.asarray(keep), jnp.asarray(jplan.codes_tab),
        jnp.asarray(jplan.lens_tab), jplan.mode, G, cap, group, "scatter")
    got = dna.encode_device(
        _t(seq), _t(keep), _t(plan.codes_tab.astype(np.int64)),
        _t(plan.lens_tab.astype(np.int64)), plan.mode, G, cap, group)
    _same(got, ref, int(ref[2]))


def test_lookup_and_grouping_match():
    rng = np.random.default_rng(5)
    R, L = 200, 37
    tab = ((rng.integers(0, 13, size=(L, 256)) << 12)
           | rng.integers(0, 1 << 12, size=(L, 256))).astype(np.int64)
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)
    fused = lookup.fused_lookup(_t(sym), _t(tab))
    np.testing.assert_array_equal(fused.numpy(), tab[np.arange(L)[None, :], sym])
    codes, lens = lookup.split_fused(fused)
    lens = torch.where(lens > 8, 8, lens)  # 4 codes of <= 8 bits fit 32
    codes = codes & ((1 << lens) - 1)
    for k in (2, 3, 4):
        jc, jl = jlookup.group_codes(jnp.asarray(codes.numpy().astype(np.uint32)),
                                     jnp.asarray(lens.numpy().astype(np.int32)), k)
        c, n = lookup.group_codes(codes, lens, k)
        np.testing.assert_array_equal(c.numpy().astype(np.uint32), np.asarray(jc))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jl))
    vals = rng.integers(0, 4, size=(R, L)).astype(np.uint32)
    keep = rng.random((R, L)) < 0.8
    jc, jl = jlookup.group_fixed2(jnp.asarray(vals), jnp.asarray(keep), 16)
    c, n = lookup.group_fixed2(_t(vals.astype(np.int64)), _t(keep), 16)
    np.testing.assert_array_equal(c.numpy().astype(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jl))


def test_layout_and_pack_match_host_twins():
    rng = np.random.default_rng(9)
    R, L = 256, 10
    lens = rng.integers(0, 33, size=(R, L))
    lens[rng.random((R, L)) < 0.2] = 0
    codes = rng.integers(0, 1 << 32, size=(R, L), dtype=np.uint64)
    codes = codes & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))
    ref = jbitpack.substream_layout_np(lens, G)
    got = bitpack.substream_layout(_t(lens), G)
    np.testing.assert_array_equal(got["bit_offsets"].numpy(), ref["bit_offsets"])
    np.testing.assert_array_equal(got["sub_n_words"].numpy(), ref["sub_n_words"])
    assert int(got["total_words"]) == ref["total_words"]
    n = ref["total_words"]
    words = bitpack.pack_bits_scatter(_t(codes.astype(np.int64)), _t(lens),
                                      got["bit_offsets"], n)
    np.testing.assert_array_equal(
        words.numpy().astype(np.uint32),
        jbitpack.pack_bits_scatter_np(codes, lens, ref["bit_offsets"], n))


def _var_planes(data, Rp):
    """(Rp, L) seq / qual planes + lens of a FASTQ corpus of any lengths."""
    lines = data.split(b"\n")
    seqs, quals = lines[1::4], lines[3::4]
    n = len(seqs)
    lens = np.zeros(Rp, np.int32)
    lens[:n] = [len(x) for x in seqs]
    L = max(4, (int(lens.max()) + 3) // 4 * 4)
    seq = np.zeros((Rp, L), np.uint8)
    qual = np.zeros((Rp, L), np.uint8)
    for i in range(n):
        seq[i, :lens[i]] = np.frombuffer(seqs[i], np.uint8)
        qual[i, :lens[i]] = np.frombuffer(quals[i], np.uint8)
    return seq, qual, lens


@pytest.mark.parametrize("n,L,variable,G_", [(700, 100, True, G),
                                             (40, 1000, False, 8),
                                             (40, 1000, True, 8)])
def test_quality_encode_variable_and_long_reads_match(n, L, variable, G_):
    """The K4 path's plain version inside quality.encode_device against
    phyngsc_tpu's encode_device, for variable lengths and 1000 bp reads
    (positions grouped onto 256 trees), on windowed tables."""
    data = synthesize_fastq(n, read_len=L, seed=n + L, ambiguity_rate=0.01,
                            variable_length=variable)
    seq, qual, lens = _var_planes(data, 1024 if n > 100 else 64)
    jq, _, _ = jdna.transfer_ambiguity(jnp.asarray(seq), jnp.asarray(qual),
                                       jnp.asarray(lens))
    counts = np.asarray(jquality.analyze(jq, jnp.asarray(lens)))
    np.testing.assert_array_equal(
        quality.analyze(_t(np.asarray(jq)), _t(lens)).numpy(), counts)
    jt, group = jquality.build_tables_adaptive(counts, CodecConfig())
    off, A = jlookup.window_np(counts)
    cap = qual.size // 2 + 200
    ref = jquality.encode_device(
        jq, jnp.asarray(lens), jnp.asarray(jt.codes[:, off:off + A]),
        jnp.asarray(jt.lens[:, off:off + A]), G_, cap, group, "scatter",
        np.int32(off))
    pt = convert.quality_tables(jt)
    got = quality.encode_device(
        _t(np.asarray(jq)), _t(lens),
        _t(pt.codes[:, off:off + A].astype(np.int64)),
        _t(pt.lens[:, off:off + A].astype(np.int64)), G_, cap, group, off)
    _same(got, ref, int(ref[2]))


@pytest.mark.parametrize("alphabet", [b"ACGTN", b"ACGTNRY"])
def test_dna_huffman_encode_windowed_matches(alphabet):
    """Huffman DNA through K4's plain version with the (L, A) table
    broadcast from the windowed (A,) table, as phyngsc_tpu builds it."""
    rng = np.random.default_rng(len(alphabet))
    seq = np.zeros((1024, 40), np.uint8)
    seq[:900] = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), size=(900, 40))]
    keep = np.zeros((1024, 40), bool)
    keep[:900] = rng.random((900, 40)) < 0.97
    counts = np.asarray(jdna.analyze(jnp.asarray(seq), jnp.asarray(keep)))
    jplan = jdna.plan(counts, CodecConfig())
    assert jplan.mode == jdna.MODE_HUFFMAN
    off, A = jlookup.window_np(counts.reshape(1, -1))
    assert A == 64 and off > 0
    group = jlookup.group_for(int(jplan.lens_tab.max()))
    cap = seq.size // 2 + 200
    ref = jdna.encode_device(
        jnp.asarray(seq), jnp.asarray(keep),
        jnp.asarray(jplan.codes_tab[off:off + A]),
        jnp.asarray(jplan.lens_tab[off:off + A]), jplan.mode, G, cap, group,
        "scatter", np.int32(off))
    plan = convert.dna_plan(jplan)
    got = dna.encode_device(
        _t(seq), _t(keep), _t(plan.codes_tab[off:off + A].astype(np.int64)),
        _t(plan.lens_tab[off:off + A].astype(np.int64)), plan.mode, G, cap,
        group, off)
    _same(got, ref, int(ref[2]))


def _solid_planes(R, Rp, L, seed):
    """Colour-space reads: a nucleotide head, then '0'-'3' colours; variable
    lengths and zero padding rows."""
    rng = np.random.default_rng(seed)
    lens = np.zeros(Rp, np.int32)
    lens[:R] = rng.integers(1, L + 1, size=R)
    seq = np.zeros((Rp, L), np.uint8)
    seq[:R, 0] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=R)]
    seq[:R, 1:] = rng.integers(0, 4, size=(R, L - 1)) + ord("0")
    seq[np.arange(L)[None, :] >= lens[:, None]] = 0
    return seq, lens


@pytest.mark.parametrize("R,L", [(300, 36), (50, 1), (200, 300)])
def test_delta_translate_matches(R, L):
    seq, lens = _solid_planes(R, 512, L, R + L)
    assert dna.detect_delta(seq[:R], lens[:R]) == jdna.detect_delta(
        seq[:R], lens[:R]) == (L > 1)
    ref = np.asarray(jdna.delta_translate(jnp.asarray(seq), jnp.asarray(lens)))
    got = dna.delta_translate(_t(seq), _t(lens))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    back_ref = np.asarray(jdna.delta_untranslate(jnp.asarray(ref),
                                                 jnp.asarray(lens)))
    back = dna.delta_untranslate(got, _t(lens))
    np.testing.assert_array_equal(back.numpy(), back_ref)
    np.testing.assert_array_equal(back.numpy(), seq)  # the translation inverts


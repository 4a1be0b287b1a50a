"""K2 / K3: the port's walks (plain versions of csrc/walk.cu) against
phyngsc_tpu's Pallas walks in interpret mode, on streams that phyngsc_tpu's
encoder wrote. phyngsc_tpu is fed the dense word plane and LUT runs that its
fused decode builds (subblock.py:1243-1251); the port reads the linear
stream and host-built LUTs. Exact equality: symbols are bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import dna as jdna
from phyngsc_tpu.models import quality as jquality
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu_torch import convert
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack

G = 16
BITS = 12
CFG = CodecConfig()


def _runs(lens2d, singletons):
    wire = jbitpack.pack_lens4_np(lens2d, singletons)
    T = lens2d.shape[0]
    return jbitpack.lut_runs_device(jnp.asarray(wire[: T * 32]),
                                    jnp.asarray(wire[T * 32:]), T, 1 << BITS)


def _dense(words, sub):
    # padded as phyngsc_tpu's decode pads its uploads (a singleton stream
    # has no words at all)
    padded = np.concatenate([words, np.zeros(8, np.uint32)])
    return jnp.asarray(jbitpack.dense_words_np(padded, sub))


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(words):
    return _t(np.asarray(words, np.uint32).view(np.int32))


def _quality_stream(qual, lens, tables):
    """phyngsc_tpu's encoder output for these tables: (words, sub)."""
    cap = qual.size + 64
    w, sub, total = jquality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens), jnp.asarray(tables.codes),
        jnp.asarray(tables.lens), G, cap, 2, "scatter")
    return np.asarray(w)[: int(total)], np.asarray(sub)


def _qual_case(R, Rp, Lt, n_trees, singleton_pos, seed):
    L = max(4, (Lt + 3) // 4 * 4)
    rng = np.random.default_rng(seed)
    qual = np.zeros((Rp, L), np.uint8)
    qual[:R, :Lt] = rng.integers(33, 74, size=(R, Lt))
    if singleton_pos is not None:
        qual[:R, singleton_pos] = 40
    lens = np.where(np.arange(Rp) < R, Lt, 0).astype(np.int32)
    counts = np.asarray(jquality.analyze(jnp.asarray(qual), jnp.asarray(lens)))
    if n_trees < counts.shape[0]:  # merged trees: proportional grouping
        gid = np.arange(counts.shape[0]) * n_trees // counts.shape[0]
        merged = np.zeros((n_trees, 256), np.int64)
        np.add.at(merged, gid, counts)
        counts = merged
    tables = jquality.build_tables(counts, CFG)
    return qual, lens, L, tables


@pytest.mark.parametrize("R,Lt,n_trees,singleton_pos,legacy", [
    (300, 36, 36, 7, False),     # one tree per position, a singleton tree
    (600, 36, 9, None, False),   # merged trees (n_trees < L), dead lanes
    (600, 37, 10, 3, True),      # legacy tail clamp, Lt < L = 40
])
def test_quality_walk_matches_pallas(R, Lt, n_trees, singleton_pos, legacy):
    Rp = 1024
    qual, lens, L, jt = _qual_case(R, Rp, Lt, n_trees, singleton_pos, R + Lt)
    if singleton_pos is not None and n_trees == L:
        assert jt.singletons[singleton_pos] == 40
    if legacy:
        # a v1-v3 stream: position p coded with tree min(p, n_trees - 1),
        # written through per-position copies of those trees
        tid = np.minimum(np.arange(L), n_trees - 1)
        words, sub = _quality_stream(qual, lens, jquality.QualityTables(
            jt.lens[tid], jt.codes[tid], jt.singletons[tid]))
    else:
        words, sub = _quality_stream(qual, lens, jt)
    ref = np.asarray(jquality.decode_device_walk(
        _dense(words, sub), jnp.asarray(lens), _runs(jt.lens, jt.singletons),
        L, Lt, G, BITS, legacy=legacy, interpret=True))
    pt = convert.quality_tables(jt)
    got = quality.decode_walk(_words(words), _t(sub), _t(lens),
                              _t(pt.luts(BITS)), L, Lt, G, BITS,
                              legacy=legacy)
    assert got.dtype == torch.uint8 and got.shape == (Rp, L)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), qual)  # what was encoded


def _dna_case(R, Rp, L, alphabet, seed, keep_rate=0.95):
    rng = np.random.default_rng(seed)
    seq = np.zeros((Rp, L), np.uint8)
    seq[:R] = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), size=(R, L))]
    keep = np.zeros((Rp, L), bool)
    keep[:R] = rng.random((R, L)) < keep_rate
    return seq, keep


def _dna_stream(seq, keep, plan):
    cap = seq.size + 64
    w, sub, total = jdna.encode_device(
        jnp.asarray(seq), jnp.asarray(keep), jnp.asarray(plan.codes_tab),
        jnp.asarray(plan.lens_tab), plan.mode, G, cap, 2, "scatter")
    return np.asarray(w)[: int(total)], np.asarray(sub)


@pytest.mark.parametrize("R,L", [(300, 36), (1000, 76)])
def test_dna_plain_walk_matches_pallas(R, L):
    seq, keep = _dna_case(R, 1024, L, b"ACGT", R)
    plan = jdna.plan(np.asarray(jdna.analyze(jnp.asarray(seq),
                                             jnp.asarray(keep))), CFG)
    assert plan.mode == jdna.MODE_PLAIN
    words, sub = _dna_stream(seq, keep, plan)
    ref = np.asarray(jdna.decode_plain_walk(
        _dense(words, sub), jnp.asarray(keep), L, G, interpret=True))
    got = dna.decode_plain_walk(_words(words), _t(sub), _t(keep), G)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.where(keep, seq, 0))


@pytest.mark.parametrize("alphabet", [b"ACGTN", b"AAAAC", b"GGGG"])
def test_dna_huffman_walk_matches_pallas(alphabet):
    R, L = 500, 36
    seq, keep = _dna_case(R, 1024, L, alphabet, len(alphabet))
    plan = jdna.plan(np.asarray(jdna.analyze(jnp.asarray(seq),
                                             jnp.asarray(keep))), CFG)
    assert plan.mode == jdna.MODE_HUFFMAN
    if alphabet == b"GGGG":
        assert plan.singleton == ord("G")  # zero-bit tree: no cursor moves
    words, sub = _dna_stream(seq, keep, plan)
    ref = np.asarray(jdna.decode_huffman_walk(
        _dense(words, sub), jnp.asarray(keep),
        _runs(plan.lens_tab[None, :], np.array([plan.singleton], np.int32)),
        L, G, BITS, interpret=True))
    lut = convert.dna_plan(plan).luts(BITS)[0]
    got = dna.decode_huffman_walk(_words(words), _t(sub), _t(keep), _t(lut),
                                  G, BITS)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.where(keep, seq, 0))


def _variable_case(R, Rp, Lmax, n_trees, seed, legacy):
    """Variable-length qualities and tables for them: positions grouped
    onto n_trees trees by the v4 proportional map, or by the v1-v3 tail
    clamp min(p, n_trees - 1) when legacy."""
    L = max(4, (Lmax + 3) // 4 * 4)
    rng = np.random.default_rng(seed)
    lens = np.zeros(Rp, np.int32)
    lens[:R] = rng.integers(max(1, Lmax - 9), Lmax + 1, size=R)
    lens[0] = Lmax
    qual = np.where(np.arange(L)[None, :] < lens[:, None],
                    rng.integers(33, 74, size=(Rp, L)), 0).astype(np.uint8)
    counts = np.asarray(jquality.analyze(jnp.asarray(qual), jnp.asarray(lens)))
    if n_trees < counts.shape[0]:
        T0 = counts.shape[0]
        gid = (np.minimum(np.arange(T0), n_trees - 1) if legacy
               else np.arange(T0) * n_trees // T0)
        merged = np.zeros((n_trees, 256), np.int64)
        np.add.at(merged, gid, counts)
        counts = merged
    tables = jquality.build_tables(counts, CFG)
    return qual, lens, L, tables


def _variable_stream(qual, lens, L, jt, legacy, G_):
    """phyngsc_tpu's stream; a v1-v3 stream codes position p with tree
    min(p, n_trees - 1), written through per-position copies of the trees."""
    if legacy:
        tid = np.minimum(np.arange(L), jt.n_trees - 1)
        jt = jquality.QualityTables(jt.lens[tid], jt.codes[tid],
                                    jt.singletons[tid])
    cap = qual.size + 64
    w, sub, total = jquality.encode_device(
        jnp.asarray(qual), jnp.asarray(lens), jnp.asarray(jt.codes),
        jnp.asarray(jt.lens), G_, cap, 2, "scatter")
    return np.asarray(w)[: int(total)], np.asarray(sub)


@pytest.mark.parametrize("R,Lmax,n_trees,legacy,G_", [
    (300, 36, 36, False, G),     # one tree per position
    (600, 37, 9, False, G),      # merged trees, dead lanes
    (500, 38, 10, True, G),      # legacy tail clamp
    (40, 300, 256, False, 8),    # long reads: proportional map onto 256
])
def test_multi_tree_masked_walk_matches_pallas(R, Lmax, n_trees, legacy, G_):
    """K3 with per-position trees, kernel level: the port's plain walk over
    (S, T) slots against unpack_substreams_masked_pallas fed per-step
    tables starts[tid], deltas[tid] (tid = tree of t % L) and the slot
    mask, as decode_device_walk_masked feeds it."""
    Rp = 1024 if R >= 300 else 64
    qual, lens, L, jt = _variable_case(R, Rp, Lmax, n_trees, R + Lmax, legacy)
    words, sub = _variable_stream(qual, lens, L, jt, legacy, G_)
    S, T = Rp // G_, G_ * L
    dense = _dense(words, sub)
    valid = np.arange(L)[None, :] < lens[:, None]
    starts, deltas = _runs(jt.lens, jt.singletons)
    tid = np.asarray(jquality.tree_of_position(
        jnp.arange(T, dtype=jnp.int32) % L, jt.n_trees, L, legacy))
    ref = np.asarray(jbitpack.unpack_substreams_masked_pallas(
        dense, starts[tid], deltas[tid],
        jbitpack.slot_mask(jnp.asarray(valid), G_, dense.shape[1]),
        n_steps=T, lut_bits=BITS, interpret=True))[:S]
    ptid = quality.tree_of_position(torch.arange(L), jt.n_trees, L, legacy)
    got = bitpack.walk_masked_plain(
        _words(words), _t(sub), _t(valid.reshape(S, T)),
        _t(convert.quality_tables(jt).luts(BITS)), ptid, BITS, False)
    assert got.shape == (S, T)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("R,Lmax,n_trees,legacy,G_", [
    (300, 36, 36, False, G),
    (600, 37, 9, False, G),
    (500, 38, 10, True, G),
    (40, 300, 256, False, 64),   # G*L > 16384: the TPU's shared-LUT period path
])
def test_variable_quality_decode_matches(R, Lmax, n_trees, legacy, G_):
    """Model level: quality.decode_walk_masked (K3, per-position trees)
    against phyngsc_tpu's decode_device_walk_masked, and what was encoded."""
    Rp = 1024 if R >= 300 else 64
    qual, lens, L, jt = _variable_case(R, Rp, Lmax, n_trees, R + Lmax + 1,
                                       legacy)
    words, sub = _variable_stream(qual, lens, L, jt, legacy, G_)
    ref = np.asarray(jquality.decode_device_walk_masked(
        _dense(words, sub), jnp.asarray(lens), _runs(jt.lens, jt.singletons),
        L, G_, BITS, legacy=legacy, interpret=True))
    got = quality.decode_walk_masked(
        _words(words), _t(sub), _t(lens),
        _t(convert.quality_tables(jt).luts(BITS)), L, G_, BITS,
        legacy=legacy)
    assert got.dtype == torch.uint8 and got.shape == (Rp, L)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), qual)


def test_walk_reads_past_the_end_as_zero():
    """A corrupt substream table pointing past the words decodes garbage
    but stays in bounds: reads past the end see zero words, exactly as the
    kernel's bounds-checked loads do."""
    words = _words(np.array([0xFFFFFFFF, 0x12345678], np.uint32))
    sub = torch.tensor([1000, 5])  # lane 1 starts far past the end
    luts = torch.arange(1 << 8, dtype=torch.int32)[None, :] | (3 << 9)
    got = bitpack.walk_uniform_plain(words, sub, torch.tensor([8, 8]), luts,
                                     torch.zeros(4, dtype=torch.int32), 8, 2,
                                     4, 4)
    assert got.shape == (4, 4)
    assert int(got[2:].max()) == 0
    keep = torch.ones((2, 8), dtype=torch.bool)
    out = bitpack.walk_masked_plain(words, sub, keep, None, None, 12, True)
    assert int(out[1].max()) == 0
    assert out[0].tolist()[:4] == [3, 3, 3, 3]

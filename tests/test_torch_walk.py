"""K2 / K3: the port's walks (plain versions of csrc/walk.cu) against
phyngsc_tpu's Pallas walks in interpret mode, on streams that phyngsc_tpu's
encoder wrote. Both are fed the same (Wmax, Sp) word plane, the one
phyngsc_tpu's fused decode walks (dense_words_np, subblock.py:1265-1268);
phyngsc_tpu takes the LUT runs its decode builds (subblock.py:1243-1251),
the port host-built LUTs. Exact equality: symbols are bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.models import dna as jdna
from phyngsc_tpu.models import quality as jquality
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu_torch import convert
from phyngsc_tpu_torch.config import CodecConfig as PortConfig
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


def _pt(dense):
    """The same plane as the port's int32 tensor of uint32 bits."""
    return _t(np.asarray(dense, np.uint32).view(np.int32))


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
    dense = _dense(words, sub)
    ref = np.asarray(jquality.decode_device_walk(
        dense, jnp.asarray(lens), _runs(jt.lens, jt.singletons),
        L, Lt, G, BITS, legacy=legacy, interpret=True))
    pt = convert.quality_tables(jt)
    got = quality.decode_walk(_pt(dense), _t(lens), _t(pt.luts(BITS)), L, Lt,
                              G, BITS, legacy=legacy)
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
    dense = _dense(words, sub)
    ref = np.asarray(jdna.decode_plain_walk(
        dense, jnp.asarray(keep), L, G, interpret=True))
    got = dna.decode_plain_walk(_pt(dense), _t(keep), G)
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
    dense = _dense(words, sub)
    ref = np.asarray(jdna.decode_huffman_walk(
        dense, jnp.asarray(keep),
        _runs(plan.lens_tab[None, :], np.array([plan.singleton], np.int32)),
        L, G, BITS, interpret=True))
    lut = convert.dna_plan(plan).luts(BITS)[0]
    got = dna.decode_huffman_walk(_pt(dense), _t(keep), _t(lut), G, BITS)
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
        _pt(dense), _t(valid.reshape(S, T)),
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
    dense = _dense(words, sub)
    ref = np.asarray(jquality.decode_device_walk_masked(
        dense, jnp.asarray(lens), _runs(jt.lens, jt.singletons),
        L, G_, BITS, legacy=legacy, interpret=True))
    got = quality.decode_walk_masked(
        _pt(dense), _t(lens), _t(convert.quality_tables(jt).luts(BITS)), L,
        G_, BITS, legacy=legacy)
    assert got.dtype == torch.uint8 and got.shape == (Rp, L)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), qual)


def test_walk_reads_past_the_end_as_zero():
    """A cursor that runs past the plane's rows (a corrupt stream) decodes
    garbage but stays in bounds: reads past row Wmax see zero words, exactly
    as the kernel's bounds-checked loads do."""
    plane = _t(np.array([[0xFFFFFFFF, 0], [0x12345678, 0]], np.uint32
                        ).view(np.int32))
    luts = torch.arange(1 << 8, dtype=torch.int32)[None, :] | (3 << 9)
    got = bitpack.walk_uniform_plain(plane, torch.tensor([32, 8]), luts,
                                     torch.zeros(4, dtype=torch.int32), 8, 8,
                                     4, 4)
    assert got.shape == (16, 4)
    # lane 0: 96 bits walked, the last 32 of them past the plane's 64
    assert int(got[:8].reshape(-1)[22:].max()) == 0
    assert int(got[8:].max()) == 0  # lane 1 holds zero words
    keep = torch.ones((2, 40), dtype=torch.bool)
    out = bitpack.walk_masked_plain(plane, keep, None, None, 12, True)
    assert out[0].tolist()[:4] == [3, 3, 3, 3]
    assert int(out[0, 32:].max()) == 0 and int(out[1].max()) == 0


def _two_level_trees():
    """Four 12-bit LUTs: codes up to 12 bits (longer than every k below 12),
    a zero-bit singleton tree, a tree of only 12-bit codes (each of its
    8-bit prefixes escapes) and an all-escape tree of random int32 entries,
    a third of them too wide for 15 bits (they send the kernel to the full
    LUT)."""
    from phyngsc_tpu_torch.ops import huffman

    rng = np.random.default_rng(21)
    freqs = np.zeros((3, 256), np.int64)
    freqs[0] = rng.zipf(1.3, size=256) * (rng.random(256) < 0.4)
    freqs[1, 65] = 1000
    freqs[2, :] = 1  # 256 equal symbols: every code is 8 bits ...
    lens = huffman.build_code_lengths_batch(freqs, BITS)
    lens[2, :16] = 12  # ... and 16 of them 12 bits (a Kraft-deficient table)
    sing = np.array([-1, 65, -1], np.int32)
    sym, ln = huffman.decode_lut_batch(lens, BITS, sing)
    luts = (ln.astype(np.int32) << 9) | sym.astype(np.int32)
    garbage = rng.integers(0, 3 << 15, size=(1, 1 << BITS)).astype(np.int32)
    return np.concatenate([luts, garbage])


def _escaped_prefixes(luts, k):
    """Independent count of the prefixes whose entries are not one value
    below 2^15."""
    blocks = luts.reshape(luts.shape[0], 1 << k, -1)
    same = (blocks == blocks[..., :1]).all(-1) & (blocks[..., 0] < 0x8000)
    return int((~same).sum())


@pytest.mark.parametrize("k", [8, 9, 10, 11, 12])
def test_two_level_tables_give_the_full_lut(k):
    """bitpack.two_level_luts at the budget of exactly k primary bits,
    looked up as the kernels do (two_level_entry): every 12-bit window of
    every tree gives the full LUT's entry, whatever bits follow it."""
    luts = _two_level_trees()
    n_trees = luts.shape[0]
    size = (n_trees << k) + (_escaped_prefixes(luts, k) << (BITS - k))
    table, got_k, n_primary = bitpack.two_level_luts(luts, BITS, 2 * size)
    assert (got_k, n_primary) == (k, n_trees << k)
    assert table.dtype == np.uint16 and table.size % 8 == 0
    assert table.size - size < 8
    tree = torch.arange(n_trees)[:, None].expand(n_trees, 1 << BITS)
    full = torch.from_numpy(luts).long()
    for tail in (0, 0xFFFFF, 0x5A5A5):
        win = (torch.arange(1 << BITS)[None, :] << (32 - BITS)) | tail
        got = bitpack.two_level_entry(torch.from_numpy(table.astype(np.int64)),
                                      got_k, n_primary, BITS, full, tree,
                                      win.expand(n_trees, -1))
        assert torch.equal(got, full)
    if k < BITS:  # the all-escape tree escapes at every prefix
        primary = table[:n_primary].reshape(n_trees, 1 << k)
        assert (primary[3] & 0x8000).all()
        assert not (primary[1] & 0x8000).any()  # the singleton never does


def test_two_level_tables_refuse_what_cannot_fit():
    """Tables too large for any primary in shared memory are not refused:
    k = 0 and an empty table, so the kernels read the full LUT alone; and
    the CPU's WalkLuts carry only the full LUT, which the plain walks
    read."""
    luts = np.zeros((300000, 1 << 4), np.int32)
    assert bitpack.two_level_luts(luts, 4, 232448)[1:] == (0, 0)
    assert bitpack.two_level_luts(luts, 4, 232448)[0].size == 0
    wl = bitpack.walk_luts(_two_level_trees(), BITS, "cpu")
    assert wl.n_trees == 4 and wl.lut_bits == BITS
    assert wl.packed is None and wl.full.dtype == torch.int32


L_LONG = 65532  # the longest read length that is a multiple of 4


def _long_read_case(R, seed):
    """R reads of L_LONG skewed qualities (Zipf, drifting along the read)
    and their 256 quality trees (positions grouped by quality.analyze),
    codes of up to 10-11 bits."""
    rng = np.random.default_rng(seed)
    drift = np.arange(L_LONG)[None, :] * 7 // L_LONG
    qual = (33 + np.minimum(rng.zipf(1.5, size=(R, L_LONG)) - 1 + drift,
                            60)).astype(np.uint8)
    lens = torch.full((R,), L_LONG, dtype=torch.int32)
    q = torch.from_numpy(qual)
    tables = quality.build_tables(quality.analyze(q, lens).numpy(),
                                  PortConfig())
    assert tables.n_trees == 256
    return qual, lens, tables


def _prefixes_to_full_lut(table, k, n_primary):
    """Primary prefixes whose secondary block holds only escapes."""
    primary = table[:n_primary].astype(np.int64)
    ids = primary[primary >= 0x8000] - 0x8000
    if ids.size == 0:
        return 0
    d = BITS - k
    blocks = table[n_primary:n_primary + ((int(ids.max()) + 1) << d)]
    return int((blocks.reshape(-1, 1 << d) >= 0x8000).all(1)[ids].sum())


@pytest.mark.parametrize("case", ["256 trees at L=65532", "tight",
                                  "no primary fits"])
def test_two_level_tables_past_shared_memory(case):
    """Where not every escaped prefix finds room for a secondary block (256
    real quality trees beside the tree ids of a 65,532-position K3 block, or
    a tight budget), the rest point at one block of escapes and read the
    full LUT; where no primary fits, k = 0. The lookup equals the full LUT
    for every window and the table stays inside its budget."""
    from phyngsc_tpu_torch import kernels

    if case == "256 trees at L=65532":
        luts = _long_read_case(4, 7)[2].luts(BITS)
        budget = kernels.table_budget(kernels.masked_ids(L_LONG))
    else:
        luts = _two_level_trees()
        # the least any k needs is k = 5: 4 << 5 primaries, one block of 2^7
        budget = (2 * ((4 << 8) + (4 << 4)) if case == "tight"
                  else 2 * ((4 << 5) + (1 << 7)) - 16)
    table, k, n_primary = bitpack.two_level_luts(luts, BITS, budget)
    assert 2 * table.size <= budget
    if case == "no primary fits":
        assert (k, n_primary, table.size) == (0, 0, 0)
    else:
        assert k >= 1 and n_primary == luts.shape[0] << k
        assert _escaped_prefixes(luts, k) > 1
        assert _prefixes_to_full_lut(table, k, n_primary) > 0
    n_trees = luts.shape[0]
    tree = torch.arange(n_trees)[:, None].expand(n_trees, 1 << BITS)
    full = torch.from_numpy(luts).long()
    for tail in (0, 0xFFFFF, 0x5A5A5):
        win = (torch.arange(1 << BITS)[None, :] << (32 - BITS)) | tail
        got = bitpack.two_level_entry(torch.from_numpy(table.astype(np.int64)),
                                      k, n_primary, BITS, full, tree,
                                      win.expand(n_trees, -1))
        assert torch.equal(got, full)


@pytest.mark.parametrize("walk", ["uniform", "masked"])
def test_quality_decode_at_long_L_with_256_trees(walk):
    """A read of 65,532 qualities over 256 trees decodes on the CPU through
    K2's and K3's plain versions to what was encoded (the tables the kernels
    take are built for CUDA tensors alone)."""
    qual, lens, tables = _long_read_case(1, 8)
    w, sub, total = quality.encode_device(
        torch.from_numpy(qual), lens,
        *(torch.from_numpy(t) for t in quality.encode_tables(
            tables.codes, tables.lens, qual.shape[1])), 1, qual.size + 64)
    words = w[: int(total)].to(torch.int32)
    plane = bitpack.dense_words(
        words, torch.from_numpy(bitpack.lane_table(sub.numpy())),
        int(sub.max()) + 1, 128)
    if walk == "uniform":
        got = quality.decode_walk(plane, lens, tables.luts(BITS), L_LONG,
                                  L_LONG, 1, BITS)
    else:
        got = quality.decode_walk_masked(plane, lens, tables.luts(BITS),
                                         L_LONG, 1, BITS)
    np.testing.assert_array_equal(got.numpy(), qual)

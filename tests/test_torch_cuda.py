"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the smoke test does not reach: several position tiles
and out-of-alphabet symbols (K1, K4), pad lanes, empty lanes, streams with
no words and tables pointing past the words (K5), merged and singleton
trees, dead lanes and cursors running past the plane's rows (K2, K3, on the
plane K5 builds), per-position trees over variable lengths (K3), both
branches of the walks' tables (full tables, two-level tables with escapes,
escaped prefixes left to the full LUT, and no tables in shared memory at
all) on corrupt streams, lanes whose slot ranges are not 16-byte aligned,
lanes past 2^16 words, reads of 65,532 positions over 256 trees, and round
trips of every input class. Skipped
without a CUDA device; on the card (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack, bitpack_host, histogram, lookup
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes

pytestmark = pytest.mark.cuda
G = 16
BITS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`)")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.parametrize("R,L,A", [(1, 4, 256), (1030, 37, 128),
                                   (3000, 100, 256), (500, 300, 128)])
def test_histogram_kernel(cuda, R, L, A):
    rng = np.random.default_rng(R + L)
    sym = torch.from_numpy(rng.integers(0, 256, size=(R, L)).astype(np.uint8))
    mask = torch.from_numpy((rng.random((R, L)) < 0.6).astype(np.uint8))
    got = kernels.histogram(sym.to(cuda), mask.to(cuda), A).cpu()
    ref = histogram.position_histogram_plain(sym, mask, A)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("R,L,A,kind", [
    (1, 37, 256, "random"),          # one row: a ragged 37-byte tail only
    (40, 37, 256, "offset"),         # a view 37 bytes into its storage
    (1037, 36, 128, "random"),       # rows off every 16-row run
    (13, 65535, 256, "random"),      # many position slices, unaligned rows
    (3, 65535, 1, "random"),
    (5000, 36, 128, "one"),          # every symbol one value: contention
    (4096, 64, 256, "one"),          # L = 64: a warp's lanes at 4 positions
    (2000, 36, 256, "zero"),         # all-zero mask
    (3000, 37, 1, "random"), (3000, 37, 64, "random"),
    (3000, 37, 128, "bool"), (3000, 37, 256, "bool"),
])
def test_histogram_kernel_edges(cuda, R, L, A, kind):
    """K1 against its plain version: the live-row shapes stage A passes, any
    1 <= A <= 256, a bool mask read in place, unaligned views."""
    rng = np.random.default_rng(R + L + A)
    sym = rng.integers(0, 256, size=(R + 1, L)).astype(np.uint8)
    if kind == "one":
        sym[:] = 65
    mask = rng.random((R + 1, L)) < (0.0 if kind == "zero" else 0.6)
    if kind != "bool":
        mask = mask.astype(np.uint8)
    s, m = torch.from_numpy(sym), torch.from_numpy(mask)
    rows = slice(1, None) if kind == "offset" else slice(0, R)
    before = kernels.LAUNCHES["k1_histogram"]
    got = histogram.position_histogram(s.to(cuda)[rows], m.to(cuda)[rows],
                                       A).cpu()
    assert kernels.LAUNCHES["k1_histogram"] == before + 1
    ref = histogram.position_histogram_plain(s[rows], m[rows], A)
    assert torch.equal(got, ref)
    if kind == "zero":
        assert not got.any()


def _quality_case(R, Rp, Lt, n_trees, seed):
    L = max(4, (Lt + 3) // 4 * 4)
    rng = np.random.default_rng(seed)
    qual = np.zeros((Rp, L), np.uint8)
    qual[:R, :Lt] = rng.integers(33, 74, size=(R, Lt))
    qual[:R, 2] = 40  # a singleton tree
    lens = torch.where(torch.arange(Rp) < R, Lt, 0).to(torch.int32)
    q = torch.from_numpy(qual)
    counts = quality.analyze(q, lens).numpy()
    if n_trees < counts.shape[0]:
        gid = np.arange(counts.shape[0]) * n_trees // counts.shape[0]
        merged = np.zeros((n_trees, 256), np.int64)
        np.add.at(merged, gid, counts)
        counts = merged
    tables = quality.build_tables(counts, CodecConfig())
    w, sub, total = quality.encode_device(
        q, lens, torch.from_numpy(tables.codes.astype(np.int64)),
        torch.from_numpy(tables.lens.astype(np.int64)), G, qual.size + 64)
    words = torch.from_numpy(
        w[: int(total)].numpy().astype(np.uint32).view(np.int32))
    return qual, lens, L, tables, words, sub


def _plane(words, sub, dev):
    """The walk plane on dev: K5 on the card, its plain version on the CPU."""
    Wmax, Sp = bitpack_host.dense_geometry(sub.numpy())
    lanes = torch.from_numpy(bitpack.lane_table(sub.numpy()))
    return bitpack.dense_words(words.to(dev), lanes.to(dev), Wmax, Sp)


@pytest.mark.parametrize("S,max_words,n_short", [
    (1, 40, 0), (37, 300, 0), (130, 40, 0), (2048, 90, 0),
    (37, 0, 0),        # a stream with no words
    (130, 40, 57),     # the table points past the last word
    (3, 70000, 0),     # lanes of up to 70,000 words, past 2^16
    (16384, 12, 0), (131072, 8, 0),  # G = 8 and G = 1 over short reads
])
def test_densify_kernel(cuda, S, max_words, n_short):
    """K5 against dense_words_plain in every cell: pad lanes, empty lanes
    (a third of them), reads past the words give 0; the host's lane starts
    are the table's exclusive prefix sum, as a cumsum on the card gives
    it."""
    rng = np.random.default_rng(S + max_words + n_short)
    sub = rng.integers(0, max_words + 1, size=S).astype(np.int32)
    sub[rng.random(S) < 0.3] = 0
    n = max(int(sub.sum()) - n_short, 0)
    words = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint64
                                          ).astype(np.uint32).view(np.int32))
    Wmax, Sp = bitpack_host.dense_geometry(sub)
    lanes = torch.from_numpy(bitpack.lane_table(sub))
    on_card = torch.from_numpy(sub).to(cuda, torch.int64)
    assert torch.equal(lanes[0],
                       (torch.cumsum(on_card, 0) - on_card).cpu())
    before = kernels.LAUNCHES["k5_densify"]
    got = bitpack.dense_words(words.to(cuda), lanes.to(cuda), Wmax, Sp).cpu()
    assert kernels.LAUNCHES["k5_densify"] == before + 1
    ref = bitpack.dense_words_plain(words, lanes, Wmax, Sp)
    assert got.shape == (Wmax, Sp)
    assert torch.equal(got, ref)


def test_densify_kernel_starts_past_2_31_words(cuda):
    """The kernel's lane starts are 64-bit: past 2^32 words (a corrupt
    table over short words) it reads nothing, as the plain version."""
    lanes = torch.from_numpy(bitpack.lane_table(
        np.array([3, (1 << 31) - 1, (1 << 31) - 1, 2, 4], np.int32)))
    words = torch.arange(11, 21, dtype=torch.int32)
    got = bitpack.dense_words(words.to(cuda), lanes.to(cuda), 256, 128).cpu()
    assert torch.equal(got, bitpack.dense_words_plain(words, lanes, 256, 128))
    assert int(got[:, 2:].abs().sum()) == 0


@pytest.mark.parametrize("R,Lt,n_trees", [(300, 36, 36), (700, 37, 9),
                                          (1024, 76, 76)])
def test_uniform_walk_kernel(cuda, R, Lt, n_trees):
    qual, lens, L, tables, words, sub = _quality_case(R, 1024, Lt, n_trees, R)
    luts = tables.luts(BITS)
    got = quality.decode_walk(_plane(words, sub, cuda), lens.to(cuda),
                              luts, L, Lt, G, BITS).cpu()
    ref = quality.decode_walk(_plane(words, sub, "cpu"), lens, luts, L, Lt, G,
                              BITS)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), qual)


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN", b"TTTT"])
def test_masked_walk_kernel(cuda, alphabet):
    rng = np.random.default_rng(len(alphabet))
    R, Rp, L = 700, 1024, 36
    seq = np.zeros((Rp, L), np.uint8)
    seq[:R] = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), size=(R, L))]
    keep = np.zeros((Rp, L), bool)
    keep[:R] = rng.random((R, L)) < 0.9
    s, k = torch.from_numpy(seq), torch.from_numpy(keep)
    plan = dna.plan(dna.analyze(s, k).numpy(), CodecConfig())
    w, sub, total = dna.encode_device(
        s, k, torch.from_numpy(plan.codes_tab.astype(np.int64)),
        torch.from_numpy(plan.lens_tab.astype(np.int64)), plan.mode, G,
        seq.size + 64)
    words = torch.from_numpy(
        w[: int(total)].numpy().astype(np.uint32).view(np.int32))
    plane, plane_c = _plane(words, sub, cuda), _plane(words, sub, "cpu")
    if plan.mode == dna.MODE_PLAIN:
        got = dna.decode_plain_walk(plane, k.to(cuda), G).cpu()
        ref = dna.decode_plain_walk(plane_c, k, G)
    else:
        lut = plan.luts(BITS)[0]
        got = dna.decode_huffman_walk(plane, k.to(cuda), lut, G, BITS).cpu()
        ref = dna.decode_huffman_walk(plane_c, k, lut, G, BITS)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), np.where(keep, seq, 0))


def test_walks_past_the_end(cuda):
    """Cursors that run past the plane's two rows read zeros, on the card as
    in the plain walks; lane 3 is a pad lane of the plane."""
    plane = torch.tensor([[-1, 0x12345678, 7, 0], [5, -2, 0, 0]],
                         dtype=torch.int32)
    luts = (torch.arange(1 << 8, dtype=torch.int32) | (3 << 9))[None, :]
    tid = torch.zeros(4, dtype=torch.int32)
    totals = torch.tensor([32, 30, 8], dtype=torch.int32)  # 96 bits > 64
    got = bitpack.walk_uniform(plane.to(cuda), totals.to(cuda),
                               bitpack.walk_luts(luts, 8, cuda),
                               tid.to(cuda), 8, 4, 4).cpu()
    ref = bitpack.walk_uniform_plain(plane, totals, luts, tid, 8, 8, 4, 4)
    assert torch.equal(got, ref)
    keep = torch.rand((3, 40), generator=torch.Generator().manual_seed(1)) < 0.7
    trees = torch.tensor([0, 5, -2, 1], dtype=torch.int32)  # clamped ids
    for plain2, lut, tree in ((True, None, None), (False, luts, tid[:1]),
                              (False, luts.repeat(2, 1), trees)):
        bits = 12 if plain2 else 8
        got = bitpack.walk_masked(
            plane.to(cuda), keep.to(cuda),
            None if plain2 else bitpack.walk_luts(lut, bits, cuda),
            None if plain2 else tree.to(cuda), plain2).cpu()
        ref = bitpack.walk_masked_plain(plane, keep, lut, tree, bits, plain2)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("R,L,A", [(1, 1, 64), (1030, 37, 128),
                                   (3000, 100, 256), (500, 1000, 256),
                                   (70000, 36, 64)])
def test_lookup_kernel(cuda, R, L, A):
    """K4: several position tiles (A = 256 stages 48 positions), symbols
    at or above A, row counts off every tile size."""
    rng = np.random.default_rng(R + L + A)
    sym = torch.from_numpy(rng.integers(0, 256, size=(R, L)).astype(np.uint8))
    tab = torch.from_numpy(rng.integers(0, 1 << 16, size=(L, A)).astype(
        np.int32))
    got = lookup.fused_lookup(sym.to(cuda), tab.to(cuda)).cpu()
    ref = lookup.fused_lookup_plain(sym, tab)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("Lmax,n_trees,legacy", [(37, 37, False),
                                                 (100, 13, False),
                                                 (38, 10, True),
                                                 (300, 256, False)])
def test_masked_walk_kernel_per_position_trees(cuda, Lmax, n_trees, legacy):
    """K3's quality variant: variable lengths, tree tree_of_position(t % L)."""
    rng = np.random.default_rng(Lmax + n_trees)
    Rp = 1024
    L = (Lmax + 3) // 4 * 4
    lens = np.zeros(Rp, np.int32)
    lens[:900] = rng.integers(max(1, Lmax - 9), Lmax + 1, size=900)
    valid = np.arange(L)[None, :] < lens[:, None]
    qual = np.where(valid, rng.integers(33, 74, size=(Rp, L)), 0).astype(
        np.uint8)
    q, ln = torch.from_numpy(qual), torch.from_numpy(lens)
    counts = quality.analyze(q, ln).numpy()
    T0 = counts.shape[0]
    gid = (np.minimum(np.arange(T0), n_trees - 1) if legacy
           else np.arange(T0) * n_trees // T0)
    merged = np.zeros((n_trees, 256), np.int64)
    np.add.at(merged, gid, counts)
    tables = quality.build_tables(merged, CodecConfig())
    if legacy:  # a v1-v3 stream: position p coded with tree min(p, n - 1)
        tid = np.minimum(np.arange(L), n_trees - 1)
        enc = quality.QualityTables(tables.lens[tid], tables.codes[tid],
                                    tables.singletons[tid])
    else:
        enc = tables
    w, sub, total = quality.encode_device(
        q, ln, torch.from_numpy(enc.codes.astype(np.int64)),
        torch.from_numpy(enc.lens.astype(np.int64)), G, qual.size + 64)
    words = torch.from_numpy(
        w[: int(total)].numpy().astype(np.uint32).view(np.int32))
    luts = tables.luts(BITS)
    plane = _plane(words, sub, cuda)
    before = kernels.LAUNCHES["k3_walk_masked/quality"]
    got = quality.decode_walk_masked(plane, ln.to(cuda), luts, L, G, BITS,
                                     legacy).cpu()
    assert kernels.LAUNCHES["k3_walk_masked/quality"] == before + 1
    ref = quality.decode_walk_masked(_plane(words, sub, "cpu"), ln, luts, L,
                                     G, BITS, legacy)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), qual)


def _solid(n, seed):
    rng = np.random.default_rng(seed)
    return b"".join(
        b"@s%d\n" % i + b"ACGT"[i % 4:i % 4 + 1]
        + (rng.integers(0, 4, size=49) + ord("0")).astype(np.uint8).tobytes()
        + b"\n+\n" + rng.integers(33, 64, size=50).astype(np.uint8).tobytes()
        + b"\n" for i in range(n))


@pytest.mark.parametrize("case", ["variable", "long", "solid"])
def test_input_classes_on_card_match_cpu(cuda, case):
    cfg = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=16)
    data = {"variable": lambda: synthesize_fastq(2000, read_len=100, seed=4,
                                                 variable_length=True),
            "long": lambda: synthesize_fastq(200, read_len=1000, seed=5),
            "solid": lambda: _solid(3000, 6)}[case]()
    blob = compress_bytes(data, cfg, 2, device=cuda)
    assert blob == compress_bytes(data, cfg, 2, device="cpu")
    assert decompress_bytes(blob, device=cuda) == data


def test_lanes_past_2_16_words_on_card(cuda):
    """A short first read keeps G = 64 under auto_substream, so a lane of
    63 reads of 5,400 bp holds more than 2^16 quality words."""
    rng = np.random.default_rng(71)
    data = b"".join(
        b"@r%d\n%s\n+\n%s\n" % (
            i, np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes(),
            rng.integers(33, 127, n).astype(np.uint8).tobytes())
        for i, n in enumerate([100] + [5400] * 63))
    blob = compress_bytes(data, CodecConfig(), 1, device=cuda)
    assert blob == compress_bytes(data, CodecConfig(), 1, device="cpu")
    before = kernels.LAUNCHES["k5_densify"]
    assert decompress_bytes(blob, device=cuda) == data
    assert kernels.LAUNCHES["k5_densify"] == before + 2


def test_round_trip_on_card_matches_cpu(cuda):
    cfg = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(1500, read_len=36, seed=3, ambiguity_rate=0.01)
    blob = compress_bytes(data, cfg, 2, device=cuda)
    assert blob == compress_bytes(data, cfg, 2, device="cpu")
    assert decompress_bytes(blob, device=cuda) == data


def _walk_luts_case(variant, rng):
    """Host LUTs of each walk variant: for K2 and K3 quality, five trees
    (skewed codes of up to 12 bits, a zero-bit singleton, 256 codes of 8
    bits, and random entries, a third too wide for 15 bits, which send the
    kernel to the full LUT); the first alone for K3 Huffman."""
    from phyngsc_tpu_torch.ops import huffman

    freqs = np.zeros((4, 256), np.int64)
    freqs[0] = rng.zipf(1.3, size=256) * (rng.random(256) < 0.4)
    freqs[1] = rng.zipf(1.6, size=256) * (rng.random(256) < 0.2)
    freqs[2, 65] = 1000
    freqs[3, :] = 1
    sing = np.array([-1, -1, 65, -1], np.int32)
    sym, ln = huffman.decode_lut_batch(
        huffman.build_code_lengths_batch(freqs, BITS), BITS, sing)
    luts = np.concatenate([
        (ln.astype(np.int32) << 9) | sym.astype(np.int32),
        rng.integers(0, 3 << 15, size=(1, 1 << BITS)).astype(np.int32)])
    return luts[:1] if variant == "huffman" else luts


def _whole_size(luts, k):
    """Entries of the two-level tables at k with a block per escaped
    prefix."""
    blocks = luts.reshape(luts.shape[0], 1 << k, -1)
    same = (blocks == blocks[..., :1]).all(-1) & (blocks[..., 0] < 0x8000)
    return (luts.shape[0] << k) + (int((~same).sum()) << (BITS - k))


def _to_full_lut(wl):
    """Primary prefixes of WalkLuts whose secondary block holds only
    escapes."""
    table = wl.packed.cpu().numpy().view(np.uint16).astype(np.int64)
    primary = table[:wl.n_primary]
    ids = primary[primary >= 0x8000] - 0x8000
    if ids.size == 0:
        return 0
    d = BITS - wl.k
    blocks = table[wl.n_primary:wl.n_primary + ((int(ids.max()) + 1) << d)]
    return int((blocks.reshape(-1, 1 << d) >= 0x8000).all(1)[ids].sum())


def _walk_luts(luts, branch, L, cuda):
    """WalkLuts of k = 12 (the tables fit whole), k = 8 (two-level tables
    with escapes: the budget of exactly 8 primary bits), some escaped
    prefixes sent to the full LUT (8 entries short of the least whole
    size), or k = 0 (no budget: no tables in shared memory)."""
    budget = {"fits": kernels.table_budget(kernels.masked_ids(L)),
              "two-level": 2 * _whole_size(luts, 8),
              "shared": 2 * ((min(_whole_size(luts, k) for k in
                                  range(1, BITS + 1)) - 8) & ~7),
              "global": 0}[branch]
    table, k, n_primary = bitpack.two_level_luts(luts, BITS, budget)
    return bitpack.WalkLuts(torch.from_numpy(luts).to(cuda), BITS,
                            torch.from_numpy(table.view(np.int16)).to(cuda),
                            k, n_primary)


@pytest.mark.parametrize("G_,L", [(16, 36), (3, 5)])
@pytest.mark.parametrize("branch", ["fits", "two-level", "shared",
                                    "global"])
@pytest.mark.parametrize("variant", ["k2", "plain2", "huffman", "quality"])
def test_walk_kernels_match_plain(cuda, variant, branch, G_, L):
    """K2 and each K3 variant against their plain versions on a corrupt
    stream (random words, so cursors run past the plane's rows), with a
    third of the lanes dead, keep bytes other than 0 and 1, clamped tree ids
    (K3) and, at G = 3, L = 5, lane ranges of 15 slots, so no lane after
    the first starts on a 16-byte boundary."""
    rng = np.random.default_rng(len(variant) + G_ + (branch == "fits"))
    S, Sp, Wmax = 300, 384, 64
    plane = torch.from_numpy(rng.integers(0, 1 << 32, size=(Wmax, Sp),
                                          dtype=np.uint64).astype(
                                              np.uint32).view(np.int32))
    dead = rng.random(S) < 0.33
    if variant == "plain2":
        wl = None
    else:
        luts = _walk_luts_case(variant, rng)
        wl = _walk_luts(luts, branch, L, cuda)
        if branch == "shared":
            assert wl.k >= 1 and _to_full_lut(wl) > 0
        else:
            assert wl.k == {"fits": BITS, "two-level": 8, "global": 0}[branch]
        full = torch.from_numpy(luts)
    if variant == "k2":
        Lt = L - 1
        totals = torch.from_numpy(np.where(dead, 0, rng.integers(
            1, G_ * Lt + 5, size=S)).astype(np.int32))
        tid = torch.from_numpy(rng.integers(0, luts.shape[0], size=L).astype(
            np.int32))
        got = bitpack.walk_uniform(plane.to(cuda), totals.to(cuda), wl,
                                   tid.to(cuda), G_, Lt, L).cpu()
        ref = bitpack.walk_uniform_plain(plane, totals, full, tid, BITS, G_,
                                         Lt, L)
    else:
        T = G_ * L
        keep = rng.choice(np.array([0, 1, 7], np.uint8), size=(S, T),
                          p=[0.2, 0.7, 0.1])
        keep[dead] = 0
        keep = torch.from_numpy(keep)
        tid = None
        if variant == "huffman":
            tid = torch.zeros(1, dtype=torch.int32)
        elif variant == "quality":
            tid = torch.from_numpy(rng.integers(
                -2, luts.shape[0] + 2, size=L).astype(np.int32))
        got = bitpack.walk_masked(plane.to(cuda), keep.to(cuda), wl,
                                  None if tid is None else tid.to(cuda),
                                  variant == "plain2").cpu()
        ref = bitpack.walk_masked_plain(plane, keep, None if wl is None
                                        else full, tid, BITS,
                                        variant == "plain2")
    assert torch.equal(got, ref)


@pytest.mark.parametrize("variant", ["k2", "plain2"])
def test_walks_past_2_16_words(cuda, variant):
    """Two lanes of 70,000 words each, walked to their ends with fixed 2-bit
    codes (K3 plain2; K2, 1,120 records of 1,000 positions a lane, with a
    one-tree LUT of 2-bit entries): every symbol is the next two bits of
    the lane, past word 2^16 too."""
    rng = np.random.default_rng(72)
    W, S = 70000, 2
    words = rng.integers(0, 1 << 32, size=(W, S), dtype=np.uint64).astype(
        np.uint32)
    shifts = 30 - 2 * (np.arange(16 * W) % 16)
    want = ((words[np.arange(16 * W) // 16].T >> shifts) & 3).astype(np.uint8)
    plane = torch.from_numpy(words.view(np.int32)).to(cuda)
    if variant == "plain2":
        keep = torch.ones((S, 16 * W), dtype=torch.uint8, device=cuda)
        got = bitpack.walk_masked(plane, keep, None, None, True).cpu()
    else:
        idx = np.arange(1 << BITS, dtype=np.int32)
        luts = ((2 << 9) | (idx >> (BITS - 2)))[None, :]
        totals = torch.full((S,), 16 * W, dtype=torch.int32, device=cuda)
        got = bitpack.walk_uniform(
            plane, totals, bitpack.walk_luts(luts, BITS, cuda, 1000),
            torch.zeros(1000, dtype=torch.int32, device=cuda), 16 * W // 1000,
            1000, 1000).cpu().reshape(S, -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("walk", ["uniform", "masked"])
def test_walks_at_long_L_with_256_trees(cuda, walk):
    """130 reads of 65,532 skewed qualities (Zipf, drifting along the read),
    one a lane, over 256 trees: the tables that a K2 or K3 block stages
    beside 65,532 tree ids leave some escaped prefixes to the full LUT. The
    card's decode equals the plain version's and what was encoded."""
    R, L = 130, 65532
    rng = np.random.default_rng(73)
    drift = np.arange(L)[None, :] * 7 // L
    qual = (33 + np.minimum(rng.zipf(1.5, size=(R, L)) - 1 + drift, 60)
            ).astype(np.uint8)
    lens = torch.full((R,), L, dtype=torch.int32)
    q = torch.from_numpy(qual)
    tables = quality.build_tables(quality.analyze(q, lens).numpy(),
                                  CodecConfig())
    assert tables.n_trees == 256
    w, sub, total = quality.encode_device(
        q, lens, torch.from_numpy(tables.codes.astype(np.int64)),
        torch.from_numpy(tables.lens.astype(np.int64)), 1, qual.size + 64)
    words = torch.from_numpy(
        w[: int(total)].numpy().astype(np.uint32).view(np.int32))
    luts = tables.luts(BITS)
    n_ids = L if walk == "uniform" else kernels.masked_ids(L)
    wl = bitpack.walk_luts(luts, BITS, cuda, n_ids)
    assert wl.k >= 1 and _to_full_lut(wl) > 0
    if walk == "uniform":
        def decode(plane, ln):
            return quality.decode_walk(plane, ln, luts, L, L, 1, BITS)
    else:
        def decode(plane, ln):
            return quality.decode_walk_masked(plane, ln, luts, L, 1, BITS)
    got = decode(_plane(words, sub, cuda), lens.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), qual)
    assert torch.equal(got, decode(_plane(words, sub, "cpu"), lens))

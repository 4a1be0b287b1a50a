"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the smoke test does not reach: several position tiles
and out-of-alphabet symbols (K1, K4), spans that wrap several rows, ragged
tails, one tree or ids past the last tree and unaligned symbols (K4), both
launched from several host threads at once (K1, K4), pad lanes, empty
lanes, streams with
no words and tables pointing past the words (K5), merged and singleton
trees, dead lanes and cursors running past the plane's rows (K2, K3, on the
plane K5 builds), per-position trees over variable lengths (K3), both
branches of the walks' tables (full tables, two-level tables with escapes,
escaped prefixes left to the full LUT, and no tables in shared memory at
all) on corrupt streams, lanes whose slot ranges are not 16-byte aligned,
lanes past 2^16 words, reads of 65,532 positions over 256 trees, round
trips of every input class, also at G = 33 over L = 500 (K3), a sharded
round trip on one card named twice, K1, K4 and K5 launched from a thread
that never set its device, make_mesh past the visible cards, two
processes of the multi-process driver on the card, the host<->device
wire (ops/transfer's unpack, the packed decode fetch) on three corpora,
the round trips with the host runtime on one thread and on all, and the
asynchronous execution (device.py): an upload that does not wait for
queued work and whose pinned staging is not handed out again while its
copy is in flight, a fetch that waits on its own producer alone and
releases the GIL while it waits, round trips that make no synchronizing
call (torch.cuda.set_sync_debug_mode("error")), round trips whose task
streams start behind a sleep (any op off its task's stream then races,
and the container would differ from the JAX package's; also at two shards
on two cards), eight threads uploading and fetching at once, a
compress that finds the device memory of its task slots' streams cached,
and K6 (the decode's walk tables from code lengths) against its plain
version on the CPU tests' tree sets, at small budgets, on the goldens'
tables, over both streams of a sub-block in one launch at lut_bits 8-16
and from a fresh thread, with round trips that build no LUT on the host
under the sync-debug mode; the empty kernel of the launch floor; and the
JAX package's fuzz flips decoded on the card as on the CPU.
Skipped without a CUDA device; on the card (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import time

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


def _enc(codes, lens, L):
    """quality.encode_device's tables of (n_trees, A) code tables, on the
    CPU."""
    return tuple(torch.from_numpy(t)
                 for t in quality.encode_tables(codes, lens, L))


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
        q, lens, *_enc(tables.codes, tables.lens, L), G, qual.size + 64)
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
    tab = (None if plan.mode == dna.MODE_PLAIN else torch.from_numpy(
        lookup.fused_table_np(plan.codes_tab[None], plan.lens_tab[None])
        .view(np.int16)))
    w, sub, total = dna.encode_device(s, k, tab, plan.mode, G, seq.size + 64)
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


@pytest.mark.parametrize("R,L,A,T,kind", [
    (1, 1, 64, 1, "random"), (1030, 37, 128, 37, "random"),
    (3000, 100, 256, 100, "random"), (500, 1000, 256, 256, "random"),
    (70000, 36, 64, 36, "random"),
    (4099, 1, 256, 1, "random"),     # L = 1: a span wraps 512 rows
    (1001, 7, 64, 7, "random"), (333, 15, 128, 5, "random"),
    (17, 33, 256, 33, "random"),     # R * L % 16 != 0, no whole span
    (2000, 37, 256, 9, "offset"),    # a view 1 byte into its storage
    (5000, 36, 64, 1, "random"),     # one tree, no ids (the DNA stream)
    (16, 65532, 256, 128, "random"),  # 128 KB-sized table beside 64 KB ids
    (3000, 40, 256, 4, "max"),       # entries at 0xFFFF
    (3000, 40, 64, 4, "ids"),        # ids past the last tree
])
def test_lookup_kernel(cuda, R, L, A, T, kind):
    """K4 against its plain version: any L (spans that wrap several rows, a
    ragged tail), the encode's tree ids, one tree, symbols at or above A,
    unaligned symbols, entries read back as uint16."""
    rng = np.random.default_rng(R + L + A + T)
    sym = torch.from_numpy(rng.integers(0, 256, size=(R, L)).astype(np.uint8))
    tab = rng.integers(0, 1 << 16, size=(T, A))
    if kind == "max":
        tab[:, ::3] = 0xFFFF
    tab = torch.from_numpy(tab.astype(np.uint16).view(np.int16))
    tree = torch.from_numpy(quality.encode_tables(
        np.zeros((T, A), np.int64), np.zeros((T, A), np.int64), L)[1])
    if kind == "ids":
        tree = torch.from_numpy(rng.integers(0, 256, size=L).astype(np.uint8))
    sym_c = sym.to(cuda)
    if kind == "offset":
        buf = torch.empty(R * L + 1, dtype=torch.uint8, device=cuda)
        sym_c = buf[1:].view(R, L)
        sym_c.copy_(sym)
        assert sym_c.data_ptr() % 16
    before = kernels.LAUNCHES["k4_lookup"]
    got = lookup.fused_lookup(sym_c, tab.to(cuda),
                              tree.to(cuda) if T > 1 else None).cpu()
    assert kernels.LAUNCHES["k4_lookup"] == before + 1
    ref = lookup.fused_lookup_plain(sym, tab, tree if T > 1 else None)
    assert torch.equal(got, ref)
    if kind == "max":
        assert (got == 0xFFFF).any()


def test_histogram_and_lookup_from_threads(cuda):
    """K1 and K4 at two read lengths (two shared-memory sizes each) launched
    from eight host threads at once, as compress_bytes' thread pool does:
    each result equals its plain version."""
    from concurrent.futures import ThreadPoolExecutor

    cases = []
    for L, T in ((36, 36), (1000, 256)):
        rng = np.random.default_rng(L)
        sym = torch.from_numpy(rng.integers(0, 256, size=(600, L)).astype(
            np.uint8))
        mask = torch.from_numpy(rng.random((600, L)) < 0.7)
        tab = torch.from_numpy(rng.integers(0, 1 << 16, size=(T, 256)).astype(
            np.uint16).view(np.int16))
        tree = torch.from_numpy(quality.encode_tables(
            np.zeros((T, 256), np.int64), np.zeros((T, 256), np.int64), L)[1])
        cases.append(((sym.to(cuda), mask.to(cuda), tab.to(cuda),
                       tree.to(cuda)),
                      (histogram.position_histogram_plain(sym, mask, 256),
                       lookup.fused_lookup_plain(sym, tab, tree))))

    def run(i):
        (sym, mask, tab, tree), (h_ref, k_ref) = cases[i % 2]
        h = kernels.histogram(sym, mask, 256)
        k = kernels.lookup(sym, tab, tree)
        torch.cuda.current_stream().synchronize()
        return torch.equal(h.cpu(), h_ref) and torch.equal(k.cpu(), k_ref)

    with ThreadPoolExecutor(8) as pool:
        assert all(pool.map(run, range(64)))


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
        q, ln, *_enc(enc.codes, enc.lens, L), G, qual.size + 64)
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


def test_odd_g_on_card_matches_cpu(cuda):
    """G = 33 over variable-length reads bucketed to L = 500, whose qualities
    drift so several trees stay (tests/test_torch_odd_g.py holds the CPU
    side against phyngsc_tpu): the container equals the CPU's, and the card
    decodes it through K3 with per-position trees."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(240):
        m = int(rng.integers(461, 501)) if i else 500
        qual = 33 + np.minimum(np.arange(m) * 40 // m
                               + rng.geometric(0.3, size=m) - 1, 70)
        recs.append(b"@odd.%d\n%s\n+\n%s\n" % (
            i, acgt[rng.integers(0, 4, size=m)].tobytes(),
            qual.astype(np.uint8).tobytes()))
    data = b"".join(recs)
    cfg = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=33,
                      auto_substream=False)
    blob = compress_bytes(data, cfg, 1, device=cuda)
    assert blob == compress_bytes(data, cfg, 1, device="cpu")
    before = kernels.LAUNCHES["k3_walk_masked/quality"]
    assert decompress_bytes(blob, device=cuda) == data
    assert kernels.LAUNCHES["k3_walk_masked/quality"] > before


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
        q, lens, *_enc(tables.codes, tables.lens, L), 1, qual.size + 64)
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


def test_sharded_round_trip_on_card(cuda):
    """data_shards=2 on one card named twice: the 1-shard container (the
    buckets are the same at 2 shards), which the CPU writes too; decoded
    at 2 shards, with every kernel launched once per shard per sub-block
    (K1 and K5 twice)."""
    kw = dict(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(1500, read_len=36, seed=4, ambiguity_rate=0.01)
    one = compress_bytes(data, CodecConfig(**kw), 1, device=cuda)
    two = CodecConfig(data_shards=2, **kw)
    kernels.reset_counts()
    stats = []
    blob = compress_bytes(data, two, 1, device=["cuda:0", "cuda:0"],
                          stats_out=stats)
    assert blob == one
    assert blob == compress_bytes(data, two, 1, device="cpu")
    assert decompress_bytes(blob, two, device=["cuda:0", "cuda:0"]) == data
    n = 2 * stats[0].n_subblocks
    got = dict(kernels.LAUNCHES)
    assert got["k1_histogram"] == got["k5_densify"] == 2 * n
    assert got["k2_walk_uniform"] == got["k3_walk_masked"] == n
    assert got["k4_lookup"] == n + got["k3_walk_masked/huffman"]
    assert not any(kernels.PLAIN_ON_CUDA.values())


def test_kernels_from_a_fresh_thread(cuda):
    """K1, K4 and K5 launched from a thread that never set its current
    device, on the last card (the launch makes the tensors' device
    current): each equals its plain version."""
    import threading

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(7)
    sym = torch.from_numpy(rng.integers(0, 256, size=(700, 37)).astype(
        np.uint8))
    mask = torch.from_numpy(rng.random((700, 37)) < 0.7)
    tab = torch.from_numpy(rng.integers(0, 1 << 16, size=(37, 256)).astype(
        np.uint16).view(np.int16))
    tree = torch.from_numpy(quality.encode_tables(
        np.zeros((37, 256), np.int64), np.zeros((37, 256), np.int64), 37)[1])
    sub = rng.integers(0, 40, size=300).astype(np.int32)
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                          size=int(sub.sum()) + 5).astype(
        np.int32))
    lanes = torch.from_numpy(bitpack.lane_table(sub))
    Wmax, Sp = bitpack_host.dense_geometry(sub)
    refs = (histogram.position_histogram_plain(sym, mask, 256),
            lookup.fused_lookup_plain(sym, tab, tree),
            bitpack.dense_words_plain(words, lanes, Wmax, Sp))
    out = {}

    def run():
        got = (kernels.histogram(sym.to(dev), mask.to(dev), 256),
               kernels.lookup(sym.to(dev), tab.to(dev), tree.to(dev)),
               kernels.densify(words.to(dev), lanes.to(dev), Wmax, Sp))
        torch.cuda.synchronize(dev)
        out["got"] = [g.cpu() for g in got]

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert all(torch.equal(g, r) for g, r in zip(out["got"], refs))


def test_make_mesh_needs_the_cards(cuda):
    from phyngsc_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    assert make_mesh(n).shape == (n, 1)
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(n + 1)
    data = synthesize_fastq(50, read_len=36, seed=5)
    with pytest.raises(ValueError, match="devices"):
        compress_bytes(data, CodecConfig(data_shards=n + 1), 1, device="cuda")


def _distributed(n, *args):
    """python -m phyngsc_tpu_torch.parallel.distributed as n processes on
    the cards (process r on cuda:{r % device_count}); all must exit 0."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "phyngsc_tpu_torch.parallel.distributed",
         "--coordinator", coord, "--num-processes", str(n), "--process-id",
         str(i), "--device", "cuda", *args], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), stderr=subprocess.PIPE)
        for i in range(n)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs


@pytest.mark.parametrize("per_card", [False, True])
def test_processes_on_the_cards(cuda, tmp_path, per_card):
    """Two processes on the card (gloo metadata), or one process per card:
    the container is the single-process one with as many writers, and the
    multi-process decode writes the input back."""
    n = torch.cuda.device_count() if per_card else 2
    if per_card and n < 2:
        pytest.skip("one card: a process per card is the single process")
    data = synthesize_fastq(3000, read_len=36, seed=6, ambiguity_rate=0.01)
    src, out, back = (tmp_path / "in.fastq", tmp_path / "o.ngsct",
                      tmp_path / "back.fastq")
    src.write_bytes(data)
    _distributed(n, str(src), str(out))
    assert out.read_bytes() == compress_bytes(data, CodecConfig(), n,
                                              device=cuda)
    _distributed(n, "--decompress", str(out), str(back))
    assert back.read_bytes() == data


def test_sharded_over_every_card(cuda):
    """data_shards = the card count on device="cuda" (cards 0..n-1): the
    1-shard container at 2 and 4 shards (the JAX package's at the same
    count otherwise), decoded at n shards; the counts of K1 are summed on
    card 0."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    kw = dict(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(3000, read_len=100, seed=8, variable_length=True)
    cfg = CodecConfig(data_shards=n, **kw)
    blob = compress_bytes(data, cfg, 2, device="cuda")
    assert blob == compress_bytes(data, cfg, 2, device="cpu")
    if n in (2, 4):
        assert blob == compress_bytes(data, CodecConfig(**kw), 2,
                                      device=cuda)
    assert decompress_bytes(blob, cfg, device="cuda") == data


def _srr_n(n, seed):
    """SRR-style 76 bp reads whose leading N keeps a quality outside
    [33, 40]: the N stays in the DNA stream, which is Huffman-coded."""
    lines = synthesize_fastq(n, read_len=76, style="SRR",
                             seed=seed).split(b"\n")
    for i in range(1, len(lines) - 1, 4):
        if lines[i][:1] == b"N":
            lines[i + 2] = b"B" + lines[i + 2][1:]
    return b"\n".join(lines)


def _dense_iupac(n, seed):
    """36 bp reads, 60% of their bases IUPAC codes, qualities in [33, 40]."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNYRWSKMDVHB", np.uint8)
    probs = np.full(15, 0.6 / 11)
    probs[:4] = 0.4 / 4
    return b"".join(
        b"@ex%d\n%s\n+\n%s\n" % (
            i, rng.choice(alphabet, size=36, p=probs).tobytes(),
            rng.integers(33, 41, size=36).astype(np.uint8).tobytes())
        for i in range(n))


WIRE = {"ERR": lambda: synthesize_fastq(4000, read_len=36, seed=9),
        "SRR-N": lambda: _srr_n(2000, 10),
        "dense IUPAC": lambda: _dense_iupac(2000, 11)}


def _payloads(blob):
    from phyngsc_tpu_torch.container import block as blockmod
    from phyngsc_tpu_torch.container import footer as footermod

    foot = footermod.read_footer(blob)
    offs = np.concatenate([[0], np.cumsum(foot.block_sizes_in_file_order())])
    blocks = ((w, blob[offs[i]:offs[i + 1]]) for i, w in enumerate(foot.cbo))
    return [p for _, p in blockmod.iter_subblocks(blocks)]


@pytest.mark.parametrize("corpus", list(WIRE))
def test_wire_on_card_matches_cpu(cuda, corpus):
    """ops/transfer's unpack of each plane's packed words, and each
    sub-block's packed decode fetch (the words stage A of the decode leaves
    for the fetch, and how they are packed), equal the CPU's on the card."""
    from phyngsc_tpu_torch.ops import transfer
    from phyngsc_tpu_torch.pipeline import subblock
    from phyngsc_tpu_torch.utils.fastq import index_records

    data = WIRE[corpus]()
    buf = np.frombuffer(data, np.uint8)
    idx = index_records(buf)
    lens = idx.seq_len.astype(np.int64)
    R, L = lens.shape[0], int(lens.max())
    modes = []
    for start, pack, unpack in (
            (idx.seq_start, transfer.pack_seq_np, transfer.unpack_seq),
            (idx.qual_start, transfer.pack_qual_np, transfer.unpack_qual)):
        mode, words = pack(subblock._gather_matrix(buf, start, lens, L))
        modes.append(mode)
        w = torch.from_numpy(words.view(np.int32))
        assert torch.equal(unpack(w.to(cuda), mode, R, L).cpu(),
                           unpack(w, mode, R, L))
    assert modes[0] == {"ERR": transfer.SEQ_2BIT_EXC,
                        "SRR-N": transfer.SEQ_2BIT_EXC,
                        "dense IUPAC": transfer.SEQ_RAW}[corpus]
    cfg = CodecConfig(subblock_input_bytes=64 << 10,
                      records_per_substream=16)
    blob = compress_bytes(data, cfg, 1, device="cpu")
    assert compress_bytes(data, cfg, 1, device=cuda) == blob
    for payload in _payloads(blob):
        on_card = subblock.decode_stage_a(payload, cfg, cuda)
        on_cpu = subblock.decode_stage_a(payload, cfg, torch.device("cpu"))
        meta, want = on_card.out_meta, on_cpu.out_meta
        assert meta is not None and want is not None
        assert (meta.w, meta.q6, meta.qual8) == (want.w, want.q6, want.qual8)
        np.testing.assert_array_equal(on_card.blobs[0].result(),
                                      on_cpu.blobs[0].result())
    assert decompress_bytes(blob, cfg, device=cuda) == data


@pytest.mark.parametrize("corpus", ["ERR005195", "variable-length"])
def test_round_trips_at_one_host_thread_and_all(cuda, corpus):
    """The host runtime at T = 1 and at T = the CPUs the process may use:
    the same container (the CPU's) and the same bytes back, on the card."""
    from phyngsc_tpu_torch.utils import native

    data = (synthesize_fastq(100000, read_len=36, seed=21)
            if corpus == "ERR005195" else
            synthesize_fastq(40000, read_len=100, seed=22,
                             variable_length=True))
    blobs = {}
    try:
        for t in (1, 0):
            T = native.set_threads(t)
            blobs[T] = compress_bytes(data, None, 1, device=cuda)
            assert decompress_bytes(blobs[T], device=cuda) == data
    finally:
        native.set_threads(0)
    assert len(blobs) == 2 or native.threads() == 1
    assert len(set(blobs.values())) == 1
    assert blobs[1] == compress_bytes(data, None, 1, device="cpu")


#: cycles of torch.cuda._sleep that take tens of milliseconds on an H100
SLEEP_CYCLES = 100_000_000


def _slept_ms(stream) -> float:
    """Queue SLEEP_CYCLES of sleep on `stream`; returns after the launch,
    with the sleep's device ms measured by events (synchronizes)."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record(stream)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)
    t1.record(stream)
    t1.synchronize()
    return t0.elapsed_time(t1)


def test_upload_does_not_wait(cuda):
    """upload returns while a sleep runs ahead of its copy on its own
    stream and on another; the pinned staging of a copy in flight is not
    handed out again (a second upload of the same size, made at once, gets
    other memory); both arrive intact."""
    from phyngsc_tpu_torch.device import task_streams, upload

    (stream,), other = task_streams([cuda]), torch.cuda.Stream(cuda)
    sleep_ms = _slept_ms(stream)
    assert sleep_ms > 20
    rng = np.random.default_rng(11)
    first = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in
             (1 << 20, 37, 4096)]
    second = [rng.integers(0, 256, size=a.shape, dtype=np.uint8)
              for a in first]
    with torch.cuda.stream(stream):
        upload(second, cuda)  # the staging block exists: no cudaHostAlloc
        torch.cuda.synchronize()
        with torch.cuda.stream(other):
            torch.cuda._sleep(SLEEP_CYCLES)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        got = upload(first, cuda)
        ms = (time.perf_counter() - t0) * 1e3
        again = upload(second, cuda)
    assert ms < 5, f"upload took {ms:.2f} ms behind a {sleep_ms:.1f} ms sleep"
    torch.cuda.synchronize()
    for a, t in zip(first + second, got + again):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_fetch_waits_on_its_own_producer(cuda):
    """Pending.result() returns while a sleep still runs on another task's
    stream, with the right bytes; and while it waits behind a sleep of its
    own, another thread runs Python (the wait releases the GIL)."""
    import threading

    from phyngsc_tpu_torch.device import fetch_async, task_streams

    (mine,), (theirs,) = task_streams([cuda], 0), task_streams([cuda], 1)
    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(theirs):
        torch.cuda._sleep(4 * SLEEP_CYCLES)
        other_done = torch.cuda.Event()
        other_done.record(theirs)
    with torch.cuda.stream(mine):
        p = fetch_async(x * 3)
    t0 = time.perf_counter()
    got = p.result()
    ms = (time.perf_counter() - t0) * 1e3
    assert not other_done.query(), f"the fetch waited {ms:.1f} ms"
    np.testing.assert_array_equal(got, np.arange(1 << 20, dtype=np.int32) * 3)

    with torch.cuda.stream(mine):
        torch.cuda._sleep(2 * SLEEP_CYCLES)
        p = fetch_async(x)
    started, waited = threading.Event(), threading.Event()

    def wait():
        started.set()
        p.result()
        waited.set()

    t = threading.Thread(target=wait)
    t.start()
    started.wait(timeout=30)
    ticks = 0
    while not waited.is_set():  # runs only while the waiter has no GIL
        ticks += 1
    t.join(timeout=30)
    assert not t.is_alive() and ticks > 1000


def _err_and_variable():
    return {"ERR005195": (synthesize_fastq(60000, read_len=36, seed=23,
                                           ambiguity_rate=0.002), None),
            "variable-length": (synthesize_fastq(
                20000, read_len=100, seed=24, variable_length=True), None),
            "2 shards": (synthesize_fastq(30000, read_len=36, seed=25),
                         CodecConfig(data_shards=2))}


#: a case of the 2-shard corpus run on two cards: the shards' task streams
#: are on different devices, and the copies between them (the counts
#: summed on the first card) are ordered on both
TWO_CARDS = {"2 shards on 2 cards": "2 shards"}


def _shard_devices(cuda, corpus, n_shards):
    """The devices of a case: one card (named once a shard), or cards
    0 and 1 for a TWO_CARDS case (skipped on one card)."""
    if corpus not in TWO_CARDS:
        return cuda if n_shards == 1 else [cuda] * n_shards
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("corpus", ["ERR005195", "variable-length",
                                    "2 shards", "2 shards on 2 cards"])
def test_round_trip_makes_no_synchronizing_call(cuda, corpus):
    """compress_bytes -> decompress_bytes under
    torch.cuda.set_sync_debug_mode("error"): no blocking copy, .item(),
    nonzero or stream / device synchronize on any thread (the fetches wait
    on events, which the mode does not flag); the CPU's container and the
    input back."""
    data, cfg = _err_and_variable()[TWO_CARDS.get(corpus, corpus)]
    device = _shard_devices(cuda, corpus, 1 if cfg is None else 2)
    want = compress_bytes(data, cfg, 1, device="cpu")
    assert compress_bytes(data, cfg, 1, device=device) == want  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blob = compress_bytes(data, cfg, 1, device=device)
        back = decompress_bytes(blob, cfg, device=device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert blob == want and back == data


@pytest.mark.parametrize("corpus", ["ERR005195", "variable-length",
                                    "2 shards", "2 shards on 2 cards"])
def test_round_trips_with_delayed_task_streams(cuda, monkeypatch, corpus):
    """The drivers' ring queues a sleep on each task's streams, and on the
    legacy default stream of each of their devices, as it hands them out:
    a device op of a task issued off its task's stream would then race
    with the task's own work. The containers keep the JAX package's
    SHA-256 (tests/torch_race_corpora.py) and the input comes back."""
    import hashlib

    from phyngsc_tpu_torch.device import StreamRing
    from torch_race_corpora import CORPORA, SHA256, config

    take = StreamRing.take

    def delayed(self):
        streams = take(self)
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(SLEEP_CYCLES // 20)
            with torch.cuda.stream(torch.cuda.default_stream(s.device)):
                torch.cuda._sleep(SLEEP_CYCLES // 40)
        return streams

    monkeypatch.setattr(StreamRing, "take", delayed)
    name = TWO_CARDS.get(corpus, corpus)
    data, cfg = CORPORA[name][0](), config(name)
    device = _shard_devices(cuda, corpus, cfg.data_shards)
    blob = compress_bytes(data, cfg, 1, device=device)
    assert hashlib.sha256(blob).hexdigest() == SHA256[name]
    assert decompress_bytes(blob, cfg, device=device) == data


def test_threads_upload_and_fetch_through_the_pinned_pool(cuda):
    """Eight threads, each on its own task stream behind short sleeps,
    upload and fetch random arrays of every size class through the pinned
    staging pool: every array comes back equal."""
    import threading

    from phyngsc_tpu_torch.device import (fetch_async, task_streams, upload,
                                          use_streams)

    errors, done = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        streams = task_streams([cuda], seed)
        try:
            with use_streams(streams):
                for _ in range(30):
                    n = int(rng.choice([0, 1, 37, 4096, 1 << 20]))
                    arrays = [rng.integers(0, 256, size=n, dtype=np.uint8),
                              rng.integers(-9, 9, size=n % 1000)]
                    torch.cuda._sleep(int(rng.integers(0, SLEEP_CYCLES // 50)))
                    pending = [fetch_async(t + 0) for t in upload(arrays,
                                                                  cuda)]
                    for a, p in zip(arrays, pending):
                        if not np.array_equal(p.result(), a):
                            errors.append(seed)
            done.append(seed)
        except Exception as e:  # reported below, with the seed
            errors.append((seed, repr(e)))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and sorted(done) == list(range(8))


def test_task_slots_reuse_device_memory(cuda, monkeypatch):
    """A compress after two others makes no cudaMalloc: the task slots'
    streams are the same all through the process, and the caching
    allocator finds the memory it keeps for each. Fresh streams for every
    call (task_streams with no slot made yet) find none and allocate
    anew, which is why the slots are kept."""
    from phyngsc_tpu_torch import device as devmod

    data = synthesize_fastq(60000, read_len=36, seed=23,
                            ambiguity_rate=0.002)
    cfg = CodecConfig(subblock_input_bytes=256 << 10)

    def allocs():
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats(cuda)["num_device_alloc"]
        compress_bytes(data, cfg, 1, device=cuda)
        torch.cuda.synchronize()
        return torch.cuda.memory_stats(cuda)["num_device_alloc"] - before

    allocs(), allocs()
    kept = allocs()
    monkeypatch.setattr(devmod, "_SLOTS", {})
    fresh = allocs()
    print(f"cudaMalloc calls of one compress: kept slots {kept}, fresh "
          f"streams {fresh}")
    assert kept == 0 < fresh


def _k6_case(cuda, lens, sing, bits, budget):
    """K6 on the card against its plain version on the CPU for one tree
    set and two-level budget: the full LUTs and the two-level table."""
    from phyngsc_tpu_torch.ops import tables

    T = lens.shape[0]
    words = torch.from_numpy(bitpack_host.pack_lens4_np(lens, sing).view(
        np.int32))
    lay = tables.two_level_layout(lens, sing, bits, budget)
    rows = torch.from_numpy(lay.trees)
    before = kernels.LAUNCHES["k6_tables"]
    ((full, packed),) = kernels.decode_tables(bits, [(
        words.to(cuda), T, rows.to(cuda) if lay.k else None, lay.k, lay.own,
        lay.n_blocks, lay.n)])
    assert kernels.LAUNCHES["k6_tables"] == before + 1
    want = tables.luts_from_lens_plain(words, words[T * 32:], T, 1 << bits)
    assert torch.equal(full.cpu(), want)
    assert torch.equal(packed.cpu(),
                       tables.two_level_plain(want, rows, lay, bits))
    return lay


@pytest.mark.parametrize("kind", ["zipf", "incomplete", "all 256",
                                  "long codes"])
@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("n_ids,T", [(1, 1), (36, 36),
                                     (kernels.masked_ids(100), 100),
                                     (kernels.masked_ids(1000), 128)])
def test_tables_kernel_matches_plain(cuda, n_ids, T, bits, kind):
    """K6 on the CPU tests' tree sets (tests/torch_table_cases.py) at the
    walks' budgets, with their full LUTs and two-level tables exact."""
    from torch_table_cases import trees

    lens, sing = trees(T, bits, kind, seed=T * 31 + bits)
    _k6_case(cuda, lens, sing, bits, kernels.table_budget(n_ids))


def test_tables_kernel_small_budgets(cuda):
    """K6 where the budget leaves a block for every escaped prefix, some
    prefixes to the shared block, or no table (k = 0)."""
    from torch_table_cases import SMALL_BUDGETS, trees

    seen = set()
    for kind in ("zipf", "long codes"):
        lens, sing = trees(36, BITS, kind, seed=43)
        for budget in SMALL_BUDGETS:
            lay = _k6_case(cuda, lens, sing, BITS, budget)
            seen.add("none" if lay.k == 0 else "shared"
                     if lay.n_blocks > lay.own else "own")
    assert seen == {"own", "shared", "none"}


def test_tables_kernel_on_the_goldens(cuda):
    """K6 on the quality and DNA tables of every sub-block of the four
    golden containers, as the decode sizes them (subblock.decode_wires)."""
    import os

    from phyngsc_tpu_torch.container import block as blockmod
    from phyngsc_tpu_torch.container import footer as footermod
    from phyngsc_tpu_torch.pipeline import subblock

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
    n = 0
    for name in ("tiny_v1", "tiny_v2", "titles_v3", "longread_v4"):
        with open(os.path.join(golden, f"{name}.ngsct"), "rb") as f:
            blob = f.read()
        foot = footermod.read_footer(blob)
        cfg = CodecConfig(records_per_substream=foot.records_per_substream)
        offs = np.concatenate([[0], np.cumsum(
            foot.block_sizes_in_file_order())])
        blocks = ((w, blob[offs[i]:offs[i + 1]])
                  for i, w in enumerate(foot.cbo))
        for _, payload in blockmod.iter_subblocks(blocks):
            p = subblock._decode_parse(payload, cfg)
            for wire in subblock.decode_wires(p, cfg):
                if wire is None:
                    continue
                lens = np.zeros((wire.n_trees, 256), np.uint8)
                sing = wire.words.view(np.int32)[wire.n_trees * 32:]
                w = wire.words.view(np.uint32)[:wire.n_trees * 32]
                for j in range(8):  # the nibbles back to lengths
                    lens[:, j::8] = (w.reshape(wire.n_trees, 32)
                                     >> (28 - 4 * j)) & 0xF
                budget = kernels.table_budget(
                    kernels.masked_ids(p.L) if p.variable else max(p.Lt, 1))
                lay = _k6_case(cuda, lens, sing, wire.lut_bits, budget)
                assert (lay.k, lay.n) == (wire.layout.k, wire.layout.n)
                n += 1
    assert n >= 8


def _two_stream_case(cuda, case, bits):
    """walk_luts_both on the card, one K6 launch over both streams' trees,
    against each stream's plain version on the CPU."""
    from phyngsc_tpu_torch.ops import tables
    from torch_table_cases import two_streams

    q, d = two_streams(*case, bits)
    on_card = [None if x is None else (x[0], x[1].to(cuda), x[2].to(cuda))
               for x in (q, d)]
    before = kernels.LAUNCHES["k6_tables"]
    got = tables.walk_luts_both(*on_card)
    assert kernels.LAUNCHES["k6_tables"] == before + 1
    assert (got[1] is None) == (d is None)
    for pieces, wl in zip((q, d), got):
        if pieces is None:
            continue
        want = tables.walk_luts_plain(*pieces)
        assert torch.equal(wl.full.cpu(), want.full)
        assert torch.equal(wl.packed.cpu(), want.packed)
        assert (wl.k, wl.n_primary, wl.lut_bits) == (want.k, want.n_primary,
                                                     bits)
    return q[0].layout


def _two_stream_params():
    from torch_table_cases import TWO_STREAM_BITS, TWO_STREAMS

    return [(c, b) for c in TWO_STREAMS for b in TWO_STREAM_BITS]


@pytest.mark.parametrize("case,bits", _two_stream_params())
def test_tables_kernel_two_streams(cuda, case, bits):
    """K6 over a sub-block's quality and Huffman-DNA trees in one launch
    (or the quality trees alone, plain DNA) at lut_bits 8-16: ERR's 36
    trees, 128 trees, the 65,532 bp reads' shared block of escapes, one
    tree; each stream equal to its plain version."""
    lay = _two_stream_case(cuda, case, bits)
    if case[:2] == (128, "long codes") and bits == 12:
        assert lay.k > 0 and lay.n_blocks > lay.own


def test_empty_launch(cuda):
    """The empty kernel (chip_smoke's launch floor) launches at 1 and 132
    blocks, and counts as no kernel of the path."""
    before = dict(kernels.LAUNCHES)
    for blocks in (1, 132):
        kernels.empty_launch(cuda, blocks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before


def test_fuzz_flips_on_card(cuda):
    """tests/test_fuzz.py's 120 bit flips (torch_fuzz_cases) decoded on the
    card: each flip gives the CPU's outcome, the input back or the same
    designed rejection (ValueError / EOFError), never a fault; then a clean
    ERR round trip in the same process (a kernel fault would have poisoned
    its CUDA context)."""
    from torch_fuzz_cases import CFG, bitflip_corpus, flips, outcome

    rng, data = bitflip_corpus()
    blob = compress_bytes(data, CFG, 2, device="cpu")
    seen = []
    for _, _, mutated in flips(rng, blob):
        here = outcome(lambda b: decompress_bytes(b, device="cpu"), mutated,
                       data)
        there = outcome(lambda b: decompress_bytes(b, device=cuda), mutated,
                        data)
        assert there == here
        seen.append(there)
    torch.cuda.synchronize()
    assert set(seen) - {"ok"}
    err = synthesize_fastq(20000, read_len=36, seed=23, ambiguity_rate=0.002)
    assert decompress_bytes(compress_bytes(err, None, 1, device=cuda),
                            device=cuda) == err


@pytest.mark.parametrize("corpus", ["ERR005195", "2 shards"])
def test_round_trip_builds_no_host_lut_under_sync_debug(cuda, monkeypatch,
                                                        corpus):
    """With QualityTables.luts, DnaPlan.luts and bitpack.walk_tables
    raising, the round trip runs under set_sync_debug_mode("error") (no
    device -> host copy to pick the tables' k), gives the CPU's container
    and the input back, and launches K6 once per sub-block and shard."""
    data, cfg = _err_and_variable()[corpus]
    device = cuda if cfg is None else [cuda, cuda]
    want = compress_bytes(data, cfg, 1, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a decode path built a LUT on the host")

    monkeypatch.setattr(quality.QualityTables, "luts", refuse)
    monkeypatch.setattr(dna.DnaPlan, "luts", refuse)
    monkeypatch.setattr(bitpack, "walk_tables", refuse)
    assert decompress_bytes(want, cfg, device=device) == data  # warm
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blob = compress_bytes(data, cfg, 1, device=device)
        back = decompress_bytes(blob, cfg, device=device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert blob == want and back == data
    launches = dict(kernels.LAUNCHES)
    assert launches["k6_tables"] == launches["k2_walk_uniform"] > 0
    assert not any(kernels.PLAIN_ON_CUDA.values())


def test_tables_kernel_from_a_fresh_thread(cuda):
    """K6 launched from a thread that never set its current device, on the
    last card: equal to its plain version."""
    import threading

    from torch_table_cases import trees

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    lens, sing = trees(36, BITS, "zipf", seed=9)
    out = {}

    def run():
        out["lay"] = _k6_case(dev, lens, sing, BITS, kernels.table_budget(36))
        torch.cuda.synchronize(dev)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and out["lay"].k > 0

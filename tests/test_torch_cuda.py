"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the smoke test does not reach: several position tiles
and out-of-alphabet symbols (K1, K4), merged and singleton trees, dead lanes
and starts past the end of the words (K2, K3), per-position trees over
variable lengths (K3), and round trips of every input class. Skipped
without a CUDA device; on the card (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack, histogram, lookup
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


@pytest.mark.parametrize("R,Lt,n_trees", [(300, 36, 36), (700, 37, 9),
                                          (1024, 76, 76)])
def test_uniform_walk_kernel(cuda, R, Lt, n_trees):
    qual, lens, L, tables, words, sub = _quality_case(R, 1024, Lt, n_trees, R)
    luts = torch.from_numpy(tables.luts(BITS))
    got = quality.decode_walk(words.to(cuda), sub.to(cuda), lens.to(cuda),
                              luts.to(cuda), L, Lt, G, BITS).cpu()
    ref = quality.decode_walk(words, sub, lens, luts, L, Lt, G, BITS)
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
    if plan.mode == dna.MODE_PLAIN:
        got = dna.decode_plain_walk(words.to(cuda), sub.to(cuda), k.to(cuda),
                                    G).cpu()
        ref = dna.decode_plain_walk(words, sub, k, G)
    else:
        lut = torch.from_numpy(plan.luts(BITS)[0])
        got = dna.decode_huffman_walk(words.to(cuda), sub.to(cuda),
                                      k.to(cuda), lut.to(cuda), G, BITS).cpu()
        ref = dna.decode_huffman_walk(words, sub, k, lut, G, BITS)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), np.where(keep, seq, 0))


def test_walks_past_the_end(cuda):
    words = torch.tensor([-1, 0x12345678, 7], dtype=torch.int32)
    sub = torch.tensor([1000, 5, 2])  # lanes 1, 2 start past the end
    luts = (torch.arange(1 << 8, dtype=torch.int32) | (3 << 9))[None, :]
    tid = torch.zeros(4, dtype=torch.int32)
    totals = torch.tensor([8, 8, 8], dtype=torch.int32)
    got = bitpack.walk_uniform(words.to(cuda), sub.to(cuda), totals.to(cuda),
                               luts.to(cuda), tid.to(cuda), 8, 2, 4, 4).cpu()
    ref = bitpack.walk_uniform_plain(words, sub, totals, luts, tid, 8, 2, 4, 4)
    assert torch.equal(got, ref)
    keep = torch.rand((3, 40), generator=torch.Generator().manual_seed(1)) < 0.7
    trees = torch.tensor([0, 5, -2, 1], dtype=torch.int32)  # clamped ids
    for plain2, lut, tree in ((True, None, None), (False, luts, tid[:1]),
                              (False, luts.repeat(2, 1), trees)):
        bits = 12 if plain2 else 8
        got = bitpack.walk_masked(
            words.to(cuda), sub.to(cuda), keep.to(cuda),
            None if plain2 else lut.to(cuda),
            None if plain2 else tree.to(cuda), bits, plain2).cpu()
        ref = bitpack.walk_masked_plain(words, sub, keep, lut, tree, bits,
                                        plain2)
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
    luts = torch.from_numpy(tables.luts(BITS))
    before = kernels.LAUNCHES["k3_walk_masked/quality"]
    got = quality.decode_walk_masked(words.to(cuda), sub.to(cuda),
                                     ln.to(cuda), luts.to(cuda), L, G, BITS,
                                     legacy).cpu()
    assert kernels.LAUNCHES["k3_walk_masked/quality"] == before + 1
    ref = quality.decode_walk_masked(words, sub, ln, luts, L, G, BITS, legacy)
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


def test_round_trip_on_card_matches_cpu(cuda):
    cfg = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(1500, read_len=36, seed=3, ambiguity_rate=0.01)
    blob = compress_bytes(data, cfg, 2, device=cuda)
    assert blob == compress_bytes(data, cfg, 2, device="cpu")
    assert decompress_bytes(blob, device=cuda) == data

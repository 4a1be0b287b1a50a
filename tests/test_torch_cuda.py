"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the smoke test does not reach: several position tiles
and out-of-alphabet symbols (K1), merged and singleton trees, dead lanes and
starts past the end of the words (K2, K3). Skipped without a CUDA device;
on the card (which has no jax) run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack, histogram
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
    for plain2 in (True, False):
        lut = None if plain2 else luts[0]
        bits = 12 if plain2 else 8
        got = bitpack.walk_masked(words.to(cuda), sub.to(cuda), keep.to(cuda),
                                  None if plain2 else lut.to(cuda), bits,
                                  plain2).cpu()
        ref = bitpack.walk_masked_plain(words, sub, keep, lut, bits, plain2)
        assert torch.equal(got, ref)


def test_round_trip_on_card_matches_cpu(cuda):
    cfg = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(1500, read_len=36, seed=3, ambiguity_rate=0.01)
    blob = compress_bytes(data, cfg, 2, device=cuda)
    assert blob == compress_bytes(data, cfg, 2, device="cpu")
    assert decompress_bytes(blob, device=cuda) == data

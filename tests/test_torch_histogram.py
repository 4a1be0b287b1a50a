"""K1: the port's histogram (plain version of csrc/histogram.cu) against
phyngsc_tpu's Pallas kernel (interpret mode) and its XLA scan, and the port's
quality/DNA analyze against phyngsc_tpu's. Exact equality: counts are
integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.models import dna as jdna
from phyngsc_tpu.models import quality as jquality
from phyngsc_tpu.ops import histogram as jhist
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import histogram


@pytest.mark.parametrize("R,L,A", [(100, 36, 256), (1030, 37, 128),
                                   (700, 300, 256), (1500, 36, 128)])
def test_position_histogram_matches_pallas_and_scan(R, L, A):
    rng = np.random.default_rng(R + L + A)
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)  # some >= A
    valid = rng.random((R, L)) < 0.7
    got = histogram.position_histogram(torch.from_numpy(sym),
                                       torch.from_numpy(valid), A).numpy()
    assert got.dtype == np.int32 and got.shape == (L, A)
    pallas = np.asarray(jhist.position_histogram_pallas(
        jnp.asarray(sym), jnp.asarray(valid), A, interpret=True))
    scan = np.asarray(jhist.position_histogram(
        jnp.asarray(sym), jnp.asarray(valid), A))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)


def test_global_histogram_matches():
    rng = np.random.default_rng(3)
    sym = rng.integers(60, 90, size=(333, 36)).astype(np.uint8)
    valid = rng.random((333, 36)) < 0.5
    got = histogram.global_histogram(torch.from_numpy(sym),
                                     torch.from_numpy(valid), 128).numpy()
    ref = np.asarray(jhist.global_histogram(jnp.asarray(sym),
                                            jnp.asarray(valid), 128))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("L", [36, 300])
def test_quality_analyze_matches(L):
    rng = np.random.default_rng(L)
    R = 512
    qual = rng.integers(33, 74, size=(R, L)).astype(np.uint8)
    qual[:, 5] = 200  # transferred-ambiguity symbols live above 127
    lens = np.where(np.arange(R) < 400, L - 3, 0).astype(np.int32)
    got = quality.analyze(torch.from_numpy(qual), torch.from_numpy(lens))
    ref = np.asarray(jquality.analyze(jnp.asarray(qual), jnp.asarray(lens)))
    assert got.shape == (min(L, quality.MAX_TREES), 256)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("small", [True, False])
def test_dna_analyze_matches(small):
    rng = np.random.default_rng(7)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(300, 36))]
    keep = rng.random((300, 36)) < 0.9
    got = dna.analyze(torch.from_numpy(seq), torch.from_numpy(keep), small)
    ref = np.asarray(jdna.analyze(jnp.asarray(seq), jnp.asarray(keep),
                                  small_alpha=small))
    assert got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("A", [1, 64])
def test_position_histogram_small_alphabets_match_pallas(A):
    """Any 1 <= A <= 256 (the card's kernel takes them all): symbols at and
    above A count nowhere."""
    rng = np.random.default_rng(A)
    R, L = 1037, 37
    sym = rng.integers(0, 2 * A + 2, size=(R, L)).astype(np.uint8)
    valid = rng.random((R, L)) < 0.6
    got = histogram.position_histogram(torch.from_numpy(sym),
                                       torch.from_numpy(valid), A).numpy()
    pallas = np.asarray(jhist.position_histogram_pallas(
        jnp.asarray(sym), jnp.asarray(valid), A, interpret=True))
    assert got.shape == (L, A)
    np.testing.assert_array_equal(got, pallas)


def _stage_a_planes(L, seed):
    """An Rp-row stage-A plane pair whose padding rows are zero with zero
    masks, as stage_a leaves them: (R, qual, lens, seq, keep)."""
    rng = np.random.default_rng(seed)
    R, Rp = 700, 1024
    lens = np.zeros(Rp, np.int32)
    lens[:R] = rng.integers(L // 2, L + 1, size=R)
    valid = np.arange(L)[None, :] < lens[:, None]
    qual = np.where(valid, rng.integers(33, 74, size=(Rp, L)), 0).astype(
        np.uint8)
    qual[:R:7, 3] = 200  # transferred-ambiguity symbols live above 127
    seq = np.where(valid, np.frombuffer(b"ACGTN", np.uint8)[
        rng.integers(0, 5, size=(Rp, L))], 0).astype(np.uint8)
    keep = valid & (rng.random((Rp, L)) < 0.9)
    return R, qual, lens, seq, keep


@pytest.mark.parametrize("L", [36, 300])
def test_quality_analyze_on_live_rows(L):
    """Stage A analyzes the R live rows only: the same counts as the Rp-row
    plane, in the port and in phyngsc_tpu."""
    R, qual, lens, _, _ = _stage_a_planes(L, L)
    q, ln = torch.from_numpy(qual), torch.from_numpy(lens)
    live = quality.analyze(q[:R], ln[:R]).numpy()
    np.testing.assert_array_equal(live, quality.analyze(q, ln).numpy())
    np.testing.assert_array_equal(live, np.asarray(jquality.analyze(
        jnp.asarray(qual), jnp.asarray(lens))))


@pytest.mark.parametrize("small", [True, False])
def test_dna_analyze_on_live_rows(small):
    R, _, _, seq, keep = _stage_a_planes(36, 5)
    s, k = torch.from_numpy(seq), torch.from_numpy(keep)
    live = dna.analyze(s[:R], k[:R], small).numpy()
    np.testing.assert_array_equal(live, dna.analyze(s, k, small).numpy())
    np.testing.assert_array_equal(live, np.asarray(jdna.analyze(
        jnp.asarray(seq), jnp.asarray(keep), small_alpha=small)))

"""K4: the port's code lookup (fused_lookup_plain, the plain version of
csrc/lookup.cu) against phyngsc_tpu's Pallas lookup kernel in interpret mode,
at the shapes of tests/test_lookup.py: full and windowed alphabets, several
position chunks, a row count that is not a multiple of the kernel's row
tile, and symbols at or above A. Exact equality: entries are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.ops import lookup as jlookup
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.ops import lookup


def _table(rng, L, A):
    """Fused entries over their whole range: (len << 12) | code, len <= 12."""
    return ((rng.integers(0, 13, size=(L, A)) << lookup.CODE_BITS)
            | rng.integers(0, 1 << lookup.CODE_BITS, size=(L, A))
            ).astype(np.int32)


def _both(sym, tab):
    ref = np.asarray(jlookup.fused_lookup_pallas(
        jnp.asarray(sym), jnp.asarray(tab), interpret=True))
    got = lookup.fused_lookup_plain(torch.from_numpy(sym),
                                    torch.from_numpy(tab))
    assert got.dtype == torch.int32 and got.shape == sym.shape
    return got.numpy(), ref


@pytest.mark.parametrize("R,L,A", [(100, 4, 256), (256, 36, 256),
                                   (300, 40, 256), (128, 80, 256),
                                   (64, 128, 256), (300, 36, 64),
                                   (300, 36, 128), (513, 88, 256)])
def test_lookup_matches_pallas(R, L, A):
    rng = np.random.default_rng(R * 1000 + L + A)
    tab = _table(rng, L, A)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    got, ref = _both(sym, tab)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tab[np.arange(L)[None, :], sym])


@pytest.mark.parametrize("A", [64, 128])
def test_symbols_at_or_above_a_give_zero(A):
    """A symbol >= A matches no one-hot column of the TPU kernel: entry 0."""
    rng = np.random.default_rng(A + 1)
    R, L = 257, 36
    tab = _table(rng, L, A) | 1  # no entry is 0 by chance
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)
    sym[0, :] = A  # the first column past the table
    got, ref = _both(sym, tab)
    np.testing.assert_array_equal(got, ref)
    assert (got[sym >= A] == 0).all() and (got[sym < A] != 0).all()


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(_table(rng, 36, 64))
    sym = torch.from_numpy(rng.integers(0, 64, size=(50, 36)).astype(np.uint8))
    before = dict(kernels.PLAIN_ON_CUDA)
    assert torch.equal(lookup.fused_lookup(sym, tab),
                       lookup.fused_lookup_plain(sym, tab))
    assert kernels.PLAIN_ON_CUDA == before  # CPU runs are not counted
    with pytest.raises(ValueError, match="CUDA"):
        lookup.fused_lookup(sym.to("meta"), tab.to("meta"))

"""K4: the port's code lookup (fused_lookup_plain, the plain version of
csrc/lookup.cu) against phyngsc_tpu's Pallas lookup kernel in interpret mode,
which takes the (L, A) table fuse_tables(codes, lens)[tree] where the port
takes the (T, A) table and the tree ids. Shapes of tests/test_lookup.py (full
and windowed alphabets, several position chunks, a row count that is not a
multiple of the kernel's row tile, symbols at or above A) with a tree a
position, then fewer trees than positions, one tree and ids past the last
tree. Exact equality: entries are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.ops import lookup as jlookup
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.models import quality
from phyngsc_tpu_torch.ops import lookup


def _codes(rng, T, A):
    """Code tables over their whole range: codes < 2^12, lengths <= 12."""
    return (rng.integers(0, 1 << lookup.CODE_BITS, size=(T, A)),
            rng.integers(0, 13, size=(T, A)))


def _both(sym, codes, lens, tree):
    """The JAX kernel on fuse_tables(codes, lens)[tree] and the port's plain
    version on fused_table_np(codes, lens) and tree (None: tree 0)."""
    L = sym.shape[1]
    ids = np.zeros(L, np.uint8) if tree is None else tree
    ref = np.asarray(jlookup.fused_lookup_pallas(
        jnp.asarray(sym),
        jlookup.fuse_tables(jnp.asarray(codes), jnp.asarray(lens))[
            jnp.asarray(ids)], interpret=True))
    tab = torch.from_numpy(lookup.fused_table_np(codes, lens).view(np.int16))
    got = lookup.fused_lookup_plain(
        torch.from_numpy(sym), tab,
        None if tree is None else torch.from_numpy(tree))
    assert got.dtype == torch.int32 and got.shape == sym.shape
    return got.numpy(), ref


def test_fused_table_np_matches_fuse_tables():
    rng = np.random.default_rng(7)
    codes, lens = _codes(rng, 256, 256)
    lens[0, :] = 12  # the largest entries, (12 << 12) | code
    codes[0, :] = (1 << lookup.CODE_BITS) - 1
    got = lookup.fused_table_np(codes.astype(np.uint32), lens.astype(np.uint8))
    ref = np.asarray(jlookup.fuse_tables(jnp.asarray(codes.astype(np.uint32)),
                                         jnp.asarray(lens.astype(np.uint8))))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got.astype(np.int32), ref)


@pytest.mark.parametrize("R,L,A", [(100, 4, 256), (256, 36, 256),
                                   (300, 40, 256), (128, 80, 256),
                                   (64, 128, 256), (300, 36, 64),
                                   (300, 36, 128), (513, 88, 256)])
def test_lookup_matches_pallas(R, L, A):
    """A tree a position: the (L, A) table of the TPU kernel itself."""
    rng = np.random.default_rng(R * 1000 + L + A)
    codes, lens = _codes(rng, L, A)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    got, ref = _both(sym, codes, lens, np.arange(L, dtype=np.uint8))
    np.testing.assert_array_equal(got, ref)
    tab = (lens << lookup.CODE_BITS) | codes
    np.testing.assert_array_equal(got, tab[np.arange(L)[None, :], sym])


@pytest.mark.parametrize("R,L,A,T", [(300, 36, 256, 9), (257, 100, 64, 13),
                                     (64, 1000, 128, 256), (40, 7, 256, 3),
                                     (300, 36, 256, 1), (129, 1, 64, 1)])
def test_tree_tables_match_pallas(R, L, A, T):
    """Fewer trees than positions: the encode's tree of each position
    (quality.encode_tables), then one tree without ids (the DNA stream)."""
    rng = np.random.default_rng(R + L + A + T)
    codes, lens = _codes(rng, T, A)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    tree = (quality.encode_tables(codes, lens, L)[1] if T > 1 else None)
    if tree is not None:
        assert tree.dtype == np.uint8 and tree.max() < T
    got, ref = _both(sym, codes, lens, tree)
    np.testing.assert_array_equal(got, ref)


def test_tree_ids_past_the_last_tree_read_it():
    """An id >= T reads tree T - 1, as JAX's gather clamps the index."""
    rng = np.random.default_rng(11)
    R, L, A, T = 200, 20, 64, 4
    codes, lens = _codes(rng, T, A)
    sym = rng.integers(0, A, size=(R, L)).astype(np.uint8)
    tree = rng.integers(0, 256, size=L).astype(np.uint8)
    tree[:2] = (T - 1, T)
    got, ref = _both(sym, codes, lens, tree)
    np.testing.assert_array_equal(got, ref)
    tab = (lens << lookup.CODE_BITS) | codes
    np.testing.assert_array_equal(
        got, tab[np.minimum(tree, T - 1)[None, :], sym])


@pytest.mark.parametrize("A", [64, 128])
def test_symbols_at_or_above_a_give_zero(A):
    """A symbol >= A matches no one-hot column of the TPU kernel: entry 0."""
    rng = np.random.default_rng(A + 1)
    R, L = 257, 36
    codes, lens = _codes(rng, L, A)
    codes |= 1  # no entry is 0 by chance
    sym = rng.integers(0, 256, size=(R, L)).astype(np.uint8)
    sym[0, :] = A  # the first column past the table
    got, ref = _both(sym, codes, lens, np.arange(L, dtype=np.uint8))
    np.testing.assert_array_equal(got, ref)
    assert (got[sym >= A] == 0).all() and (got[sym < A] != 0).all()


def test_entries_are_widened_as_uint16():
    """Entries at and above 2^15 are stored as negative int16 and read back
    as their uint16 values."""
    tab = torch.tensor([[0x7FFF, 0x8000, 0xD000, 0xFFFF]],
                       dtype=torch.int32).to(torch.int16)
    sym = torch.tensor([[0, 1, 2, 3, 4]], dtype=torch.uint8)
    got = lookup.fused_lookup_plain(sym, tab)
    assert got.tolist() == [[0x7FFF, 0x8000, 0xD000, 0xFFFF, 0]]


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(3)
    codes, lens = _codes(rng, 5, 64)
    tab, tree = (torch.from_numpy(x)
                 for x in quality.encode_tables(codes, lens, 36))
    sym = torch.from_numpy(rng.integers(0, 64, size=(50, 36)).astype(np.uint8))
    before = dict(kernels.PLAIN_ON_CUDA)
    assert torch.equal(lookup.fused_lookup(sym, tab, tree),
                       lookup.fused_lookup_plain(sym, tab, tree))
    assert kernels.PLAIN_ON_CUDA == before  # CPU runs are not counted
    with pytest.raises(ValueError, match="CUDA"):
        lookup.fused_lookup(sym.to("meta"), tab.to("meta"), tree.to("meta"))

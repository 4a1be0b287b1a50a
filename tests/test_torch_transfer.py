"""ops/transfer, the host<->device wire, against phyngsc_tpu's: the host
packers give the same mode and words (with the native runtime and with it
absent), the device unpackers give the JAX package's planes from the same
words (exception padding included), and pack_lanes gives the words of
the packed decode fetch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.ops import transfer as jtransfer
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.utils import native as jnative
from phyngsc_tpu_torch.ops import transfer
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.utils import native
from torch_time_limit import time_limit

_limit = time_limit(60)
ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"NYRWSKMDVHBXU.-", np.uint8)


def _acgt(rng, R, L):
    return ACGT[rng.integers(0, 4, size=(R, L))].copy()


def _sprinkle(rng, seq, k, alphabet):
    flat = seq.reshape(-1)
    flat[rng.choice(flat.size, k, replace=False)] = alphabet[
        rng.integers(0, alphabet.size, size=k)]
    return seq


def _pad(seq, rng):
    """Zero the columns past a random length in some rows and a few whole
    rows, as the gathers leave them."""
    R, L = seq.shape
    for r in rng.choice(R, max(R // 5, 1), replace=False):
        seq[r, rng.integers(0, L):] = 0
    seq[-1] = 0
    return seq


def _seq_cases():
    rng = np.random.default_rng(71)
    return {
        "pure ACGT": (_pad(_acgt(rng, 300, 36), rng), jtransfer.SEQ_2BIT),
        "ACGTN": (_pad(np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, size=(333, 37))].copy(), rng),
            jtransfer.SEQ_3BIT),
        "sparse IUPAC": (_pad(_sprinkle(rng, _acgt(rng, 300, 36), 50, IUPAC),
                              rng), jtransfer.SEQ_2BIT_EXC),
        "sparse N": (_sprinkle(rng, _acgt(rng, 2000, 40), 30,
                               np.frombuffer(b"N", np.uint8)),
                     jtransfer.SEQ_2BIT_EXC),
        "dense IUPAC": (_pad(_sprinkle(rng, _acgt(rng, 200, 50), 6000, IUPAC),
                             rng), jtransfer.SEQ_RAW),
        "exception cap": (_sprinkle(rng, _acgt(rng, 500, 40), 500 * 40 // 32
                                    + 1, np.frombuffer(b"N", np.uint8)),
                          jtransfer.SEQ_3BIT),
        "tiny plane": (np.frombuffer(b"ACGTNACGTYAA", np.uint8).reshape(
            1, -1).copy(), jtransfer.SEQ_RAW),
        "SOLiD colours": (np.concatenate(
            [ACGT[rng.integers(0, 4, size=(64, 1))],
             (rng.integers(0, 4, size=(64, 49)) + 48).astype(np.uint8)],
            axis=1), jtransfer.SEQ_RAW),
    }


def _qual_cases():
    rng = np.random.default_rng(72)
    q6 = rng.integers(33, 97, size=(400, 36)).astype(np.uint8)
    high = rng.integers(33, 127, size=(90, 31)).astype(np.uint8)
    return {"6-bit": (_pad(q6, rng), jtransfer.QUAL_6BIT),
            "high phred": (_pad(high, rng), jtransfer.QUAL_RAW),
            "tiny plane": (np.full((1, 3), 100, np.uint8),
                           jtransfer.QUAL_RAW)}


SEQ, QUAL = _seq_cases(), _qual_cases()


@pytest.fixture(params=["native", "numpy"])
def runtime(request, monkeypatch):
    """The packers with the native runtime as the process has it, or with
    it absent in both packages (byte_scan None sends every packer to its
    numpy path)."""
    if request.param == "numpy":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "byte_scan", lambda f: None)
    return request.param


@pytest.mark.parametrize("case", list(SEQ))
def test_pack_seq_is_the_jax_packers(runtime, case):
    seq, mode = SEQ[case]
    want = jtransfer.pack_seq_np(seq)
    got = transfer.pack_seq_np(seq)
    assert got[0] == want[0] == mode
    assert got[1].dtype == np.uint32
    np.testing.assert_array_equal(got[1], want[1])
    assert (transfer.seq_alpha_small(got[0], seq)
            == jtransfer.seq_alpha_small(want[0], seq))


@pytest.mark.parametrize("case", list(QUAL))
def test_pack_qual_is_the_jax_packers(runtime, case):
    qual, mode = QUAL[case]
    want = jtransfer.pack_qual_np(qual)
    got = transfer.pack_qual_np(qual)
    assert got[0] == want[0] == mode
    np.testing.assert_array_equal(got[1], want[1])


def _words(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, np.uint32).view(np.int32))


@pytest.mark.parametrize("case", list(SEQ))
def test_unpack_seq_is_the_jax_unpack(case):
    seq, _ = SEQ[case]
    R, L = seq.shape
    mode, words = jtransfer.pack_seq_np(seq)
    want = np.asarray(jtransfer.unpack_seq(jnp.array(words), mode, R, L))
    got = transfer.unpack_seq(_words(words), mode, R, L)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (R, L)
    np.testing.assert_array_equal(got.numpy(), want)
    valid = seq != 0
    np.testing.assert_array_equal(got.numpy()[valid], seq[valid])


@pytest.mark.parametrize("case", list(QUAL))
def test_unpack_qual_is_the_jax_unpack(case):
    qual, _ = QUAL[case]
    R, L = qual.shape
    mode, words = jtransfer.pack_qual_np(qual)
    want = np.asarray(jtransfer.unpack_qual(jnp.array(words), mode, R, L))
    got = transfer.unpack_qual(_words(words), mode, R, L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exception_padding_never_writes():
    """Exception words padded with 0xFFFFFFFF (the packer's), with zeros
    (idx 0, symbol 0) and with an index past the plane leave the base
    plane as it is, as the JAX unpack leaves it."""
    seq, _ = SEQ["sparse IUPAC"]
    R, L = seq.shape
    mode, words = jtransfer.pack_seq_np(seq)
    assert mode == jtransfer.SEQ_2BIT_EXC
    nb = jtransfer.n_words(R * L, "seq", jtransfer.SEQ_2BIT)
    n_exc = int(np.count_nonzero(words[nb:] != 0xFFFFFFFF))
    assert 0 < n_exc < words.shape[0] - nb - 2
    words = words.copy()
    words[nb + n_exc] = 0                              # zero padding
    words[nb + n_exc + 1] = ((R * L + 5) << 8) | 78    # past the plane
    want = np.asarray(jtransfer.unpack_seq(jnp.array(words), mode, R, L))
    got = transfer.unpack_seq(_words(words), mode, R, L).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == (seq[0, 0] or ord("A"))
    valid = seq != 0
    np.testing.assert_array_equal(got[valid], seq[valid])


@pytest.mark.parametrize("w", sorted(subblock._OUT_PER))
def test_pack_lanes_is_the_jax_lane_pack(w):
    rng = np.random.default_rng(73 + w)
    for n in (1, 17, 1000, 4099):
        vals = rng.integers(0, 1 << w, size=n).astype(np.int32)
        want = np.asarray(jsubblock._lane_pack_j(jnp.asarray(vals), w))
        got = transfer.pack_lanes(torch.from_numpy(vals), w)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(
            subblock._lane_unpack_np(got.numpy().view(np.uint32), w, n),
            vals)


"""K5: the port's densify (dense_words_plain, the plain version of
csrc/densify.cu) against phyngsc_tpu's host layout dense_words_np in every
cell, and against its device densifies — the sort twin and the Pallas DMA
kernel in interpret mode — on every cell a walk reads; the guard against
corrupt substream tables; and the whole decode slice: phyngsc_tpu's decode
with the Pallas walks under PHYNGSC_DENSIFY=dma (K5 in interpret mode)
against the port's CPU decode. Exact equality: words and bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.pipeline.decompress import decompress_bytes as jax_decompress
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.models import dna
from phyngsc_tpu_torch.ops import bitpack, bitpack_host
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_torch_pipeline import _huffman_dna_input, _parsed


def _table(S, max_words, seed):
    """A substream table with about a third of its lanes empty, and words
    for it."""
    rng = np.random.default_rng(seed)
    sub = rng.integers(0, max_words + 1, size=S).astype(np.int32)
    sub[rng.random(S) < 0.3] = 0
    words = rng.integers(0, 1 << 32, size=int(sub.sum()), dtype=np.uint64
                         ).astype(np.uint32)
    return sub, words


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("S,max_words", [
    (1, 40), (37, 300), (130, 40), (2048, 90),
    (37, 0),           # a stream with no words
])
def test_dense_words_matches_jax(S, max_words):
    sub, words = _table(S, max_words, S + max_words)
    # padded as phyngsc_tpu's decode pads its uploads
    padded = np.concatenate([words, np.zeros(8, np.uint32)])
    ref = jbitpack.dense_words_np(padded, sub)
    Wmax, Sp = ref.shape
    assert (Wmax, Sp) == bitpack_host.dense_geometry(sub) \
        == jbitpack.dense_geometry(sub)
    before = dict(kernels.LAUNCHES)
    got = bitpack.dense_words(_i32(words), torch.from_numpy(sub), Wmax, Sp)
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.int32 and got.shape == (Wmax, Sp)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)  # every cell, pad lanes included
    np.testing.assert_array_equal(got, np.asarray(jbitpack.dense_words_device(
        jnp.asarray(padded), jnp.asarray(sub), Wmax, Sp)))
    sub_pad = np.zeros(Sp, np.int32)
    sub_pad[:S] = sub
    valid = np.arange(Wmax)[:, None] < sub_pad[None, :]
    pallas = np.asarray(jbitpack.dense_words_pallas(
        jnp.asarray(padded), jnp.asarray(sub), Wmax, Sp, interpret=True))
    np.testing.assert_array_equal(got[valid], pallas[valid])


def test_dense_words_reads_past_the_words_as_zero():
    """A table that claims more words than the stream holds (corrupt): the
    cells past the last word are 0, as in the kernel's checked loads."""
    sub = np.array([3, 0, 4], np.int32)
    words = np.array([11, 12, 13, 14, 15], np.uint32)
    Wmax, Sp = bitpack_host.dense_geometry(sub)
    got = bitpack.dense_words_plain(_i32(words), torch.from_numpy(sub), Wmax,
                                    Sp).numpy()
    want = np.zeros((Wmax, Sp), np.int32)
    want[:3, 0] = [11, 12, 13]
    want[:2, 2] = [14, 15]
    np.testing.assert_array_equal(got, want)


def test_plane_geometry_guards_the_table():
    """A lane holds at most ceil(G*L*max_code_len/32) + 1 words; only a
    corrupt table holds more, and plane_geometry raises on it. Lanes of 2^16
    words and more are legal where the geometry allows them."""
    limit = bitpack.lane_words_max(64, 5600, 12)
    assert limit == 64 * 5600 * 12 // 32 + 1 > 1 << 17
    assert bitpack.plane_geometry(np.array([limit, 3]), 64, 5600, 12) \
        == (-(-limit // 256) * 256, 128)
    assert bitpack.plane_geometry(np.array([(1 << 16) + 1]), 64, 5600, 12) \
        == ((1 << 16) + 256, 128)
    with pytest.raises(ValueError, match="corrupt substream table"):
        bitpack.plane_geometry(np.array([3, limit + 1]), 64, 5600, 12)
    with pytest.raises(ValueError, match="corrupt substream table"):
        bitpack.plane_geometry(np.array([218]), 16, 36, 12)


@pytest.mark.parametrize("stream", ["q", "d"])
def test_corrupt_table_raises_before_upload(monkeypatch, stream):
    """_decode_device checks both substream tables before it uploads or
    allocates anything for the sub-block; the untouched container still
    decodes."""
    cfg = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=16)
    data = synthesize_fastq(300, read_len=36, seed=61)
    blob = compress_bytes(data, cfg, 1, device="cpu")
    p = _parsed(blob)[0]
    table = p.q_sub if stream == "q" else p.d_sub
    table[0] = bitpack.lane_words_max(p.G, p.L, cfg.max_code_len) + 1

    def no_alloc(*args, **kwargs):
        raise AssertionError("device memory allocated for a corrupt table")

    with monkeypatch.context() as m:
        for name in ("_to_device", "_upload_words", "_record_lens"):
            m.setattr(subblock, name, no_alloc)
        with pytest.raises(ValueError, match="corrupt substream table"):
            subblock._decode_device(p, cfg, torch.device("cpu"))
    assert decompress_bytes(blob, device="cpu") == data


def _uniform():
    return synthesize_fastq(600, read_len=36, seed=62, ambiguity_rate=0.01)


def _variable():
    return synthesize_fastq(300, read_len=100, seed=63, variable_length=True)


def _huffman():
    return _huffman_dna_input(500, 36, 64)


@pytest.mark.parametrize("build", [_uniform, _variable, _huffman])
def test_slice_matches_jax_dma_decode(monkeypatch, build):
    """The whole decode slice: phyngsc_tpu's fused Pallas-walk decode with
    its planes built by K5 (dense_words_pallas, interpret mode) and the
    port's CPU decode (dense_words_plain, then the walks on the plane) give
    the same bytes."""
    monkeypatch.setenv("PHYNGSC_WALK", "pallas")
    monkeypatch.setattr(jbitpack, "DENSIFY", "dma")
    calls = []
    pallas = jbitpack.dense_words_pallas

    def spy(*args, **kwargs):
        calls.append(args[2:4])
        return pallas(*args, **kwargs)

    monkeypatch.setattr(jbitpack, "dense_words_pallas", spy)
    data = build()
    cfg = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=8)
    blob = jax_compress(data, cfg, 1)
    parsed = _parsed(blob)
    assert any(p.variable for p in parsed) == (build is _variable)
    assert (any(p.d_plan.mode == dna.MODE_HUFFMAN for p in parsed)
            == (build is _huffman))
    jsubblock._decode_walk_fused.clear_cache()  # retrace under "dma"
    try:
        assert jax_decompress(blob) == data
    finally:
        jsubblock._decode_walk_fused.clear_cache()
    assert calls, "phyngsc_tpu's decode did not densify with K5"
    assert decompress_bytes(blob, device="cpu") == data

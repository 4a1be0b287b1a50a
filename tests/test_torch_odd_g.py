"""Containers at an odd substream width: G = 33 records a lane over
variable-length reads bucketed to L = 500. There L % 8 != 0 and
G * L = 16,500 > 16,384, so phyngsc_tpu's masked walk would tile its shared
LUTs by k0 = 8 / gcd(L, 8) = 2, which does not divide G. Both packages write
the same bytes, and each decodes the other's container: phyngsc_tpu through
its default CPU decode (the XLA walk, the oracle its own tests use), the
port through K3's plain version with per-position trees."""

import math

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.pipeline.decompress import decompress_bytes as jax_decompress
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_torch_pipeline import _parsed

G, L = 33, 500
CFG = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=G,
                  auto_substream=False)


def drifting_reads(n, seed):
    """n reads of 461-500 bp (the first of 500) whose qualities drift along
    the read, so that adaptive merging keeps several quality trees."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        m = int(rng.integers(461, L + 1)) if i else L
        qual = 33 + np.minimum(np.arange(m) * 40 // m
                               + rng.geometric(0.3, size=m) - 1, 70)
        recs.append(b"@odd.%d\n%s\n+\n%s\n" % (
            i, acgt[rng.integers(0, 4, size=m)].tobytes(),
            qual.astype(np.uint8).tobytes()))
    return b"".join(recs)


@pytest.mark.parametrize("writers", [1, 2])
def test_odd_g_containers_cross_decode(monkeypatch, writers):
    monkeypatch.delenv("PHYNGSC_WALK", raising=False)
    data = drifting_reads(240, 5)
    k0 = 8 // math.gcd(L, 8)
    assert k0 == 2 and G % k0  # the TPU walk's tiling does not divide G
    assert G * L > jbitpack.WALK_PER_STEP_MAX
    ref = jax_compress(data, CFG, writers)
    got = compress_bytes(data, CFG, writers, device="cpu")
    parsed = _parsed(got)
    assert len(parsed) >= 3
    assert all(p.variable and p.L == L and p.G == G and p.Rp % G == 0
               and p.q_tables.n_trees > 1 for p in parsed)
    assert got == ref
    assert decompress_bytes(ref, device="cpu") == data
    assert jax_decompress(got) == data

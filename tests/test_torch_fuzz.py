"""The JAX package's fuzz contract (tests/test_fuzz.py) on the port, on the
CPU, with its seeds and sizes: a corrupt container decodes to the exact
input or raises ValueError / EOFError, nothing else (120 bit flips at 2
writers, 25 truncations); randomized records round-trip byte-exactly from
containers equal to phyngsc_tpu's; corrupt tables are rejected at parse.
The card's run of the same flips is test_torch_cuda.py's
test_fuzz_flips_on_card and chip_smoke.py's fuzz phase."""

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import quality
from phyngsc_tpu_torch.ops import bitpack_host
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_fuzz import _random_fastq
from torch_fuzz_cases import (CFG, CFG_KW, bitflip_corpus, flips, outcome,
                              random_fastq)
from torch_time_limit import time_limit

_limit = time_limit(60)
JAX_CFG = JaxConfig(**CFG_KW)


def _decode(blob):
    return decompress_bytes(blob, device="cpu")


@pytest.mark.parametrize("kw", [dict(iupac=0.02), dict(var_len=False),
                                dict(iupac=0.4, qmax=126, messy_titles=True)])
def test_random_fastq_is_the_fuzz_generator(kw):
    """torch_fuzz_cases.random_fastq gives test_fuzz._random_fastq's
    records, and leaves the rng where it does."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert random_fastq(a, 40, **kw) == _random_fastq(b, 40, **kw)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.mark.parametrize("part", range(4))
def test_bitflip_fuzz_never_crashes(part):
    """test_fuzz's 120 flips, a quarter a case (each under the time
    limit)."""
    rng, data = bitflip_corpus()
    blob = compress_bytes(data, CFG, 2, device="cpu")
    assert blob == jax_compress(data, JAX_CFG, 2)
    mine = list(flips(rng, blob))[30 * part:30 * (part + 1)]
    seen = [outcome(_decode, mutated, data) for _, _, mutated in mine]
    assert len(seen) == 30
    assert set(seen) - {"ok"}  # the flips hit live data, not only padding


def test_truncation_fuzz_never_crashes():
    rng = np.random.default_rng(99)
    data = random_fastq(rng, 60)
    blob = compress_bytes(data, CFG, 1, device="cpu")
    cuts = sorted(set(int(rng.integers(1, len(blob))) for _ in range(25)))
    for cut in cuts:
        outcome(_decode, blob[:cut], data)


@pytest.mark.parametrize("seed", range(6))
def test_property_roundtrip_fuzz(seed):
    rng = np.random.default_rng(seed)
    data = random_fastq(
        rng, int(rng.integers(20, 200)),
        iupac=float(rng.choice([0.0, 0.05, 0.4])),
        qmax=int(rng.choice([40, 74, 126])),
        var_len=bool(rng.integers(0, 2)),
        messy_titles=bool(rng.integers(0, 2)),
    )
    n_writers = int(rng.integers(1, 4))
    blob = compress_bytes(data, CFG, n_writers, device="cpu")
    assert blob == jax_compress(data, JAX_CFG, n_writers)
    assert _decode(blob) == data


def test_corrupt_tables_rejected_at_parse(monkeypatch):
    """Code lengths past max_code_len and singletons outside the alphabet
    raise ValueError in the parse's check, length 16 in the wire packer,
    and a corrupt table from read_header before any decode runs."""
    cfg = CodecConfig()
    good = np.zeros((2, 256), np.uint8)
    good[:, 65:69] = 2
    bad_len = good.copy()
    bad_len[1, 70] = cfg.max_code_len + 1
    with pytest.raises(ValueError, match="code length"):
        subblock._check_tables(bad_len, np.array([-1, -1]), "quality", cfg)
    with pytest.raises(ValueError, match="singleton"):
        subblock._check_tables(good, np.array([-1, 300]), "quality", cfg)
    subblock._check_tables(good, np.array([-1, -1]), "quality", cfg)

    worst = np.zeros((1, 256), np.uint8)
    worst[0, 0] = 16
    with pytest.raises(ValueError, match="code length"):
        bitpack_host.pack_lens4_np(worst, np.array([-1], np.int32))

    data = random_fastq(np.random.default_rng(7), 40, var_len=False)
    blob = compress_bytes(data, CFG, 1, device="cpu")
    orig = quality.read_header

    def poison(br):
        tables, sub, total = orig(br)
        tables.lens[0, tables.lens[0].argmax()] = cfg.max_code_len + 2
        return tables, sub, total

    monkeypatch.setattr(quality, "read_header", poison)
    with pytest.raises(ValueError, match="corrupt quality table"):
        _decode(blob)

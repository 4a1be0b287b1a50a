"""The port's round trip against phyngsc_tpu's: compress_bytes writes the
same container byte for byte, each side decodes the other's containers, the
committed goldens decode, corrupt containers raise, and the configurations
the port does not take yet (data_shards > 1) raise NotImplementedError
instead of writing other bytes."""

import hashlib
import os
import re

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.container import block as blockmod
from phyngsc_tpu.container import footer as footermod
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.pipeline.decompress import decompress_bytes as jax_decompress
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch.models import dna
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_format_stability import (_golden_input, _longread_input,
                                   _titles_input)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
CFG = CodecConfig(subblock_input_bytes=32 << 10, records_per_substream=16)
CPU = "cpu"


def _huffman_dna_input(n, read_len, seed):
    """Reads with an N whose quality is outside [33, 40]: the ambiguity
    cannot move into the quality stream, so DNA stays Huffman-coded."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        seq = acgt[rng.integers(0, 4, size=read_len)].copy()
        qual = rng.integers(33, 74, size=read_len).astype(np.uint8)
        if i % 3 == 0:
            seq[0] = ord("N")
            qual[0] = ord("B")
        recs.append(b"@h%d\n" % i + seq.tobytes() + b"\n+\n" + qual.tobytes()
                    + b"\n")
    return b"".join(recs)


def _parsed(blob):
    """The port's host parse of every sub-block in a container, with the
    container's own geometry."""
    foot = footermod.read_footer(blob)
    cfg = CodecConfig(records_per_substream=foot.records_per_substream)
    sizes = foot.block_sizes_in_file_order()
    offs = np.concatenate([[0], np.cumsum(sizes)])
    blocks = ((w, blob[offs[i]:offs[i + 1]]) for i, w in enumerate(foot.cbo))
    return [subblock._decode_parse(p, cfg)
            for _, p in blockmod.iter_subblocks(blocks)]


def _solid_input(n, seed, variable=False):
    """SOLiD colour-space reads: a nucleotide, then '0'-'3' colours."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        m = int(rng.integers(30, 51)) if variable else 50
        recs.append(b"@solid.%d\n" % i
                    + b"ACGT"[rng.integers(0, 4):][:1]
                    + (rng.integers(0, 4, size=m - 1) + ord("0")).astype(
                        np.uint8).tobytes()
                    + b"\n+\n" + rng.integers(33, 64, size=m).astype(
                        np.uint8).tobytes() + b"\n")
    return b"".join(recs)


@pytest.mark.parametrize("case", ["err36", "err36_huffman", "srr76", "var100",
                                  "long1000", "solid"])
@pytest.mark.parametrize("writers", [1, 2])
def test_compress_matches_jax(case, writers):
    variable = delta = False
    if case == "err36":
        data = synthesize_fastq(1200, read_len=36, seed=21,
                                ambiguity_rate=0.01)
        mode = dna.MODE_PLAIN
    elif case == "err36_huffman":
        data = _huffman_dna_input(900, 36, 22)
        mode = dna.MODE_HUFFMAN
    elif case == "srr76":
        data = synthesize_fastq(700, read_len=76, style="SRR", seed=23)
        mode = dna.MODE_PLAIN
    elif case == "var100":
        data = synthesize_fastq(500, read_len=100, seed=24,
                                variable_length=True)
        mode, variable = dna.MODE_PLAIN, True
    elif case == "long1000":
        data = synthesize_fastq(40, read_len=1000, seed=25)
        mode = dna.MODE_PLAIN
    else:
        data = _solid_input(1000, 26, variable=True)
        mode, variable, delta = dna.MODE_PLAIN, True, True
    ref = jax_compress(data, CFG, writers)
    got = compress_bytes(data, CFG, writers, device=CPU)
    parsed = _parsed(got)
    assert len(parsed) >= 3 and {p.d_plan.mode for p in parsed} == {mode}
    assert all(p.is_delta == delta for p in parsed)
    assert any(p.variable for p in parsed) == variable
    assert got == ref
    assert decompress_bytes(got, device=CPU) == data


def test_each_side_decodes_the_others_containers(monkeypatch):
    monkeypatch.setenv("PHYNGSC_WALK", "pallas")
    for data in (synthesize_fastq(600, read_len=36, seed=31,
                                  ambiguity_rate=0.01),
                 _huffman_dna_input(500, 36, 32)):
        cfg = CodecConfig(records_per_substream=8)
        jblob = jax_compress(data, cfg, 1)
        assert decompress_bytes(jblob, device=CPU) == data
        tblob = compress_bytes(data, cfg, 1, device=CPU)
        assert jax_decompress(tblob) == data


GOLDEN_INPUTS = {"tiny_v1.ngsct": _golden_input,
                 "tiny_v2.ngsct": _golden_input,
                 "titles_v3.ngsct": _titles_input,
                 "longread_v4.ngsct": _longread_input}


@pytest.mark.parametrize("name", sorted(GOLDEN_INPUTS))
def test_port_decodes_goldens(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        blob = f.read()
    assert decompress_bytes(blob, device=CPU) == GOLDEN_INPUTS[name]()


def test_titles_input_reencodes_like_jax():
    """The card's encoder-parity check compares the port's re-encode of the
    titles_v3 input with phyngsc_tpu's bytes by SHA-256 (chip_smoke.py)."""
    data = _titles_input()
    ref = jax_compress(data, CFG, 2)
    assert compress_bytes(data, CFG, 2, device=CPU) == ref
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        pinned = re.search(r'TITLES_V3_REENCODE_SHA256 = \(\s*"([0-9a-f]{64})"',
                           f.read()).group(1)
    assert hashlib.sha256(ref).hexdigest() == pinned


def test_corrupt_containers_raise():
    data = synthesize_fastq(300, read_len=36, seed=41)
    blob = compress_bytes(data, CFG, 1, device=CPU)
    with pytest.raises(ValueError):
        decompress_bytes(blob[: len(blob) // 2], device=CPU)
    bad = bytearray(blob)
    bad[-1] ^= 0x55  # magic
    with pytest.raises(ValueError):
        decompress_bytes(bytes(bad), device=CPU)
    for pos in (600, 2000):  # inside a block payload
        bad = bytearray(blob)
        bad[pos] ^= 0x40
        try:
            out = decompress_bytes(bytes(bad), device=CPU)
        except Exception:
            continue  # any loud failure is acceptable
        assert out == data, "corruption produced silently wrong output"


def _variable_input():
    return synthesize_fastq(200, read_len=36, seed=51, variable_length=True)


def _delta_input():
    rng = np.random.default_rng(52)
    return b"".join(
        b"@s%d\nT" % i
        + (rng.integers(0, 4, size=35) + ord("0")).astype(np.uint8).tobytes()
        + b"\n+\n" + rng.integers(33, 64, size=36).astype(np.uint8).tobytes()
        + b"\n" for i in range(100))


def _long_input():
    return synthesize_fastq(20, read_len=300, seed=53)


@pytest.mark.parametrize("build", [_variable_input, _delta_input, _long_input])
def test_out_of_slice_inputs_raise(build):
    """Named for the input classes that the port's first slice rejected
    (variable lengths, SOLiD colour space, reads over 256 bp): none raises
    any more. Each compresses to phyngsc_tpu's bytes at 1 and 2 writers, and
    each side decodes the other's container."""
    data = build()
    parsed = _parsed(jax_compress(data, CFG, 1))
    assert all(p.variable for p in parsed) == (build is _variable_input)
    assert all(p.is_delta for p in parsed) == (build is _delta_input)
    assert all(p.L > 256 for p in parsed) == (build is _long_input)
    for writers in (1, 2):
        ref = jax_compress(data, CFG, writers)
        got = compress_bytes(data, CFG, writers, device=CPU)
        assert got == ref
        assert decompress_bytes(ref, device=CPU) == data
        assert jax_decompress(got) == data


def test_sharded_config_raises():
    data = synthesize_fastq(50, read_len=36, seed=54)
    sharded = CodecConfig(data_shards=2)
    with pytest.raises(NotImplementedError, match="later slice"):
        compress_bytes(data, sharded, 1, device=CPU)
    blob = compress_bytes(data, CFG, 1, device=CPU)
    with pytest.raises(NotImplementedError, match="later slice"):
        decompress_bytes(blob, sharded, device=CPU)


def test_empty_and_single_record():
    for data in (b"", synthesize_fastq(1, read_len=36, seed=55)):
        blob = compress_bytes(data, CFG, 2, device=CPU)
        assert blob == jax_compress(data, CFG, 2)
        assert decompress_bytes(blob, device=CPU) == data

"""The port's bounded-memory file drivers (mirroring tests/test_streaming.py
with its tiny CFG): compress_file writes phyngsc_tpu's compress_file bytes,
file round trips across several blocks and writers, writer_output_starts,
flat host allocation as the input grows, empty and tiny inputs, and the
writer filter decoding exactly the chosen writers' regions, as
phyngsc_tpu's does. Everything runs the plain versions (device="cpu")."""

import tracemalloc

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.container import footer as footermod
from phyngsc_tpu.parallel.partition import partition_regions
from phyngsc_tpu.pipeline import compress as jcompress
from phyngsc_tpu.pipeline import decompress as jdecompress
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch.pipeline.compress import (compress_bytes,
                                                 compress_file)
from phyngsc_tpu_torch.pipeline.decompress import (_decode_stream,
                                                   decompress_file,
                                                   writer_output_starts)

CFG = CodecConfig(
    subblock_input_bytes=96 * 1024,
    max_records_per_subblock=1024,
    block_size=1 << 16,       # minimum allowed: forces multi-block containers
    index_window_bytes=1 << 16,  # tiny windows: exercise windowed indexing
)
CPU = "cpu"


def _make_input(tmp_path, n_records: int, seed: int = 3):
    data = synthesize_fastq(n_records, read_len=36, style="ERR005195",
                            seed=seed)
    p = tmp_path / f"in{n_records}_{seed}.fastq"
    p.write_bytes(data)
    return str(p), data


def test_file_roundtrip_multiblock(tmp_path):
    in_path, data = _make_input(tmp_path, 8000)
    out_path = str(tmp_path / "out.ngsct")
    back_path = str(tmp_path / "back.fastq")
    stats = []
    compress_file(in_path, out_path, CFG, n_writers=3, stats_out=stats,
                  device=CPU)
    assert [s.writer_id for s in stats] == [0, 1, 2]
    assert sum(s.n_blocks for s in stats) > 3  # multiple blocks per writer
    assert sum(s.input_bytes for s in stats) == len(data)
    assert all(s.n_subblocks >= 1 and s.seconds > 0 for s in stats)
    with open(out_path, "rb") as f:
        assert sum(s.output_bytes for s in stats) < len(f.read())  # + footer
    decompress_file(out_path, back_path, CFG, device=CPU)
    with open(back_path, "rb") as f:
        assert f.read() == data


@pytest.mark.parametrize("writers", [1, 3])
def test_compress_file_matches_jax(tmp_path, writers):
    """compress_file of both packages writes the same bytes, equal to the
    in-memory path, with the same per-writer stats but the seconds."""
    in_path, data = _make_input(tmp_path, 2500, seed=4)
    ours, theirs = str(tmp_path / "t.ngsct"), str(tmp_path / "j.ngsct")
    stats, jstats = [], []
    compress_file(in_path, ours, CFG, writers, stats, CPU)
    jcompress.compress_file(in_path, theirs, CFG, writers, jstats)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        got = f.read()
        assert got == g.read()
    assert got == compress_bytes(data, CFG, writers, device=CPU)
    key = ("writer_id", "n_blocks", "n_subblocks", "input_bytes",
           "output_bytes")
    assert ([[getattr(s, k) for k in key] for s in stats]
            == [[getattr(s, k) for k in key] for s in jstats])
    back = str(tmp_path / "back.fastq")
    decompress_file(ours, back, CFG, device=CPU)
    with open(back, "rb") as f:
        assert f.read() == data


def test_writer_output_starts_roundtrip(tmp_path):
    """Decode-side region reconstruction equals the encoder's partition:
    nominal + overlap, clamped monotonic."""
    _, data = _make_input(tmp_path, 800)
    buf = np.frombuffer(data, np.uint8)
    regions = partition_regions(buf, 4, CFG)
    foot = footermod.read_footer(compress_bytes(data, CFG, 4, device=CPU))
    assert writer_output_starts(foot) == [r.start for r in regions]
    assert writer_output_starts(foot) == jdecompress.writer_output_starts(foot)


def test_flat_memory_compress_decompress(tmp_path):
    """Python-level allocations held by the drivers do not scale with the
    input: the peak traced allocation for a 4x bigger input stays within
    2x."""

    def peak_bytes(n_records):
        in_path, data = _make_input(tmp_path, n_records, seed=1)
        out_path = str(tmp_path / f"o{n_records}.ngsct")
        back_path = str(tmp_path / f"b{n_records}.fastq")
        # warm up: the first call's one-time allocations are not measured
        compress_file(in_path, out_path, CFG, n_writers=1, device=CPU)
        tracemalloc.start()
        compress_file(in_path, out_path, CFG, n_writers=1, device=CPU)
        _, peak_c = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        tracemalloc.start()
        decompress_file(out_path, back_path, CFG, device=CPU)
        _, peak_d = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        with open(back_path, "rb") as f:
            assert f.read() == data
        return peak_c, peak_d

    small_c, small_d = peak_bytes(2000)
    big_c, big_d = peak_bytes(8000)
    assert big_c < 2 * small_c + (1 << 20), (small_c, big_c)
    assert big_d < 2 * small_d + (1 << 20), (small_d, big_d)


def test_empty_and_tiny_inputs(tmp_path):
    for n in (0, 1, 5):
        data = synthesize_fastq(n, read_len=36, style="ERR005195", seed=2)
        in_path = tmp_path / f"tiny{n}.fastq"
        in_path.write_bytes(data)
        out_path = str(tmp_path / f"tiny{n}.ngsct")
        back_path = str(tmp_path / f"tiny{n}.back")
        compress_file(str(in_path), out_path, CFG, n_writers=2, device=CPU)
        with open(out_path, "rb") as f:
            assert f.read() == jcompress.compress_bytes(data, CFG, 2)
        decompress_file(out_path, back_path, CFG, device=CPU)
        with open(back_path, "rb") as f:
            assert f.read() == data


@pytest.mark.parametrize("chosen", [{1}, {0, 2}])
def test_writer_filter_decodes_the_chosen_regions(tmp_path, chosen):
    """writer_filter decodes exactly the chosen writers' regions of the
    output, chunk for chunk as phyngsc_tpu's writer filter does."""
    _, data = _make_input(tmp_path, 3000, seed=5)
    blob = compress_bytes(data, CFG, 3, device=CPU)
    foot = footermod.read_footer(blob)
    starts = writer_output_starts(foot) + [foot.fastq_size]
    got, ref = [], []
    _decode_stream(blob, foot, CFG, lambda o, c: got.append((o, c)), CPU,
                   writer_filter=chosen)
    jdecompress._decode_stream(blob, foot, CFG,
                               lambda o, c: ref.append((o, c)),
                               writer_filter=chosen)
    assert got == ref
    for w in range(3):
        mine = sorted((o, c) for o, c in got if starts[w] <= o < starts[w + 1])
        if w not in chosen:
            assert not mine
            continue
        assert mine[0][0] == starts[w]
        assert b"".join(c for _, c in mine) == data[starts[w]:starts[w + 1]]

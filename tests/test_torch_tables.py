"""ops/tables, the decode's walk tables built from code lengths, against
phyngsc_tpu's: lut_runs_plain and luts_from_lens_plain equal the JAX
package's lut_runs_device and luts_from_lens_device exactly, and the
port's huffman.decode_lut_batch but past the Kraft end of an incomplete
code of all 256 symbols, where the JAX package's device build repeats the
last code's entry (no well-formed stream reads there); two_level_plain,
from the host's
two_level_layout, equals bitpack.two_level_luts (bytes, k and n_primary)
at the walks' budgets and at budgets small enough to force the shared
block and k = 0; the two-stream build (walk_luts_both, one K6 launch a
sub-block on a card) gives each stream what the single-stream build gives
at lut_bits 8-16, and the decode calls it once per sub-block per shard; a
code length of 16 raises ValueError before anything is uploaded; and the
round trips decode with the host LUT functions patched to raise, from
containers equal to the JAX package's. Tolerance 0 throughout
(integer tables)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import kernels
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import bitpack, bitpack_host, huffman, tables
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from test_torch_pipeline import _huffman_dna_input, _parsed
from torch_table_cases import (KINDS, SMALL_BUDGETS, TWO_LEVEL,
                               TWO_STREAM_BITS, TWO_STREAMS, trees,
                               two_streams, wire_pieces)
from torch_time_limit import time_limit

_limit = time_limit(60)
def _words(lens, sing):
    w = bitpack_host.pack_lens4_np(lens, sing).view(np.int32)
    return torch.from_numpy(w), w.view(np.uint32)


def _host_luts(lens, sing, bits):
    sym, ln = huffman.decode_lut_batch(lens, bits, sing)
    return (ln.astype(np.int32) << 9) | sym.astype(np.int32)


def _open_tails(lens, sing, bits):
    """decode_lut_batch's LUTs with the JAX package's device build's one
    difference: an incomplete code of all 256 symbols repeats its last
    code's entry past its Kraft end (no absent symbol's delta zeroes it).
    Returns (those LUTs, how many trees have such a tail)."""
    luts = _host_luts(lens, sing, bits)
    n = 0
    for t in range(lens.shape[0]):
        ln = lens[t].astype(np.int64)
        end = int(np.sum((1 << (bits - ln)) * (ln > 0)))
        if sing[t] < 0 and (ln > 0).all() and end < 1 << bits:
            luts[t, end:] = luts[t, end - 1]
            n += 1
    return luts, n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("T", [1, 36, 128])
def test_luts_from_lens_match_jax(T, bits, kind):
    lens, sing = trees(T, bits, kind, seed=T * 31 + bits)
    if kind == "long codes":
        assert int(lens.max()) == bits
    if kind == "all 256":
        assert (lens > 0).all()
    V = 1 << bits
    words, u32 = _words(lens, sing)
    start, deltas = tables.lut_runs_plain(words, words[T * 32:], T, V)
    j_start, j_deltas = jbitpack.lut_runs_device(
        jnp.asarray(u32[:T * 32]), jnp.asarray(u32[T * 32:]), T, V)
    assert start.dtype == deltas.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(j_deltas))
    full = tables.luts_from_lens_plain(words, words[T * 32:], T, V)
    assert full.dtype == torch.int32 and full.shape == (T, V)
    np.testing.assert_array_equal(full.numpy(), np.asarray(
        jbitpack.luts_from_lens_device(jnp.asarray(u32[:T * 32]),
                                       jnp.asarray(u32[T * 32:]), T, V)))
    host, open_tails = _open_tails(lens, sing, bits)
    np.testing.assert_array_equal(full.numpy(), host)
    if kind != "long codes" or bits == 8:
        assert open_tails == 0
        np.testing.assert_array_equal(full.numpy(),
                                      _host_luts(lens, sing, bits))


def _two_level_case(T, bits, kind, budget):
    lens, sing = trees(T, bits, kind, seed=T + 7)
    words, _ = _words(lens, sing)
    full = tables.luts_from_lens_plain(words, words[T * 32:], T, 1 << bits)
    lay = tables.two_level_layout(lens, sing, bits, budget)
    got = tables.two_level_plain(full, torch.from_numpy(lay.trees), lay,
                                 bits)
    want, k, n_primary = bitpack.two_level_luts(full.numpy(), bits, budget)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want.view(np.int16))
    assert (lay.k, lay.n_primary, lay.n) == (k, n_primary, want.size)
    return lay


@pytest.mark.parametrize("kind", ["zipf", "long codes", "incomplete"])
@pytest.mark.parametrize("n_ids,T", TWO_LEVEL)
def test_two_level_matches_host_build(n_ids, T, kind):
    """At kernels.table_budget(n_ids), as the decode sizes it."""
    lay = _two_level_case(T, 12, kind, kernels.table_budget(n_ids))
    assert lay.k > 0


@pytest.mark.parametrize("budget", SMALL_BUDGETS)
@pytest.mark.parametrize("kind", ["zipf", "long codes"])
def test_two_level_small_budgets(kind, budget):
    _two_level_case(36, 12, kind, budget)


def test_small_budgets_reach_every_branch():
    """Across SMALL_BUDGETS: a table with a block for every escaped prefix,
    one with the shared block, and none."""
    seen = set()
    for kind in ("zipf", "long codes"):
        for budget in SMALL_BUDGETS:
            lay = _two_level_case(36, 12, kind, budget)
            seen.add("none" if lay.k == 0 else "shared"
                     if lay.n_blocks > lay.own else "own")
    assert seen == {"own", "shared", "none"}


@pytest.mark.parametrize("bits", [8, 12])
def test_walk_luts_match_host_walk_luts(bits):
    """tables.walk_luts on the CPU gives bitpack.walk_luts' full LUTs, and
    walk_luts_plain the WalkLuts bitpack.walk_tables builds for a card."""
    lens, sing = trees(36, bits, "zipf", seed=5)
    wire = tables.lens_wire(lens, sing, bits, 36)
    words, rows = (torch.from_numpy(p) for p in wire.pieces())
    host = _host_luts(lens, sing, bits)
    cpu = tables.walk_luts(wire, words, rows)
    assert cpu.packed is None and cpu.lut_bits == bits
    np.testing.assert_array_equal(cpu.full.numpy(), host)
    card = tables.walk_luts_plain(wire, words, rows)
    full, packed, k, n_primary = bitpack.walk_tables(host, bits, True, 36)
    np.testing.assert_array_equal(card.full.numpy(), full)
    np.testing.assert_array_equal(card.packed.numpy(), packed)
    assert (card.k, card.n_primary) == (k, n_primary)


@pytest.mark.parametrize("bits", TWO_STREAM_BITS)
@pytest.mark.parametrize("T,kind,n_ids,dna_kind", TWO_STREAMS)
def test_walk_luts_both_match_single_stream(T, kind, n_ids, dna_kind, bits):
    """walk_luts_both on the CPU gives each stream exactly what the
    single-stream walk_luts gives, walk_luts_plain's full LUTs and the JAX
    package's luts_from_lens_device; its layouts are two_level_luts' (the
    card's test holds K6's one launch to walk_luts_plain on them). Code
    lengths are capped at 15, the nibble's largest."""
    q, d = two_streams(T, kind, n_ids, dna_kind, bits)
    if (T, kind) == (128, "long codes") and bits == 12:
        lay = q[0].layout
        assert lay.k > 0 and lay.n_blocks > lay.own  # the shared block
    got = tables.walk_luts_both(q, d)
    assert (got[1] is None) == (d is None)
    for pieces, wl in zip((q, d), got):
        if pieces is None:
            continue
        wire, words, rows = pieces
        n = wire.n_trees
        assert wl.lut_bits == bits and wl.packed is None
        assert torch.equal(wl.full, tables.walk_luts(wire, words, rows).full)
        plain = tables.walk_luts_plain(wire, words, rows)
        assert torch.equal(wl.full, plain.full)
        u32 = wire.words.view(np.uint32)
        np.testing.assert_array_equal(wl.full.numpy(), np.asarray(
            jbitpack.luts_from_lens_device(jnp.asarray(u32[:n * 32]),
                                           jnp.asarray(u32[n * 32:]), n,
                                           1 << bits)))
        budget = kernels.table_budget(n_ids if pieces is q else 1)
        want, k, n_primary = bitpack.two_level_luts(wl.full.numpy(), bits,
                                                    budget)
        np.testing.assert_array_equal(plain.packed.numpy(),
                                      want.view(np.int16))
        assert (plain.k, plain.n_primary) == (k, n_primary)


def test_walk_luts_both_needs_one_lut_bits():
    lens, sing = trees(2, 8, "zipf", seed=1)
    with pytest.raises(ValueError, match="lut_bits"):
        tables.walk_luts_both(wire_pieces(lens, sing, 8, 0),
                              wire_pieces(lens, sing, 12, 0))


def test_empty_stream_takes_one_empty_tree():
    """No quality trees: one all-zero tree, the JAX package's
    pack_lens4_np(zeros((1, 256)), [-1])."""
    wire = tables.lens_wire(np.zeros((0, 256), np.uint8),
                            np.zeros(0, np.int32), 12, 36)
    want = jbitpack.pack_lens4_np(np.zeros((1, 256), np.uint8),
                                  np.array([-1], np.int32))
    np.testing.assert_array_equal(wire.words.view(np.uint32), want)
    words = torch.from_numpy(wire.words)
    full = tables.walk_luts(wire, words, words[:0]).full
    assert full.shape == (1, 4096) and not full.any()


def test_code_length_16_raises_before_upload(monkeypatch):
    """A length of 16 (the nibble + 1 that load_table admits) raises
    ValueError in the wire form, as tests/test_fuzz.py holds the JAX
    package's; in a container, the parse's check rejects it first, and
    without that check the wire form does, before any upload."""
    worst = np.zeros((1, 256), np.uint8)
    worst[0, 0] = 16
    for pack in (bitpack_host.pack_lens4_np, jbitpack.pack_lens4_np):
        with pytest.raises(ValueError, match="code length"):
            pack(worst, np.array([-1], np.int32))
    with pytest.raises(ValueError, match="code length"):
        tables.lens_wire(worst, [-1], 12)

    data = synthesize_fastq(200, read_len=36, seed=41)
    cfg = CodecConfig(subblock_input_bytes=1 << 20, records_per_substream=16)
    blob = compress_bytes(data, cfg, 1, device="cpu")
    orig = quality.read_header

    def poison(br):
        q_tables, sub, total = orig(br)
        q_tables.lens[0, q_tables.lens[0].argmax()] = 16
        return q_tables, sub, total

    uploads = []
    monkeypatch.setattr(quality, "read_header", poison)
    monkeypatch.setattr(subblock, "_to_device",
                        lambda a, device: uploads.append(a))
    with pytest.raises(ValueError, match="code length"):
        decompress_bytes(blob, cfg, device="cpu")
    monkeypatch.setattr(subblock, "_check_tables", lambda *a: None)
    with pytest.raises(ValueError, match="code length >= 16"):
        decompress_bytes(blob, cfg, device="cpu")
    assert uploads == []


def _no_host_luts(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a decode path built a LUT on the host")

    monkeypatch.setattr(quality.QualityTables, "luts", refuse)
    monkeypatch.setattr(dna.DnaPlan, "luts", refuse)
    monkeypatch.setattr(bitpack, "walk_tables", refuse)


KW = dict(subblock_input_bytes=64 << 10, records_per_substream=16)
CORPORA = {
    "ERR005195 36 bp": (lambda: synthesize_fastq(1500, read_len=36, seed=61,
                                                 ambiguity_rate=0.01), KW),
    "variable 100 bp": (lambda: synthesize_fastq(
        600, read_len=100, seed=62, variable_length=True), KW),
    "1000 bp": (lambda: synthesize_fastq(60, read_len=1000, seed=63),
                dict(subblock_input_bytes=64 << 10, records_per_substream=8)),
    "Huffman DNA": (lambda: _huffman_dna_input(600, 76, seed=64), KW),
    "2 shards": (lambda: synthesize_fastq(1500, read_len=36, seed=65),
                 dict(KW, data_shards=2)),
}


@pytest.mark.parametrize("corpus", ["Huffman DNA", "2 shards"])
def test_round_trip_builds_tables_once_a_subblock(monkeypatch, corpus):
    """decode_lanes builds both streams' tables in one call of
    walk_luts_both (one K6 launch on a card) per decoded sub-block per
    shard, the Huffman-DNA sub-blocks included."""
    build, kw = CORPORA[corpus]
    data = build()
    cfg = CodecConfig(**kw)
    stats = []
    blob = compress_bytes(data, cfg, 1, device="cpu", stats_out=stats)
    n_sub = sum(st.n_subblocks for st in stats)
    streams = []
    both = tables.walk_luts_both

    def counted(q, d=None):
        streams.append(1 if d is None else 2)
        return both(q, d)

    monkeypatch.setattr(tables, "walk_luts_both", counted)
    assert decompress_bytes(blob, cfg, device="cpu") == data
    assert len(streams) == cfg.data_shards * n_sub > cfg.data_shards
    huffman = [p.d_plan.mode == dna.MODE_HUFFMAN for p in _parsed(blob)]
    assert streams == [1 + h for h in huffman for _ in range(cfg.data_shards)]
    assert any(huffman) == (corpus == "Huffman DNA")


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_round_trip_builds_no_host_lut(monkeypatch, corpus):
    """The port's containers equal the JAX package's, and decode to the
    input with QualityTables.luts, DnaPlan.luts and bitpack.walk_tables
    raising: the decode's tables come from the code lengths alone."""
    build, kw = CORPORA[corpus]
    data = build()
    blob = compress_bytes(data, CodecConfig(**kw), 1, device="cpu")
    assert blob == jax_compress(data, JaxConfig(**kw), 1)
    parsed = _parsed(blob)
    if corpus == "Huffman DNA":
        assert any(p.d_plan.mode == dna.MODE_HUFFMAN for p in parsed)
    if corpus == "variable 100 bp":
        assert all(p.variable for p in parsed)
    _no_host_luts(monkeypatch)
    assert decompress_bytes(blob, CodecConfig(**kw), device="cpu") == data

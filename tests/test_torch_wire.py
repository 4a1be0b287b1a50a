"""The port's host<->device wire on the single-device path, against
phyngsc_tpu's: containers equal the JAX package's on the corpora of its
packed-fetch tests (edge alphabets, qual8 at 1% IUPAC, 60% IUPAC), each
sub-block decoding through the packed fetch (qual8 where the JAX package
takes it), with the native decode tail and without it; the fetch's
alphabets equal the JAX parse's; and under the PHYNGSC_TIMING sink the
compress uploads the packed live rows in one copy and fetches 32-bit
words, the decode uploads each sub-block's inputs in one copy within 5%
of the container and fetches the packed live rows."""

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig
from phyngsc_tpu.ops import bitpack as jbitpack
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch.models import dna
from phyngsc_tpu_torch.ops import transfer
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils import native
from test_torch_pipeline import _huffman_dna_input, _parsed, _solid_input
from torch_time_limit import time_limit

_limit = time_limit(60)
EDGE_CFG = CodecConfig(subblock_input_bytes=1 << 21,
                       max_records_per_subblock=2048)
IUPAC_CFG = CodecConfig(subblock_input_bytes=256 << 10,
                        records_per_substream=8)


def _edge_fastq(seq_alpha, qlo, qhi, n=900, L=31):
    """tests/test_roundtrip.py test_packed_output_fetch_edge_alphabets'
    corpora, one generator a corpus."""
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        s = rng.choice(np.frombuffer(seq_alpha, np.uint8), size=L).tobytes()
        q = rng.integers(qlo, qhi + 1, L).astype(np.uint8).tobytes()
        recs.append(b"@r%d x\n%s\n+\n%s\n" % (i, s, q))
    return b"".join(recs)


def _iupac_fastq(n, rate, seed=0, read_len=36):
    """tests/test_roundtrip.py's _iupac_fastq."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNYRWSKMDVHB", np.uint8)
    probs = np.full(15, rate / 11)
    probs[:4] = (1 - rate) / 4
    recs = []
    for i in range(n):
        seq = rng.choice(alphabet, size=read_len, p=probs)
        qual = rng.integers(33, 41, size=read_len).astype(np.uint8)
        recs.append(b"@ex%d\n" % i + seq.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    return b"".join(recs)


#: name -> (input, config, qual8 expected in every sub-block)
CORPORA = {
    "ACGT, 6-bit quality": (lambda: _edge_fastq(b"ACGT", 33, 73), EDGE_CFG,
                            False),
    "ACGTN, quality to 126": (lambda: _edge_fastq(b"ACGTN", 33, 126),
                              EDGE_CFG, False),
    "wide IUPAC": (lambda: _edge_fastq(b"ACGTNRYSWKMBDHV", 35, 40), EDGE_CFG,
                   True),
    "qual8 at 1% IUPAC": (lambda: _iupac_fastq(800, 0.01, seed=41),
                          IUPAC_CFG, True),
    "60% IUPAC": (lambda: _iupac_fastq(600, 0.6, seed=42), IUPAC_CFG, True),
}


def _spy_fetch(monkeypatch) -> list:
    """Record each decoded sub-block's _OutMeta (None: raw planes)."""
    seen = []
    stage_a = subblock.decode_stage_a

    def spy(*args, **kwargs):
        st = stage_a(*args, **kwargs)
        seen.append(st.out_meta)
        return st

    monkeypatch.setattr(subblock, "decode_stage_a", spy)
    return seen


@pytest.mark.parametrize("writers", [1, 2])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_containers_and_packed_fetch(monkeypatch, corpus, writers):
    build, cfg, qual8 = CORPORA[corpus]
    data = build()
    blob = compress_bytes(data, cfg, writers, device="cpu")
    assert blob == jax_compress(data, cfg, writers)
    seen = _spy_fetch(monkeypatch)
    assert decompress_bytes(blob, cfg, device="cpu") == data
    assert seen and all(m is not None for m in seen), \
        "a sub-block fetched raw planes"
    assert all(m.qual8 == qual8 for m in seen)
    # the same fetch unpacked by the numpy fallback
    monkeypatch.setattr(native, "decode_tail", lambda *a, **k: None)
    assert decompress_bytes(blob, cfg, device="cpu") == data


@pytest.mark.parametrize("corpus", list(CORPORA) + ["Huffman DNA", "SOLiD"])
def test_fetch_alphabets_are_the_jax_parse(corpus):
    if corpus == "Huffman DNA":
        data, cfg = _huffman_dna_input(500, 36, 64), IUPAC_CFG
    elif corpus == "SOLiD":
        data, cfg = _solid_input(300, 65), IUPAC_CFG
    else:
        build, cfg, _ = CORPORA[corpus]
        data = build()
    blob = compress_bytes(data, cfg, 1, device="cpu")
    parsed = _parsed(blob)
    payloads = [b for b in _payloads(blob)]
    assert len(payloads) == len(parsed)
    for p, payload in zip(parsed, payloads):
        j = jsubblock._decode_parse(payload, cfg)
        for name in ("out_alpha", "d_alpha"):
            a, b = getattr(p, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert p.q6 == j.q6
        assert subblock._qual8_mode(p) == jsubblock._qual8_mode(j)
        assert (subblock._out_meta(p) is None) == (
            j.out_alpha is None or bool(j.is_delta))


def _payloads(blob):
    from phyngsc_tpu.container import block as blockmod
    from phyngsc_tpu.container import footer as footermod

    foot = footermod.read_footer(blob)
    sizes = foot.block_sizes_in_file_order()
    offs = np.concatenate([[0], np.cumsum(sizes)])
    blocks = ((w, blob[offs[i]:offs[i + 1]]) for i, w in enumerate(foot.cbo))
    return [p for _, p in blockmod.iter_subblocks(blocks)]


def _padded(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def test_compress_wire_bytes(monkeypatch):
    """h2d: the packed words of each sub-block's live rows in one copy
    behind a 16-byte header (the live record count) plus stage B's fused
    tables and window origins; d2h: the counts and 4 B a word of the
    stage-B blob up to the exact caps; the container is the JAX
    package's."""
    data = synthesize_fastq(3000, read_len=36, seed=95, ambiguity_rate=0.01)
    cfg = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=16)
    words, tables, fetched, modes, copies = [], [], [], [], []
    for name in ("pack_seq_np", "pack_qual_np"):
        pack = getattr(transfer, name)

        def spy(plane, pack=pack, name=name):
            mode, w = pack(plane)
            words.append(w.nbytes)
            modes.append((name, plane.shape[0], mode))
            return mode, w

        monkeypatch.setattr(transfer, name, spy)
    together = subblock._upload_together

    def spy_together(arrays, device, **kw):
        tables.append(sum(_padded(a.nbytes) for a in arrays))
        return together(arrays, device, **kw)

    stage_c = subblock.stage_c

    def spy_c(b, cfg):
        nqw, ndw, S = b.blob_layout
        fetched.append(4 * (nqw + ndw + 2 * S + 2)
                       + 4 * (b.a.n_q_counts + 256))
        return stage_c(b, cfg)

    to_device = subblock._to_device

    def spy_to_device(a, device):
        copies.append(a.nbytes)
        return to_device(a, device)

    monkeypatch.setattr(subblock, "_upload_together", spy_together)
    monkeypatch.setattr(subblock, "stage_c", spy_c)
    monkeypatch.setattr(subblock, "_to_device", spy_to_device)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    blob = compress_bytes(data, cfg, 1, device="cpu")
    sink = dict(subblock.TIMING)
    assert blob == jax_compress(data, cfg, 1)
    n_sub = len(fetched)
    assert n_sub >= 3 and len(tables) == n_sub and len(words) == 2 * n_sub
    assert len(copies) == 2 * n_sub  # the words, then the tables
    assert sink["h2d_bytes"] == sum(words) + 16 * n_sub + sum(tables)
    assert sink["d2h_bytes"] == sum(fetched)
    # live rows only: each plane packed is (R, L), R the sub-block's records
    seq = [(rows, m) for name, rows, m in modes if name == "pack_seq_np"]
    assert sum(rows for rows, _ in seq) == data.count(b"\n+\n")
    assert transfer.SEQ_2BIT_EXC in {m for _, m in seq} <= {
        transfer.SEQ_2BIT, transfer.SEQ_2BIT_EXC}
    assert {m for name, _, m in modes if name == "pack_qual_np"} == {
        transfer.QUAL_6BIT}


@pytest.mark.parametrize("corpus", ["uniform", "variable", "sharded"])
def test_decode_wire_bytes(monkeypatch, corpus):
    """One host-to-device copy a sub-block (a shard, sharded) whose bytes
    are the h2d count, each piece at a 16-byte offset; the walk tables
    travel as the JAX package's pack_lens4_np words of the quality trees
    (and of the DNA tree in Huffman mode), each beside its layout rows;
    d2h: the packed live rows (_out_fetch_words over R * L cells), or the
    raw planes of each shard."""
    data = synthesize_fastq(
        2000, read_len=100 if corpus == "variable" else 36, seed=96,
        ambiguity_rate=0.01, variable_length=corpus == "variable")
    shards = 2 if corpus == "sharded" else 1
    cfg = CodecConfig(subblock_input_bytes=64 << 10, records_per_substream=16,
                      data_shards=shards)
    blob = compress_bytes(data, cfg, 1, device="cpu")
    parsed = _parsed(blob)
    copies, pieces = [], []
    to_device = subblock._to_device

    def spy_to_device(a, device):
        copies.append(a.nbytes)
        pieces.append([np.array(v) for v in a.views])
        return to_device(a, device)

    seen = _spy_fetch(monkeypatch)
    monkeypatch.setattr(subblock, "_to_device", spy_to_device)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    assert decompress_bytes(blob, cfg, device="cpu") == data
    sink = dict(subblock.TIMING)
    assert len(copies) == shards * len(parsed) and len(seen) == len(parsed)
    assert sink["h2d_bytes"] == sum(copies)
    for i, (up, nbytes) in enumerate(zip(pieces, copies)):
        p = parsed[i // shards]
        q_lens4 = jbitpack.pack_lens4_np(p.q_tables.lens,
                                         p.q_tables.singletons)
        assert sum(-(-v.nbytes // 16) * 16 for v in up) == nbytes
        lens4 = [v.view(np.uint32) for v in up
                 if v.dtype == np.int32 and v.ndim == 1
                 and v.size % 33 == 0 and v.size]
        assert any(np.array_equal(w, q_lens4) for w in lens4)
        rows = [v for v in up if v.dtype == np.int32 and v.ndim == 2]
        assert [r.shape[0] for r in rows] == [3] * (
            1 + (p.d_plan.mode != dna.MODE_PLAIN))
        if p.d_plan.mode != dna.MODE_PLAIN:
            assert any(np.array_equal(w, jbitpack.pack_lens4_np(
                p.d_plan.lens_tab[None, :],
                np.array([p.d_plan.singleton], np.int32))) for w in lens4)
    if corpus == "sharded":
        assert all(m is None for m in seen)
        want = sum(2 * p.Rp * p.L for p in parsed)
    else:
        assert all(m is not None and m.qual8 for m in seen)
        want = sum(4 * sum(subblock._out_fetch_words(p.R * p.L, m.w, m.q6))
                   for p, m in zip(parsed, seen))
    assert sink["d2h_bytes"] == want


def test_decompress_h2d_within_5pct_of_payload(monkeypatch):
    """tests/test_roundtrip.py's contract for the JAX package's fused
    decode upload, on its corpus: the port's one copy a sub-block (the
    words, lane tables, the walk tables' code lengths, decode tables)
    stays within 5% of the container."""
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    data = synthesize_fastq(60000, read_len=36, seed=13,
                            ambiguity_rate=0.005)
    cfg = CodecConfig(subblock_input_bytes=1 << 30,
                      max_records_per_subblock=1 << 16,
                      records_per_substream=64)
    comp = compress_bytes(data, cfg, 1, device="cpu")
    assert decompress_bytes(comp, cfg, device="cpu") == data
    h2d = subblock.TIMING["h2d_bytes"]
    assert 0 < h2d <= len(comp) * 1.05, (h2d, len(comp))

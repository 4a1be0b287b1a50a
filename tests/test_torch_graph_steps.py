"""The sub-block stages as step functions of static shapes (the port of
phyngsc_tpu's one executable a stage), on the CPU: analyze_all,
encode_all and decode_walk_fused against the JAX package's _analyze_all,
_encode_all and decode on the same sub-blocks; containers byte-identical
to phyngsc_tpu's with the shape buckets at 1 and 2 writers, on the steps
directly and through graphs.Runner with a stand-in capture backend that
recomputes each "replay" into the captured outputs (so a step that read a
stale part of its static input would change the bytes); the key rule
(one key for one bucket, another for another Rp or DNA mode, picked in
task order) and the leases (no instance held by two tasks at once,
eviction within the byte budget). Exact equality throughout."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.ops import transfer as jtransfer
from phyngsc_tpu.pipeline import subblock as jsubblock
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu_torch import graphs
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import dna, quality
from phyngsc_tpu_torch.ops import lookup, transfer
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils.fastq import index_records, synthesize_fastq
from phyngsc_tpu_torch.utils.shapes import bucket_length, bucket_records
from test_torch_pipeline import _huffman_dna_input, _parsed, _solid_input
from torch_time_limit import time_limit

_limit = time_limit(60)
CPU = torch.device("cpu")
G = 16


class StubBackend:
    """graphs.Runner's capture backend on the CPU: a capture runs the step
    once (its outputs become the instance's static outputs), a replay runs
    it again on the static inputs and copies the result into them (but
    the replay right after its capture, on the inputs it was captured on,
    whose outputs are the capture's). Its pools hold no bytes, a static
    input its numel, and the give-backs are counted."""

    def __init__(self):
        self.captures = self.give_backs = 0

    def budget(self):
        return 16 << 30

    def held_bytes(self, device, pools, tensors=()):
        return [0] * len(pools) + [sum(t.numel() for t in tensors)]

    def give_back(self):
        self.give_backs += 1

    def capture(self, fn, device, pool):
        self.captures += 1
        out = fn()
        return [fn, out, True], out, []

    def replay(self, graph):
        fn, out, fresh = graph
        graph[2] = False
        if not fresh:
            _copy_into(out, fn())

    def pool(self, graph):
        return id(graph)

    def record(self, device):
        return None

    def wait(self, event, device):
        pass

    def synchronize(self, event):
        pass


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


@pytest.fixture
def stub_runner(monkeypatch):
    runner = graphs.Runner(StubBackend())
    monkeypatch.setattr(graphs, "CPU_RUNNER", runner)
    return runner


def _planes(data: bytes):
    """(seq, qual (R, L) uint8, lens (R,) int32, L, Lt) of `data`, gathered
    as stage A gathers them."""
    buf = np.frombuffer(data, np.uint8)
    idx = index_records(buf)
    lens = idx.seq_len.astype(np.int32)
    Lt = int(lens.max())
    L = bucket_length(Lt)
    seq, qual = (subblock._gather_matrix(buf, s, lens.astype(np.int64), L)
                 for s in (idx.seq_start, idx.qual_start))
    return seq, qual, lens, L, Lt


def _stage_a(seq, qual, lens, L, Lt, Rp):
    st = subblock._StageA()
    st.R, st.L, st.Lt, st.Rp, st.lens_np = seq.shape[0], L, Lt, Rp, lens
    st.W = L
    st.is_delta = dna.detect_delta(seq, lens)
    counts = subblock._analyze_device(st, seq, qual, CPU)
    return st, counts


ANALYZE_CASES = {
    # name: (input, records per sub-block: R < Rp, or R == Rp)
    "2-bit, R < Rp": (lambda: synthesize_fastq(700, seed=201), 700),
    "2-bit + 2048 exception words": (lambda: synthesize_fastq(
        4000, seed=202, ambiguity_rate=0.01), 4000),
    "variable lengths": (lambda: synthesize_fastq(
        600, read_len=100, seed=203, variable_length=True), 600),
    "SOLiD": (lambda: _solid_input(512, seed=204), 512),
    "raw quality, Huffman DNA": (lambda: _huffman_dna_input(512, 36, 205),
                                 512),
}


@pytest.mark.parametrize("case", list(ANALYZE_CASES))
def test_analyze_all_matches_jax(case):
    """analyze_all on the live rows' words and the live count equals
    _analyze_all on the same sub-block packed at Rp rows: the planes where
    the records are (the JAX package leaves its packers' fill past them,
    the port zeros), keep and the counts, in every row."""
    build, _ = ANALYZE_CASES[case]
    seq, qual, lens, L, Lt = _planes(build())
    R = seq.shape[0]
    Rp = bucket_records(R, G)
    st, counts = _stage_a(seq, qual, lens, L, Lt, Rp)
    pad = ((0, Rp - R), (0, 0))
    s_mode, s_words = jtransfer.pack_seq_np(np.pad(seq, pad))
    q_mode, q_words = jtransfer.pack_qual_np(np.pad(qual, pad))
    assert (s_mode, q_mode) == st.key[3:5]
    if case.startswith("2-bit +"):
        assert s_mode == transfer.SEQ_2BIT_EXC and st.key.n_exc == 2048
    j_seq, j_qual_t, j_keep, j_counts = jsubblock._analyze_all(
        jax.device_put(np.concatenate([s_words, q_words])),
        jax.device_put(np.pad(lens, (0, Rp - R))), is_delta=st.is_delta,
        seq_mode=s_mode, qual_mode=q_mode, L=L,
        d_small=transfer.seq_alpha_small(s_mode, seq))
    valid = quality.valid_mask(st.lens, L).numpy()
    for got, want in ((st.seq, j_seq), (st.qual_t, j_qual_t)):
        np.testing.assert_array_equal(np.where(valid, got.numpy(), 0),
                                      np.where(valid, np.asarray(want), 0))
    np.testing.assert_array_equal(st.keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert st.lens.shape == (Rp,) and int(st.lens[R:].abs().sum()) == 0


@pytest.mark.parametrize("case", ["2-bit, R < Rp", "variable lengths",
                                  "raw quality, Huffman DNA"])
def test_encode_all_matches_jax(case):
    """encode_all at promoted caps (the worst case) equals _encode_all on
    the same planes and tables: each stream's words up to its total, the
    substream tables and the totals."""
    build, _ = ANALYZE_CASES[case]
    seq, qual, lens, L, Lt = _planes(build())
    Rp = bucket_records(seq.shape[0], G)
    st, counts = _stage_a(seq, qual, lens, L, Lt, Rp)
    cfg = CodecConfig()
    counts = counts.numpy()
    q_counts = counts[:min(L, quality.MAX_TREES) * 256].reshape(-1, 256)
    d_counts = counts[q_counts.size:]
    tabs, q_group = quality.build_tables_adaptive(q_counts, cfg)
    plan = dna.plan(d_counts, cfg)
    huff = plan.mode == dna.MODE_HUFFMAN
    assert huff == case.endswith("Huffman DNA")
    d_group = lookup.group_for(int(plan.lens_tab.max()) or 1) if huff else 2
    q_off, q_A = lookup.window_np(q_counts)
    codes, qlens = (t[:, q_off:q_off + q_A] for t in (tabs.codes, tabs.lens))
    tables = [torch.from_numpy(np.ascontiguousarray(a)) for a in
              quality.encode_tables(codes, qlens, L)]
    d_off, d_tab = 0, None
    d_codes, d_lens = plan.codes_tab, plan.lens_tab
    if huff:
        d_off, d_A = lookup.window_np(d_counts.reshape(1, -1))
        d_codes = plan.codes_tab[d_off:d_off + d_A]
        d_lens = plan.lens_tab[d_off:d_off + d_A]
        d_tab = torch.from_numpy(lookup.fused_table_np(
            d_codes[None], d_lens[None]).view(np.int16))
    cap = subblock._word_cap(Rp, L, G)
    got = subblock.encode_all(
        st.qual_t, st.keep, st.seq, st.lens, *tables, d_tab,
        torch.tensor([q_off, d_off], dtype=torch.int32), G=G, q_cap=cap,
        d_cap=cap, mode=plan.mode, q_group=q_group,
        d_group=d_group).numpy().view(np.uint32)
    want = np.asarray(jsubblock._encode_all(
        *(jnp.asarray(t.numpy()) for t in (st.qual_t, st.keep, st.seq,
                                           st.lens)),
        jnp.asarray(np.ascontiguousarray(codes)),
        jnp.asarray(np.ascontiguousarray(qlens)),
        jnp.asarray(np.ascontiguousarray(d_codes)),
        jnp.asarray(np.ascontiguousarray(d_lens)), plan.mode, G, cap, cap,
        q_group, d_group, "scatter", np.int32(q_off), np.int32(d_off)))
    S = Rp // G
    q_total, d_total = (int(x) for x in want[2 * cap + 2 * S:])
    assert [int(x) for x in got[2 * cap + 2 * S:]] == [q_total, d_total]
    np.testing.assert_array_equal(got[:q_total], want[:q_total])
    np.testing.assert_array_equal(got[cap:cap + d_total],
                                  want[cap:cap + d_total])
    np.testing.assert_array_equal(got[2 * cap:2 * cap + 2 * S],
                                  want[2 * cap:2 * cap + 2 * S])


DECODE_CASES = {
    "uniform, qual8": lambda: synthesize_fastq(900, seed=211,
                                               ambiguity_rate=0.01),
    "variable lengths": lambda: synthesize_fastq(
        500, read_len=100, seed=212, variable_length=True),
    "Huffman DNA": lambda: _huffman_dna_input(700, 36, 213),
    "SOLiD planes": lambda: _solid_input(600, seed=214),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_walk_fused_matches_jax(case):
    """decode_walk_fused over every row of each sub-block (its inputs at
    the promoted word capacity, plane heights and table layouts, the words
    past the live ones left as garbage), fetched as the decode fetches it
    (the live rows' prefix), gives the JAX package's decode_subblock of
    that sub-block."""
    data = DECODE_CASES[case]()
    cfg = CodecConfig(subblock_input_bytes=24 << 10,
                      records_per_substream=G)
    blob = compress_bytes(data, cfg, 1, device="cpu")
    from phyngsc_tpu_torch.container import block as blockmod
    from phyngsc_tpu_torch.container import footer as footermod
    from phyngsc_tpu_torch.utils.shapes import BucketCtx

    foot = footermod.read_footer(blob)
    offs = np.concatenate([[0], np.cumsum(foot.block_sizes_in_file_order())])
    payloads = [p for _, p in blockmod.iter_subblocks(
        (w, blob[offs[i]:offs[i + 1]]) for i, w in enumerate(foot.cbo))]
    assert len(payloads) >= 2
    buckets = BucketCtx()
    for payload in payloads:
        p = subblock._decode_parse(payload, cfg)
        meta = subblock._out_meta(p)
        assert (meta is None) == (case == "SOLiD planes")
        key, pieces, cap, wires = subblock._decode_inputs(
            p, cfg, 0, p.q_sub.shape[0], subblock.decode_wires(p, cfg),
            meta, buckets)
        assert cap >= pieces[-1].shape[0] and cap % (1 << 14) == 0
        specs = ([(a.shape, a.dtype) for a in pieces[:-1]]
                 + [((cap,), np.int32)])
        buf = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, size=subblock.layout_bytes(specs), dtype=np.uint8))
        subblock._upload_together(pieces, CPU, into=buf)
        out = subblock.decode_walk_fused(subblock.views(buf, specs), key,
                                         wires).numpy()
        if meta is None:
            seq, qual = out[0, :p.R], out[1, :p.R]
        else:
            n_sw, _ = subblock._out_fetch_words(key.rows * p.L, meta.w,
                                                meta.q6)
            s_live, q_live = subblock._out_fetch_words(p.R * p.L, meta.w,
                                                       meta.q6)
            words = np.concatenate([out[:s_live], out[n_sw:n_sw + q_live]])
            seq, qual = subblock._unpack_out(words.view(np.uint32), meta,
                                             p.R, p.L)
        got = subblock._reassemble(p.R, p.lens_np, p.titles_np, p.tlens_np,
                                   seq, qual)
        assert got == jsubblock.decode_subblock(
            payload, JaxConfig(records_per_substream=G))


def _tail_1000():
    return synthesize_fastq(700, read_len=1000, seed=223)


BYTES_CASES = {
    # name: (input, config)
    "uniform with a short tail": (lambda: synthesize_fastq(
        2300, seed=221, ambiguity_rate=0.01), dict(
            subblock_input_bytes=96 << 10)),
    "variable lengths": (lambda: synthesize_fastq(
        1200, read_len=100, seed=222, variable_length=True), dict(
            subblock_input_bytes=64 << 10)),
    "1000 bp": (_tail_1000, dict(subblock_input_bytes=256 << 10)),
    "SOLiD": (lambda: _solid_input(1500, seed=224), dict(
        subblock_input_bytes=48 << 10)),
    "Huffman DNA": (lambda: _huffman_dna_input(1800, 36, 225), dict(
        subblock_input_bytes=64 << 10)),
    "1025+ exceptions": (lambda: synthesize_fastq(
        3200, seed=226, ambiguity_rate=0.0092), dict(
            subblock_input_bytes=1 << 20)),
}


@pytest.mark.parametrize("runner", ["steps", "stub graphs"])
@pytest.mark.parametrize("writers", [1, 2])
@pytest.mark.parametrize("case", list(BYTES_CASES))
def test_bucketed_compress_matches_jax(monkeypatch, case, writers, runner):
    """compress_bytes with the encode caps promoted (BucketCtx) equals
    phyngsc_tpu.compress_bytes byte for byte and decodes back, on the steps
    directly and through a Runner whose replays recompute from the static
    buffers (every sub-block replaying an instance, each after a key's
    first one that earlier sub-blocks filled)."""
    build, kw = BYTES_CASES[case]
    data = build()
    if runner == "stub graphs":
        monkeypatch.setattr(graphs, "CPU_RUNNER", graphs.Runner(StubBackend()))
    if case == "1025+ exceptions":
        seen = []
        pack = transfer.pack_seq_np

        def spy(plane):
            mode, words = pack(plane)
            seen.append(words.shape[0] - transfer.n_words(
                plane.size, "seq", transfer.SEQ_2BIT))
            return mode, words

        monkeypatch.setattr(transfer, "pack_seq_np", spy)
    blob = compress_bytes(data, CodecConfig(**kw), writers, device="cpu")
    assert blob == jax_compress(data, JaxConfig(**kw), writers)
    assert decompress_bytes(blob, device="cpu") == data
    if case == "1025+ exceptions" and writers == 1:
        assert 2048 in seen
    if runner == "stub graphs":
        st = graphs.CPU_RUNNER.stats()
        n = len(_parsed(blob))
        for stage in ("analyze_all", "encode_all", "decode_walk_fused"):
            s = st[stage]
            # a key's first sight warms eagerly, then captures and replays
            assert s["replays"] == n
            assert s["eager"] == s["keys"] <= s["captures"]


def test_keys_follow_the_buckets(monkeypatch, stub_runner):
    """Sub-blocks of one record bucket and DNA mode share the stage keys
    (the short tail promoted), another Rp or DNA mode gives another key,
    and the keys, picked in task order on the driver's thread, are the same
    whatever the host pool's size."""
    keys = []
    lease = stub_runner.lease

    def spy(device, stage, key, *args):
        keys.append((stage, key))
        return lease(device, stage, key, *args)

    monkeypatch.setattr(stub_runner, "lease", spy)
    data = synthesize_fastq(2300, seed=231, ambiguity_rate=0.01)
    small = dict(subblock_input_bytes=96 << 10)
    runs = []
    for workers in (1, 6):
        keys.clear()
        blob = compress_bytes(data, CodecConfig(host_workers=workers,
                                                **small), 1, device="cpu")
        runs.append((blob, [k for s, k in keys if s == "analyze_all"],
                     {k.mode for s, k in keys if s == "encode_all"}))
    assert runs[0][0] == runs[1][0] and runs[0][2] == {dna.MODE_PLAIN}
    analyze = runs[0][1]
    assert len(analyze) == len(_parsed(runs[0][0])) >= 3
    assert len(set(analyze)) == 1 and sorted(analyze) == sorted(runs[1][1])
    keys.clear()
    compress_bytes(data, CodecConfig(subblock_input_bytes=1 << 20), 1,
                   device="cpu")
    assert {k.Rp for s, k in keys if s == "analyze_all"} != {analyze[0].Rp}
    keys.clear()
    compress_bytes(_huffman_dna_input(1800, 36, 232), CodecConfig(**small),
                   1, device="cpu")
    assert {k.mode for s, k in keys if s == "encode_all"} == {
        dna.MODE_HUFFMAN}
    st = stub_runner.stats()
    assert st["encode_all"]["keys"] >= 2


def test_leases_are_exclusive_and_bytes_bounded():
    """Eight threads lease one key over and over: an instance's buffer is
    never held by two at once. Keys past the byte budget evict the least
    recently released instances, counted."""
    runner = graphs.Runner(StubBackend(), budget=10 * 4096)
    held, lock, errors = set(), threading.Lock(), []

    def work():
        for _ in range(40):
            ls = runner.lease(CPU, "s", ("k",), 4096)
            ptr = ls.inputs.data_ptr()
            with lock:
                if ptr in held:
                    errors.append(ptr)
                held.add(ptr)
            ls.inputs.fill_(1)
            ls.run(lambda: ls.inputs.sum())
            time.sleep(0.0005)
            with lock:
                held.discard(ptr)
            ls.release()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    st = runner.stats()
    assert st["s"]["eager"] == 1 and st["s"]["replays"] == 8 * 40
    assert 1 <= st["instances"] <= 8 and st["evictions"] == 0
    for k in range(30):
        for _ in range(2):  # eager and captured, then replayed
            ls = runner.lease(CPU, "t", k, 4096)
            ls.run(lambda: ls.inputs.sum())
            ls.release()
        assert runner.stats()["graph_bytes"] <= runner.budget
    assert runner.stats()["evictions"] >= 20


def _sub_block(data: bytes, dev, buckets, rp=4096):
    """One sub-block's stages on `dev` at Rp = rp: (the payload, the decode
    fetch's words)."""
    cfg = CodecConfig(records_per_substream=G)
    buf = np.frombuffer(data, np.uint8)
    a = subblock.stage_a(buf, index_records(buf), cfg, dev, rp=rp)
    payload = subblock.stage_c(subblock.stage_b(a, cfg, None, buckets), cfg)
    d = subblock.decode_stage_a(payload, cfg, dev, buckets=buckets)
    return payload, d.blobs[0].result()


STALE = {
    "2048 exception words, then fewer": (
        lambda: synthesize_fastq(4000, seed=301, ambiguity_rate=0.0104),
        lambda: synthesize_fastq(3000, seed=302, ambiguity_rate=0.0102)),
    "variable lengths, 2000 records then 1500": (
        lambda: synthesize_fastq(2000, read_len=100, seed=304,
                                 variable_length=True),
        lambda: synthesize_fastq(1500, read_len=100, seed=304,
                                 variable_length=True)),
}


@pytest.mark.parametrize("case", list(STALE))
def test_replays_over_stale_buffers(stub_runner, case):
    """A sub-block, again, then a smaller one of the same keys (fewer
    exceptions, or fewer records of varying length) replays the instances
    the larger one filled: the payload and the decode fetch are the direct
    steps' (the steps read nothing past the new upload that matters)."""
    from phyngsc_tpu_torch.utils.shapes import BucketCtx

    big, small = (build() for build in STALE[case])
    buckets = BucketCtx()
    for data in (big, big, small):
        got = _sub_block(data, CPU, buckets)
        with graphs.direct():
            want = _sub_block(data, CPU, BucketCtx())
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    st = stub_runner.stats()
    assert st["analyze_all"] == {"eager": 1, "captures": 1, "replays": 3,
                                 "keys": 1}
    assert st["decode_walk_fused"] == {"eager": 1, "captures": 1,
                                       "replays": 3, "keys": 1}

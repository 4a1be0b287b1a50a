"""Long variable-length reads on the CPU, and the stage graphs' memory:
the ladder of plane widths (pipeline/subblock.py plane_length) gives
sub-blocks of long reads of any lengths a few stage keys, every key of a
long-read input is met again by its second compress and decompress (no
capture), the containers are still the JAX package's byte for byte and
the port and the benchmark's plain reference decode them to the input;
uniform and short variable lengths keep their keys; the decode counts
its walks on its spans; and graphs.Runner gives back what eviction and
broken instances free, within its budget (stand-in capture backend)."""

import numpy as np
import pytest
import torch

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu_torch import graphs
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import quality
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
from phyngsc_tpu_torch.utils import logging as tlog
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch.utils.shapes import bucket_length
from test_torch_graph_steps import StubBackend
from test_torch_pipeline import _parsed
from torch_long_reads import CFG, LONGEST, SHORTER, long_reads
from torch_time_limit import time_limit

_limit = time_limit(60)
CPU = torch.device("cpu")


# -- the ladder ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 5, 36, 257, 300, 1000, 1025, 4096,
                               35596, 40961, 65532, 65536])
def test_ladder_rungs(n):
    r = subblock.ladder(n)
    assert n <= r and subblock.ladder(r) == r
    if n > subblock.RUNGS:
        assert r * subblock.RUNGS < n * (subblock.RUNGS + 1)
    k = (n - 1).bit_length() - 1
    if k >= 8:
        assert r % 64 == 0
    # RUNGS rungs a doubling
    lo = 1 << max(k, 3)
    assert len({subblock.ladder(m) for m in range(lo + 1, 2 * lo + 1)}) \
        == subblock.RUNGS


def test_plane_length_ladders_only_long_variable_lengths():
    assert subblock.plane_length(36, False) == 36
    assert subblock.plane_length(1000, False) == 1000
    assert subblock.plane_length(100, True) == 100
    assert subblock.plane_length(quality.MAX_TREES, True) == 256
    assert subblock.plane_length(260, True) == 320
    assert subblock.plane_length(bucket_length(65532), True) == 65536
    assert subblock.plane_length(bucket_length(35596), True) == 40960
    rungs = {subblock.plane_length(L, True) for L in range(35596, 65533, 4)}
    assert rungs == {40960, 49152, 57344, 65536}


# -- the runner's memory ------------------------------------------------------

def _use(runner, key, nbytes=4096, ok=True):
    ls = runner.lease(CPU, "t", key, nbytes)
    ls.run(lambda: ls.inputs.sum())
    ls.release(ok)


def test_eviction_gives_back_what_it_frees(monkeypatch):
    """Ten keys of 4096 bytes each under a budget of three: graph_bytes
    stays at three instances after each release, falls back by what each
    eviction frees, freed_bytes counts it, peak_bytes is the fourth
    instance's moment over the budget, and each eviction is a g.evict span
    tagged with its stage and key."""
    backend = StubBackend()
    runner = graphs.Runner(backend, budget=3 * 4096 + 1)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with tlog.call("compress"):
        for k in range(10):
            before = runner.stats()
            _use(runner, k)
            st = runner.stats()
            evicted = st["evictions"] - before["evictions"]
            assert evicted == (1 if k >= 3 else 0)
            assert st["graph_bytes"] == 4096 * min(k + 1, 3)
            assert st["graph_bytes"] == (before["graph_bytes"] + 4096
                                         - 4096 * evicted)
            assert st["freed_bytes"] - before["freed_bytes"] == \
                4096 * evicted
    call = subblock.recorded_calls()[-1]
    st = runner.stats()
    assert st["evictions"] == 7 and st["freed_bytes"] == 7 * 4096
    assert st["peak_bytes"] == 4 * 4096 and st["instances"] == 3
    assert backend.give_backs == 7
    evicts = [s for s in call.spans if s.name == "g.evict"]
    assert [s.tag for s in evicts] == [f"t {k}" for k in range(7)]
    assert len([s for s in call.spans if s.name == "g.capture"]) == 10


def test_a_broken_instance_gives_back_its_bytes():
    """An instance released after a failure goes, and its bytes go back
    with it; the next sight of its key captures anew."""
    backend = StubBackend()
    runner = graphs.Runner(backend, budget=1 << 20)
    _use(runner, "k")
    assert runner.stats()["graph_bytes"] == 4096
    ls = runner.lease(CPU, "t", "k", 4096)
    ls.run(lambda: ls.inputs.sum())
    ls.release(ok=False)
    st = runner.stats()
    assert st["graph_bytes"] == 0 and st["freed_bytes"] == 4096
    assert st["evictions"] == 0 and backend.give_backs == 1
    _use(runner, "k")
    assert runner.stats()["t"]["captures"] == 2
    assert runner.stats()["peak_bytes"] == 4096


def test_reset_stats_keeps_the_held_bytes_as_the_peak():
    runner = graphs.Runner(StubBackend(), budget=1 << 20)
    _use(runner, 1)
    _use(runner, 2)
    runner.reset_stats()
    st = runner.stats()
    assert st["peak_bytes"] == st["graph_bytes"] == 2 * 4096
    assert st["freed_bytes"] == 0 and st["evictions"] == 0


# -- long reads on the ladder --------------------------------------------------

class _Spy:
    """The stage keys a runner is asked for, in order."""

    def __init__(self, monkeypatch, runner):
        self.keys = []
        lease = runner.lease

        def spy(device, stage, key, *args):
            self.keys.append((stage, key))
            return lease(device, stage, key, *args)

        monkeypatch.setattr(runner, "lease", spy)

    def of(self, stage):
        return [k for s, k in self.keys if s == stage]


@pytest.fixture(scope="module")
def long_run():
    """LONGEST compressed and decompressed twice through a runner on the
    stand-in backend, the second decompress recorded (PHYNGSC_TIMING):
    {data, passes: [{blob, back, keys, captures after it}], stats, the
    second decompress's recorded call}."""
    mp = pytest.MonkeyPatch()
    backend = StubBackend()
    runner = graphs.Runner(backend)
    mp.setattr(graphs, "CPU_RUNNER", runner)
    spy = _Spy(mp, runner)
    try:
        data = long_reads(LONGEST)
        cfg = CodecConfig(**CFG)
        out = {"data": data, "passes": []}
        for k in range(2):
            spy.keys.clear()
            blob = compress_bytes(data, cfg, 1, device="cpu")
            if k:
                mp.setenv("PHYNGSC_TIMING", "1")
            back = decompress_bytes(blob, cfg, device="cpu")
            out["passes"].append({"blob": blob, "back": back,
                                  "keys": list(spy.keys),
                                  "captures": backend.captures})
        out["call"] = subblock.recorded_calls()[-1]
        out["stats"] = runner.stats()
    finally:
        mp.undo()
    return out


def test_long_read_sub_blocks_take_ladder_keys(long_run):
    """Each sub-block's stage keys are at the ladder rung of its longest
    read (65,536 for the 65,532 bp read); the rungs are fewer than the
    sub-blocks' bucketed lengths; stage A's distinct keys are at most the
    distinct (Rp, rung) pairs, the ladder's bound; the encode caps and
    the decode's plane heights are rungs of the ladder too (stage B's and
    the decode's keys also hold each sub-block's table shapes)."""
    first = long_run["passes"][0]
    parsed = _parsed(first["blob"])
    assert len(parsed) == 5 and all(p.variable for p in parsed)
    assert max(p.Lt for p in parsed) == 65532 == max(LONGEST)
    rungs = [subblock.plane_length(p.L, True) for p in parsed]
    assert rungs == [3072, 65536, 5120, 2560, 2560]
    assert len({p.L for p in parsed}) > len(set(rungs))
    bound = len({(p.Rp, r) for p, r in zip(parsed, rungs)})
    keys = {s: {k for t, k in first["keys"] if t == s}
            for s in ("analyze_all", "encode_all", "decode_walk_fused")}
    # stage A leases on the pool's threads, in any order
    assert sorted(k.L for t, k in first["keys"] if t == "analyze_all") == \
        sorted(rungs)
    assert [k.L for t, k in first["keys"] if t == "decode_walk_fused"] == \
        rungs
    assert 1 <= len(keys["analyze_all"]) <= bound < len(parsed)
    assert {k.analyze for k in keys["encode_all"]} == keys["analyze_all"]
    ladder = subblock.ladder
    for k in keys["encode_all"]:
        assert ladder(k.q_cap) == k.q_cap and ladder(k.d_cap) == k.d_cap
    for k in keys["decode_walk_fused"]:
        assert ladder(k.q_wmax) == k.q_wmax and ladder(k.d_wmax) == k.d_wmax
    assert len(keys["encode_all"]) <= len(parsed)
    assert len(keys["decode_walk_fused"]) <= len(parsed)


def test_a_second_pass_meets_every_key_again(long_run):
    """The second compress and decompress of the same input use the first
    pass's keys and capture nothing; every sub-block replayed."""
    one, two = long_run["passes"]
    assert sorted(map(repr, two["keys"])) == sorted(map(repr, one["keys"]))
    assert two["captures"] == one["captures"]
    n = len(_parsed(one["blob"]))
    for stage in ("analyze_all", "encode_all", "decode_walk_fused"):
        st = long_run["stats"][stage]
        assert st["replays"] == 2 * n and st["eager"] == st["keys"]


def test_the_ladder_leaves_the_container_as_it_was(monkeypatch, long_run):
    """With the planes at the sub-blocks' bucketed lengths (no ladder, the
    steps run directly) the container is the same, byte for byte."""
    one, two = long_run["passes"]
    assert one["blob"] == two["blob"]
    monkeypatch.setattr(subblock, "plane_length", lambda L, variable: L)
    assert compress_bytes(long_run["data"], CodecConfig(**CFG), 1,
                          device="cpu") == one["blob"]


def test_port_reference_and_jax_decode_the_long_reads(long_run):
    from phyngsc_tpu.pipeline.decompress import \
        decompress_bytes as jax_decompress
    from portbench.reference.ngsct import decode_containers

    one, two = long_run["passes"]
    assert one["back"] == two["back"] == long_run["data"]
    assert decode_containers([one["blob"]])[0] == long_run["data"]
    assert jax_decompress(one["blob"]) == long_run["data"]


@pytest.mark.parametrize("writers", [1, 2])
def test_ladder_containers_are_the_jax_packages(monkeypatch, writers):
    """Sub-blocks of reads of 700 to 1,500 bp (three rungs; the JAX
    package's CPU compress of a 65,532 bp sub-block would hold about 140
    GB) through the stand-in graphs: the JAX package's bytes, and both
    decodes give the input."""
    from phyngsc_tpu.pipeline.decompress import \
        decompress_bytes as jax_decompress

    monkeypatch.setattr(graphs, "CPU_RUNNER", graphs.Runner(StubBackend()))
    data = long_reads(SHORTER)
    blob = compress_bytes(data, CodecConfig(**CFG), writers, device="cpu")
    if writers == 1:
        parsed = _parsed(blob)
        assert len({subblock.plane_length(p.L, p.variable)
                    for p in parsed}) == 3 < len(parsed)
    assert blob == jax_compress(data, JaxConfig(**CFG), writers)
    assert decompress_bytes(blob, device="cpu") == data
    assert jax_decompress(blob) == data


def test_the_decode_counts_its_walks_on_its_spans(long_run):
    """Each decoded sub-block's d.launch span counts its two walks: the
    lanes, the steps (the quality walk's are the bases) and the longest
    lane's; plain 2-bit DNA counts 16-slot groups."""
    call = long_run["call"]
    parsed = _parsed(long_run["passes"][1]["blob"])
    assert call.kind == "decompress"
    launches = sorted((s for s in call.spans if s.name == "d.launch"),
                      key=lambda s: s.t0)
    assert len(launches) == len(parsed)
    for s, p in zip(launches, parsed):
        c = s.counts
        S = p.q_sub.shape[0]
        assert c["walk.q.lanes"] == c["walk.d.lanes"] == S
        assert c["walk.q.steps"] == int(p.lens_np.sum())
        lanes = np.zeros(S * p.G, np.int64)
        lanes[:p.R] = p.lens_np
        assert c["walk.q.longest"] == int(lanes.reshape(S, -1).sum(1).max())
        assert 0 < c["walk.d.steps"] <= -(-c["walk.q.steps"] // 16) + 2 * p.R
        assert c["walk.d.longest"] <= c["walk.q.longest"] // 16 + 2 * p.G
    assert all(s.counts is None for s in call.spans if s.name != "d.launch")


# -- uniform and short variable lengths keep their keys ------------------------

KEEP = {
    "ERR005195 36 bp": (lambda: synthesize_fastq(1500, seed=81),
                        dict(subblock_input_bytes=32 << 10)),
    "1000 bp": (lambda: synthesize_fastq(60, read_len=1000, seed=82),
                dict(subblock_input_bytes=48 << 10)),
    "variable 100 bp": (lambda: synthesize_fastq(
        900, read_len=100, seed=83, variable_length=True),
        dict(subblock_input_bytes=48 << 10)),
}


@pytest.mark.parametrize("case", list(KEEP))
def test_uniform_and_short_lengths_keep_their_keys(monkeypatch, case):
    """Every stage key's plane width is the sub-block's bucketed length,
    as before the ladder, and the header's L rides unused."""
    build, kw = KEEP[case]
    runner = graphs.Runner(StubBackend())
    monkeypatch.setattr(graphs, "CPU_RUNNER", runner)
    spy = _Spy(monkeypatch, runner)
    data = build()
    blob = compress_bytes(data, CodecConfig(**kw), 1, device="cpu")
    assert decompress_bytes(blob, device="cpu") == data
    parsed = _parsed(blob)
    want = [bucket_length(p.Lt) for p in parsed]
    assert [k.L for k in spy.of("analyze_all")] == want
    assert [k.L for k in spy.of("decode_walk_fused")] == want
    for k in spy.of("analyze_all") + spy.of("decode_walk_fused"):
        assert (k.Lt is None) == (case == "variable 100 bp")
        assert not subblock._laddered(k)

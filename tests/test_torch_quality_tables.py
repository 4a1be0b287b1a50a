"""Stage B's quality table search (models/quality.py build_tables_adaptive):
the host runtime's one call (utils/native.py quality_tables) against the
port's numpy version (PHYNGSC_NO_NATIVE=1) and the JAX package's
build_tables_adaptive, field by field, on count tables that take each
path of the search, at max_code_len 6, 8, 9 and 12; then stage B's counters
and the container's bytes with and without the runtime."""

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.models import quality as jquality
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import quality
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from torch_time_limit import time_limit

_limit = time_limit(60)
NO_NATIVE = "PHYNGSC_NO_NATIVE"


def _hist(qual: np.ndarray, rows: int) -> np.ndarray:
    """(R, L) quality bytes -> (rows, 256) counts, position p on row
    p * rows // L."""
    R, L = qual.shape
    pos = np.broadcast_to(np.arange(L) * rows // L, qual.shape)
    out = np.zeros((rows, 256), np.int64)
    np.add.at(out, (pos.reshape(-1), qual.reshape(-1)), 1)
    return out


def _drift(rng, R: int, L: int, rows: int, spread: float) -> np.ndarray:
    """Qualities whose mean falls along the read by `spread` symbols."""
    mean = 70 - spread * np.arange(L) / max(L - 1, 1)
    q = np.rint(rng.normal(mean, 3.0, size=(R, L))).clip(33, 74)
    return _hist(q.astype(np.uint8), rows)


def _geometric(n: int, ratio: float, total: float) -> np.ndarray:
    return np.maximum(np.rint(total * ratio ** np.arange(n)), 1)


def err36(rng):
    data = synthesize_fastq(20000, read_len=36, seed=5)
    qual = np.frombuffer(b"".join(data.split(b"\n")[3::4]), np.uint8)
    return _hist(qual.reshape(-1, 36), 36)


def skew100(rng):
    return _drift(rng, 4000, 100, 100, 30.0)


def long256(rng):
    return _drift(rng, 64, 4096, 256, 35.0)


def zeros(rng):
    return np.zeros((36, 256), np.int64)


def singletons(rng):
    """One symbol a row, each row its own: merging costs a bit a symbol."""
    out = np.zeros((36, 256), np.int64)
    out[np.arange(36), 33 + np.arange(36)] = 1000
    out[30:] = 0  # and empty rows
    return out


def one_symbol(rng):
    """The same one symbol on every row: one zero-bit tree."""
    out = np.zeros((36, 256), np.int64)
    out[:, 73] = rng.integers(1, 1000, size=36)
    return out


def _dirichlet(rng, rows: int, n: int, rare: int, alpha: float):
    """rows of n symbols at Dirichlet(alpha) frequencies over a million
    counts, the first `rare` of them seen once."""
    out = np.zeros((rows, 256), np.int64)
    for t in range(rows):
        row = np.maximum(np.rint(rng.dirichlet(np.full(n, alpha)) * 1e6), 1)
        row[:rare] = 1
        out[t, 33:33 + n] = row
    return out


def cap6_taken(rng):
    """42 near-even symbols and a rare one: 6-bit codes cost little."""
    return _dirichlet(rng, 4, 42, 1, 100.0)


def cap6_rejected(rng):
    """20 symbols halving in frequency: the 6- and 8-bit caps cost more
    than 0.4%."""
    out = np.zeros((4, 256), np.int64)
    out[:, 40:60] = _geometric(20, 0.5, 2.0 ** 24)
    return out


def cap8(rng):
    """103 uneven symbols, 3 rare: past 64 symbols, 8-bit codes cost
    little."""
    return _dirichlet(rng, 2, 103, 3, 3.0)


def singleton_merge(rng):
    """A row of four symbols and a singleton row of its 1-bit symbol: the
    merge costs 20 payload bits and saves the singleton's 32-bit table."""
    out = np.zeros((2, 256), np.int64)
    out[0, 40:44] = [1000, 300, 300, 300]
    out[1, 40] = 20
    return out


def merge_tie(rng):
    """Two rows of two symbols, one shared: the merged tree's payload rises
    by exactly the table it saves, and the search stops at the tie."""
    out = np.zeros((2, 256), np.int64)
    out[:, 40] = 500
    out[0, 41] = out[1, 42] = 138
    return out


def merge_overflow(rng):
    """Two rows of 40 symbols each, no symbol shared: at 6 bits the merged
    candidate's 80 symbols cannot fit, mid-search."""
    out = np.zeros((2, 256), np.int64)
    out[0, 33:73] = rng.integers(1, 1000, size=40)
    out[1, 73:113] = rng.integers(1, 1000, size=40)
    return out


def near_2_31(rng):
    """int32 counts next to 2^31 - 1 (the device histogram's dtype)."""
    out = np.zeros((36, 256), np.int32)
    out[:, 33:74] = rng.integers(2 ** 31 - 4096, 2 ** 31, size=(36, 41))
    out[::3, 40] = 2 ** 31 - 1
    return out


CASES = {"err36": err36, "skew100": skew100, "long256": long256,
         "zeros": zeros, "singletons": singletons, "one_symbol": one_symbol,
         "cap6_taken": cap6_taken, "cap6_rejected": cap6_rejected,
         "cap8": cap8, "singleton_merge": singleton_merge,
         "merge_tie": merge_tie,
         "merge_overflow": merge_overflow,
         "near_2_31": near_2_31}

#: what each case is for, at max_code_len 12: (n_trees, group) of the
#: result, None where any
EXPECT = {"err36": (1, None), "skew100": ("mid", None),
          "long256": ("mid", None), "zeros": (1, 8),
          "singletons": (36, 8), "one_symbol": (1, 8),
          "cap6_taken": (4, 5), "cap6_rejected": (1, 2), "cap8": (2, 4),
          "singleton_merge": (1, None), "merge_tie": (2, None),
          "merge_overflow": (2, None),
          "near_2_31": (None, None)}


def _search(fn, counts, cfg):
    """(n_trees, lens, codes, singletons, group), or the ValueError."""
    try:
        tables, group = fn(counts, cfg)
    except ValueError as e:
        return ("ValueError", "cannot fit" in str(e))
    return (tables.n_trees, tables.lens, tables.codes, tables.singletons,
            group)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
         and x.dtype == y.dtype and np.array_equal(x, y))
        or (not isinstance(x, np.ndarray) and x == y) for x, y in zip(a, b))


@pytest.mark.parametrize("max_code_len", [6, 8, 9, 12])
@pytest.mark.parametrize("case", list(CASES))
def test_runtime_search_is_the_numpy_and_the_jax_search(monkeypatch, case,
                                                        max_code_len):
    counts = CASES[case](np.random.default_rng(len(case)))
    cfg = CodecConfig(max_code_len=max_code_len)
    stats = {}
    native = _search(lambda c, k: quality.build_tables_adaptive(c, k, stats),
                     counts, cfg)
    jax = _search(jquality.build_tables_adaptive, counts,
                  JaxConfig(max_code_len=max_code_len))
    with monkeypatch.context() as m:
        m.setenv(NO_NATIVE, "1")
        plain_stats = {}
        plain = _search(
            lambda c, k: quality.build_tables_adaptive(c, k, plain_stats),
            counts, cfg)
    assert _same(native, plain), case
    assert _same(native, jax), case
    if native[0] == "ValueError":
        assert native[1] and max_code_len < 8, case
        return
    assert stats == {"native": 1, "candidates": plain_stats["candidates"]}
    assert plain_stats["native"] == 0
    if max_code_len == 12:  # the path the case is for
        T, group = EXPECT[case]
        if T == "mid":
            assert 1 < native[0] < counts.shape[0], case
        elif T is not None:
            assert native[0] == T, case
        if group is not None:
            assert native[4] == group, case


def test_search_keeps_one_table_per_row_before_v4(monkeypatch):
    """A writer pinned to footer v3 merges no rows: the same on both."""
    from phyngsc_tpu_torch.container import footer

    counts = err36(None)
    monkeypatch.setattr(footer, "VERSION", 3)
    native = _search(quality.build_tables_adaptive, counts, CodecConfig())
    with monkeypatch.context() as m:
        m.setenv(NO_NATIVE, "1")
        plain = _search(quality.build_tables_adaptive, counts, CodecConfig())
    assert native[0] == 36
    assert _same(native, plain)


@pytest.mark.parametrize("shards", [1, 2])
def test_stage_b_counts_the_search_and_keeps_the_bytes(monkeypatch, caplog,
                                                       shards):
    """Under PHYNGSC_TIMING, q_tables.native is the sub-blocks compressed
    and q_tables.candidates the table sets built; the container is the one
    that PHYNGSC_NO_NATIVE=1 writes."""
    data = synthesize_fastq(3000, read_len=36, seed=19)
    cfg = CodecConfig(subblock_input_bytes=48 << 10, data_shards=shards)
    seen = []
    stage_b = subblock.stage_b

    def counted(*a, **k):
        seen.append(1)
        return stage_b(*a, **k)

    monkeypatch.setattr(subblock, "stage_b", counted)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with caplog.at_level("INFO", logger="phyngsc_tpu_torch"):
        blob = compress_bytes(data, cfg, 1, device="cpu")
    counts = dict(subblock.COUNTS)
    assert len(seen) > 1
    assert counts["q_tables.native"] == len(seen)
    assert counts["q_tables.candidates"] >= 2 * len(seen)
    line = next(r.getMessage() for r in caplog.records
                if "pipeline timing" in r.getMessage())
    assert f"q_tables.native={len(seen)}" in line
    assert f"q_tables.candidates={counts['q_tables.candidates']}" in line
    monkeypatch.setenv(NO_NATIVE, "1")
    seen.clear()
    assert compress_bytes(data, cfg, 1, device="cpu") == blob
    assert subblock.COUNTS["q_tables.native"] == 0
    assert (subblock.COUNTS["q_tables.candidates"]
            == counts["q_tables.candidates"])
    monkeypatch.delenv("PHYNGSC_TIMING")
    monkeypatch.delenv(NO_NATIVE)
    assert compress_bytes(data, cfg, 1, device="cpu") == blob
    assert subblock.COUNTS is None

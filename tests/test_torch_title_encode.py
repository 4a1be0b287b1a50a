"""The title stream's encode (models/title.py encode): the host runtime's one
call (utils/native.py title_encode) against the port's numpy version
(PHYNGSC_NO_NATIVE=1) and the JAX package's title.encode, field by field
and byte for byte, on corpora that take each path of the planner, at
max_code_len 6, 8 and 12; then stage B's counter and the container's bytes
with and without the runtime."""

import dataclasses
import functools
import sys
import threading

import numpy as np
import pytest

from phyngsc_tpu.config import CodecConfig as JaxConfig
from phyngsc_tpu.models import title as jtitle
from phyngsc_tpu.pipeline.compress import compress_bytes as jax_compress
from phyngsc_tpu_torch.config import CodecConfig
from phyngsc_tpu_torch.models import title
from phyngsc_tpu_torch.pipeline import subblock
from phyngsc_tpu_torch.pipeline.compress import compress_bytes
from phyngsc_tpu_torch.utils import bitio, fastq
from torch_time_limit import time_limit

_limit = time_limit(60)
NO_NATIVE = "PHYNGSC_NO_NATIVE"
HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def _matrix(titles: list):
    """Titles as the (R, TL) zero-padded matrix and (R,) lengths stage A
    gives the codec."""
    tlens = np.array([len(t) for t in titles], np.int32)
    mat = np.zeros((len(titles), max(int(tlens.max(initial=0)), 1)),
                   np.uint8)
    for i, t in enumerate(titles):
        mat[i, :len(t)] = np.frombuffer(t, np.uint8)
    return mat, tlens


def minknow_titles(R: int, seed: int = 0) -> list:
    """MinKNOW titles in the shape of portbench's ONT generator: "@<uuid>
    runid=<40 hex> read=<n> ch=<1..512> start_time=<ISO 8601>"."""
    rng = np.random.default_rng(seed)
    uuid = [b.tobytes().decode() for b in HEX[rng.integers(0, 16, (R, 32))]]
    runid = HEX[rng.integers(0, 16, 40)].tobytes().decode()
    ch = rng.integers(1, 513, size=R)
    t = 1488326400 + int(rng.integers(0, 86400 * 20)) + np.cumsum(
        rng.integers(0, 4, size=R))
    read = np.cumsum(rng.integers(1, 40, size=R))
    out = []
    for i in range(R):
        u = uuid[i]
        day, rem = divmod(int(t[i]) - 1488326400, 86400)
        out.append(
            f"@{u[:8]}-{u[8:12]}-{u[12:16]}-{u[16:20]}-{u[20:]} "
            f"runid={runid} read={read[i]} ch={ch[i]} start_time="
            f"2017-03-{day + 1:02d}T{rem // 3600:02d}:{rem // 60 % 60:02d}:"
            f"{rem % 60:02d}Z".encode())
    return out


def err_titles(R: int) -> list:
    """ERR005195's: "@ERR005195.<n> BGI-FC30BFTAAXX_5_1_000:<x>/2"."""
    x = np.random.default_rng(1).integers(0, 2048, size=R)
    return [f"@ERR005195.{i + 1} BGI-FC30BFTAAXX_5_1_000:{x[i]}/2".encode()
            for i in range(R)]


def srr_titles(R: int) -> list:
    """SRR-style: "@SRR062634.<n> HWI-EAS385_0095_FC:1:<tile>:<x>:<y>/1"
    with tile-sorted coordinates (tiles hold for runs of records)."""
    rng = np.random.default_rng(2)
    tile = 1 + np.arange(R) // 97
    x = rng.integers(0, 20000, size=R)
    y = np.sort(rng.integers(0, 200000, size=R))
    return [f"@SRR062634.{i + 1} HWI-EAS385_0095_FC:1:{tile[i]}:{x[i]}:"
            f"{y[i]}/1".encode() for i in range(R)]


def synthesized(R: int, style: str) -> list:
    """The title lines of utils/fastq.synthesize_fastq's corpus of R
    records in `style` (ERR005195 or SRR), ambiguous bases included."""
    data = fastq.synthesize_fastq(R, read_len=36 if style == "ERR005195"
                                  else 76, style=style, seed=R,
                                  ambiguity_rate=0.01)
    return data.split(b"\n")[0:4 * R:4]


def numeric_modes(R: int = 700) -> list:
    """Fields that take NUM_VALUE (wide uniform), NUM_DELTA (steps wider
    than a Huffman alphabet), NUM_BLOCK (runs of 64 records on one value)
    and NUM_HUF (a skewed small range), and a constant number."""
    rng = np.random.default_rng(3)
    value = rng.integers(0, 1 << 30, size=R)
    delta = 10 ** 9 + np.cumsum(rng.integers(0, 1000, size=R))
    block = 5000 + (np.arange(R) // 64) * 37
    huf = np.minimum(rng.zipf(1.5, size=R), 300)
    return [f"@m {value[i]} {delta[i]} {block[i]} {huf[i]} 7".encode()
            for i in range(R)]


def block_runs(R: int = 321) -> list:
    """A char field constant in runs of 32 records (a lane name) beside a
    varying one; R % 32 == 1, so the last block has one record."""
    rng = np.random.default_rng(4)
    lane = [f"lane{'ABCDEFGH'[(i // 32) % 8]}q{(i // 64) % 3}" for i in
            range(R)]
    word = [HEX[rng.integers(0, 16, 6)].tobytes().decode() for _ in range(R)]
    return [f"@{lane[i]}_{word[i]}".encode() for i in range(R)]


def wide(tail: str, R: int = 200) -> list:
    """A 150-char field, past max_stat_positions = 128: 'constant' (every
    record the same, the tail one char), 'mixed' (every record the same,
    the tail of many chars) or 'varying' (records differ)."""
    rng = np.random.default_rng(5)
    head = "Q" * 100
    if tail == "constant":
        return [f"@w {head}{'Z' * 50}".encode()] * R
    if tail == "mixed":
        return [f"@w {head}{'ABCDEFGHIJ' * 5}".encode()] * R
    return [("@w " + "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
             ).encode() for _ in range(R)]


def variable(R: int = 500) -> list:
    """Char fields of varying length and numbers of varying digit count."""
    rng = np.random.default_rng(6)
    out = []
    for i in range(R):
        name = HEX[rng.integers(0, 16, int(rng.integers(1, 13)))].tobytes()
        out.append(b"@" + name + f" {int(rng.integers(0, 10 ** 6))}:x".encode())
    return out


def value_delta_tie() -> list:
    """63 values in [1000, 1003], steps of 0 or 1, two raw blocks: NUM_VALUE
    and NUM_DELTA both emit 199 bits (NUM_BLOCK 217, NUM_HUF 243 and
    more), and the tie keeps NUM_VALUE."""
    steps = [0] * 30 + [1] + [0] * 29 + [1, 1]
    vals = 1000 + np.concatenate([[0], np.cumsum(steps)])
    return [f"@t {v}".encode() for v in vals]


def too_wide(R: int = 300) -> list:
    """One position of 70 distinct symbols: more than 6-bit codes hold."""
    syms = bytes(range(65, 91)) + bytes(range(97, 123)) + b"!$%&()*+;<>?[]^`{|"
    return [b"@r" + syms[i % 70:i % 70 + 1] + b"x" for i in range(R)]


CORPORA = {
    **{f"minknow_{R}": functools.partial(minknow_titles, R)
       for R in (1, 2, 31, 32, 33, 570, 4000)},
    "err_61000": functools.partial(err_titles, 61000),
    "srr": functools.partial(srr_titles, 3000),
    **{f"synth_err_{R}": functools.partial(synthesized, R, "ERR005195")
       for R in (1, 127, 65537)},
    "synth_srr_1000": functools.partial(synthesized, 1000, "SRR"),
    "raw_counts": lambda: [b"@a.b.c", b"@a.b", b"@a.b.c"] * 40,
    "raw_chars": lambda: [b"@a.b:c", b"@a.b.c", b"@a:b.c"] * 40,
    "constant": lambda: [b"@HWI-ST1234:8:1101:1234:2000#0/1"] * 100,
    "block_runs": block_runs,
    "numeric_modes": numeric_modes,
    "wide_constant_tail": functools.partial(wide, "constant"),
    "wide_mixed_tail": functools.partial(wide, "mixed"),
    "wide_varying": functools.partial(wide, "varying"),
    "variable": variable,
    "many_fields": lambda: [".".join(str((i * 7 + f) % 50) if f % 3 else
                                     "k" + str(f) for f in range(40)).encode()
                            for i in range(130)],
    "bare_numbers": lambda: [str(1000 + 3 * i).encode() for i in range(90)],
    "bare_words": lambda: [b"read" + bytes([97 + i % 26]) for i in range(90)],
    "empty": lambda: [b""] * 5,
    "value_delta_tie": value_delta_tie,
    "too_wide": too_wide,
}


@functools.lru_cache(maxsize=None)
def _corpus(name: str):
    return _matrix(CORPORA[name]())


def _header(enc) -> bytes:
    bw = bitio.BitWriter()
    (jtitle if isinstance(enc, jtitle.EncodedTitle) else title).write_header(
        bw, enc)
    bw.flush()
    return bw.getvalue()


def _plan(plan) -> list:
    """The plan's schema and every field's attributes, by name."""
    return [plan.n_fields, plan.tok_schema.sep_chars] + [
        [(f.name, getattr(p, f.name)) for f in dataclasses.fields(p)]
        for p in plan.fields]


def _same(a, b, exact=True) -> bool:
    """Equal values and shapes, and (exact) dtypes, through lists and
    tuples."""
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y, exact) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        return (a.shape == b.shape and (not exact or a.dtype == b.dtype)
                and np.array_equal(a, b))
    return a == b


def _encoded(enc) -> list:
    return [_plan(enc.plan), enc.fixed_words, enc.char_words,
            enc.char_sub_n_words, _header(enc)]


def _run(encode, *args):
    """encode(*args) as _encoded, or the ValueError's message."""
    try:
        return _encoded(encode(*args))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("max_code_len", [6, 8, 12])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_runtime_encode_is_the_numpy_and_the_jax_encode(monkeypatch, corpus,
                                                        max_code_len):
    """The runtime's plan, streams and header are the numpy version's
    (dtypes too) and the JAX package's; the header decodes back to the
    titles. The corpora that name a path take it."""
    mat, tlens = _corpus(corpus)
    R = mat.shape[0]
    cfg = CodecConfig(max_code_len=max_code_len)
    got = _run(title.encode, mat, tlens, cfg)
    with monkeypatch.context() as m:
        m.setenv(NO_NATIVE, "1")
        plain = _run(title.encode, mat, tlens, cfg)
    want = _run(jtitle.encode, mat, tlens, JaxConfig(max_code_len=max_code_len))
    assert _same(got, plain), corpus
    assert _same(got, want, exact=False), corpus
    if corpus == "too_wide" and max_code_len == 6:
        assert got == ("ValueError: alphabet of 70 symbols cannot fit 6-bit "
                       "codes")
        return
    enc = title.encode(mat, tlens, cfg)
    assert enc.native
    plan, n_fixed, n_char, sub = title.read_header(
        bitio.BitReader(got[-1]), R)
    assert (n_fixed, n_char) == (enc.fixed_words.size, enc.char_words.size)
    out, out_lens = title.decode(plan, enc.fixed_words, enc.char_words, sub,
                                 R, cfg)
    np.testing.assert_array_equal(out_lens, tlens)
    np.testing.assert_array_equal(out, mat[:, :out.shape[1]])
    if max_code_len != 12:
        return
    fields = enc.plan.fields
    modes = {p.mode for p in fields if p.kind == title.KIND_NUMERIC}
    chars = [p for p in fields if p.kind == title.KIND_CHAR]
    if corpus == "numeric_modes":
        assert modes == {title.NUM_VALUE, title.NUM_DELTA, title.NUM_BLOCK,
                         title.NUM_HUF}
    if corpus.startswith("raw_"):
        assert enc.plan.n_fields == 1
    if corpus == "block_runs":
        assert any(p.blk_const is not None for p in chars)
    if corpus.startswith("wide_"):
        assert chars[-1].has_overflow
        assert (chars[-1].tables_singletons[-1] >= 0) == (
            corpus == "wide_constant_tail")
    if corpus == "variable":
        assert any(p.const_len < 0 for p in chars)
    if corpus == "many_fields":
        assert enc.plan.n_fields == 40
    if corpus == "value_delta_tie":
        assert fields[-1].mode == title.NUM_VALUE


def test_concurrent_callers_get_the_serial_encodes():
    """Sixteen Python threads, more than the cores, encode at once (the
    call drops the GIL) on the runtime's pool: each gets what one caller
    gets."""
    names = ["minknow_570", "minknow_33", "srr", "numeric_modes",
             "block_runs", "variable", "wide_varying", "err_61000"] * 2
    cfg = CodecConfig()
    serial = [_encoded(title.encode(*_corpus(n), cfg)) for n in names]
    results = [None] * len(names)
    barrier = threading.Barrier(len(names))

    def run(i):
        barrier.wait(timeout=30)
        results[i] = [_encoded(title.encode(*_corpus(names[i]), cfg))
                      for _ in range(4)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=run, args=(i,))
              for i in range(len(names))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=45)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    for i, name in enumerate(names):
        assert results[i] is not None, name
        assert all(_same(r, serial[i]) for r in results[i]), name


def _minknow_fastq(R: int) -> bytes:
    """R records with MinKNOW titles and 60-400 bp reads."""
    rng = np.random.default_rng(7)
    out = []
    for i, t in enumerate(minknow_titles(R, seed=8)):
        n = int(rng.integers(60, 400))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
        qual = rng.integers(35, 75, n).astype(np.uint8)
        out += [t, b"\n", seq.tobytes(), b"\n+\n", qual.tobytes(), b"\n"]
    return b"".join(out)


@pytest.mark.parametrize("shards", [1, 2])
def test_stage_b_counts_the_encode_and_keeps_the_bytes(monkeypatch, caplog,
                                                       shards):
    """Under PHYNGSC_TIMING, t_encode.native is the sub-blocks compressed;
    the container is the one that PHYNGSC_NO_NATIVE=1 writes and the JAX
    package's, and counts 0 there."""
    data = _minknow_fastq(1500)
    kw = dict(subblock_input_bytes=96 << 10, data_shards=shards)
    seen = []
    stage_b = subblock.stage_b

    def counted(*a, **k):
        seen.append(1)
        return stage_b(*a, **k)

    monkeypatch.setattr(subblock, "stage_b", counted)
    monkeypatch.setenv("PHYNGSC_TIMING", "1")
    with caplog.at_level("INFO", logger="phyngsc_tpu_torch"):
        blob = compress_bytes(data, CodecConfig(**kw), 1, device="cpu")
    assert len(seen) > 1
    assert subblock.COUNTS["t_encode.native"] == len(seen)
    line = next(r.getMessage() for r in caplog.records
                if "pipeline timing" in r.getMessage())
    assert f"t_encode.native={len(seen)}" in line
    monkeypatch.setenv(NO_NATIVE, "1")
    assert compress_bytes(data, CodecConfig(**kw), 1, device="cpu") == blob
    assert subblock.COUNTS["t_encode.native"] == 0
    monkeypatch.delenv("PHYNGSC_TIMING")
    monkeypatch.delenv(NO_NATIVE)
    assert compress_bytes(data, CodecConfig(**kw), 1, device="cpu") == blob
    assert subblock.COUNTS is None
    assert jax_compress(data, JaxConfig(**kw), 1) == blob

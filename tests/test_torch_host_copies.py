"""The port's copies of phyngsc_tpu's host modules (phyngsc_tpu_torch/config,
utils/, ops/huffman, container/, parallel/partition) against their
originals: each copy is its source apart from the first-line note and the
rewritten imports, and gives the same values and bytes on seeded inputs.
utils/native is adapted, not copied (it loads the port's own runtime from
build/host/), so only where each loader looks is held here;
tests/test_torch_native.py holds the two runtimes' outputs. The host
functions and constants copied into port modules that hold device code too
(ops/transfer, pipeline/subblock, ops/bitpack_host's pack_lens4_np) are
their sources the same way."""

import dataclasses
import importlib
import inspect
import os
import re

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["config", "utils.bitio", "utils.fastq",
          "utils.shapes", "ops.huffman", "container.block",
          "container.footer", "container.ngsc_import",
          "container.ngsc_export", "parallel.partition"]


#: source modules whose copied functions live in another port module
PORT_MODULE = {"ops.bitpack": "ops.bitpack_host"}


def _pair(name):
    return (importlib.import_module(f"phyngsc_tpu.{name}"),
            importlib.import_module(
                f"phyngsc_tpu_torch.{PORT_MODULE.get(name, name)}"))


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_its_source(name):
    rel = name.replace(".", "/") + ".py"
    with open(os.path.join(ROOT, "phyngsc_tpu", rel)) as f:
        src = f.read()
    with open(os.path.join(ROOT, "phyngsc_tpu_torch", rel)) as f:
        note, copy = f.read().split("\n", 1)
    assert note == (f"# Copied from phyngsc_tpu/{rel}; imports point at "
                    "phyngsc_tpu_torch.")
    assert "from phyngsc_tpu." not in copy.replace("from phyngsc_tpu_torch.",
                                                   "")
    back = re.sub(r"^(\s*)(from|import) phyngsc_tpu_torch\b",
                  r"\1\2 phyngsc_tpu", copy, flags=re.M)
    assert back == src


def _config(j, t):
    for kw in ({}, {"records_per_substream": 16, "max_code_len": 8}):
        assert (dataclasses.asdict(j.CodecConfig(**kw))
                == dataclasses.asdict(t.CodecConfig(**kw)))
    for mod in (j, t):
        with pytest.raises(ValueError, match="max_code_len"):
            mod.CodecConfig(max_code_len=13)


def _bitio(j, t):
    rng = np.random.default_rng(11)
    widths = rng.integers(1, 33, size=400)
    vals = [int(rng.integers(0, 1 << int(w))) for w in widths]
    arr = rng.integers(0, 1 << 13, size=257)
    blobs = []
    for mod in (j, t):
        bw = mod.BitWriter()
        for v, w in zip(vals, widths):
            bw.put_bits(v, int(w))
        mod.put_uint_array(bw, arr, 13)
        bw.flush()
        bw.put_uint(0xDEADBEEF, 4)
        blobs.append(bw.getvalue())
        br = mod.BitReader(blobs[-1])
        assert [br.get_bits(int(w)) for w in widths] == vals
        np.testing.assert_array_equal(mod.get_uint_array(br, 257, 13), arr)
        br.align()
        assert br.get_uint(4) == 0xDEADBEEF
    assert blobs[0] == blobs[1]
    assert [j.bit_length(x) for x in range(300)] == [t.bit_length(x)
                                                     for x in range(300)]


def _huffman(j, t):
    from phyngsc_tpu.utils.bitio import BitReader, BitWriter
    from phyngsc_tpu_torch.utils import bitio as tbitio

    rng = np.random.default_rng(12)
    freqs = (rng.zipf(1.6, size=(8, 256)) * (rng.random((8, 256)) < 0.15))
    freqs[0] = 0
    freqs[1, :] = 0
    freqs[1, 7] = 99  # a singleton tree
    for max_len in (7, 8, 12):
        lj = j.build_code_lengths_batch(freqs, max_len)
        np.testing.assert_array_equal(lj, t.build_code_lengths_batch(freqs,
                                                                     max_len))
        np.testing.assert_array_equal(j.canonical_codes(lj),
                                      t.canonical_codes(lj))
        sing = j.singleton_of_batch(freqs)
        np.testing.assert_array_equal(sing, t.singleton_of_batch(freqs))
        for a, b in zip(j.decode_lut_batch(lj, 12, sing),
                        t.decode_lut_batch(lj, 12, sing)):
            np.testing.assert_array_equal(a, b)
        bj, bt = BitWriter(), tbitio.BitWriter()
        for row, s in zip(lj, sing):
            j.store_table(bj, row, int(s))
            t.store_table(bt, row, int(s))
        bj.flush()
        bt.flush()
        assert bj.getvalue() == bt.getvalue()
        rj, rt = BitReader(bj.getvalue()), tbitio.BitReader(bt.getvalue())
        for _ in range(len(lj)):
            a, b = j.load_table(rj, 256), t.load_table(rt, 256)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


def _shapes(j, t):
    for R in (0, 1, 63, 64, 65, 1000, 65535, 70001):
        for G in (1, 8, 64):
            for shards in (1, 2, 8):
                assert j.bucket_records(R, G, shards) == t.bucket_records(
                    R, G, shards)
    assert [j.bucket_length(L) for L in range(1, 300)] == [
        t.bucket_length(L) for L in range(1, 300)]
    cj, ct = j.BucketCtx(), t.BucketCtx()
    for R in (65536, 1000, 40000, 7, 65536):
        assert cj.pick(R, 64) == ct.pick(R, 64)
        assert cj.pick_words("q", R) == ct.pick_words("q", R)


def _fastq(j, t):
    for kw in ({"read_len": 36}, {"read_len": 100, "variable_length": True},
               {"read_len": 76, "style": "SRR"}):
        data = j.synthesize_fastq(300, seed=13, **kw)
        assert t.synthesize_fastq(300, seed=13, **kw) == data
        buf = np.frombuffer(data, np.uint8)
        ij, it = j.index_records(buf), t.index_records(buf)
        for f in dataclasses.fields(ij):
            np.testing.assert_array_equal(getattr(ij, f.name),
                                          getattr(it, f.name))
        for start in (0, 1, 57, len(data) // 2, len(data) - 5):
            assert (j.align_region_start(buf, start, 4096)
                    == t.align_region_start(buf, start, 4096))
    bad = np.frombuffer(b"@r\nACGT\n+\nII\n", np.uint8)
    for mod in (j, t):
        with pytest.raises(mod.FastqFormatError):
            mod.index_records(bad)


def _native(j, t):
    # the JAX package's loader resolves native/ beside its package; the
    # port's loads only its own build under build/host/ beside its package
    from phyngsc_tpu_torch import host_runtime

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        importlib.import_module("phyngsc_tpu").__file__)))
    assert os.path.abspath(j._LIB_PATH) == os.path.join(
        root, "native", "libphyngsc_host.so")
    path = t._find_lib_path()
    assert path == host_runtime.library_path()
    assert os.path.dirname(path) == os.path.join(root, "build", "host")
    assert os.path.basename(path).startswith("libphyngsc_host_")
    assert os.path.exists(path)


def _block(j, t):
    rng = np.random.default_rng(14)
    subs = [rng.integers(0, 256, size=n).astype(np.uint8).tobytes()
            for n in (1000, 3000, 17, 2500, 0, 9000)]
    bj = j.pack_blocks(2, subs, block_size=1024)
    bt = t.pack_blocks(2, subs, block_size=1024)
    assert [(b.writer_id, b.payload) for b in bj] == [
        (b.writer_id, b.payload) for b in bt]
    for b in bj:
        assert j.parse_block(b.payload) == t.parse_block(b.payload)
    assert j.header_size(7) == t.header_size(7)


def _footer(j, t):
    kw = dict(fastq_size=123456789012, block_size=8 << 20, n_writers=3,
              overlaps=[0, 117, 64], writer_block_counts=[4, 2, 3],
              last_block_sizes=[100, 200, 300],
              cbo=[0, 0, 1, 2, 0, 2, 1, 2, 0], records_per_substream=64,
              max_code_len=12)
    blob = j.write_footer(j.Footer(**kw))
    assert t.write_footer(t.Footer(**kw)) == blob
    got = t.read_footer(b"JUNK" + blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        j.read_footer(b"JUNK" + blob))
    assert j.footer_region_size(1 << 30) == t.footer_region_size(1 << 30)


def _partition(j, t):
    from phyngsc_tpu.config import CodecConfig as JConfig
    from phyngsc_tpu.utils.fastq import synthesize_fastq
    from phyngsc_tpu_torch.config import CodecConfig as TConfig

    buf = np.frombuffer(synthesize_fastq(2000, read_len=36, seed=15),
                        np.uint8)
    jc, tc = JConfig(subblock_input_bytes=16 << 10), TConfig(
        subblock_input_bytes=16 << 10)
    for n in (1, 2, 3, 7):
        assert ([dataclasses.astuple(r) for r in j.partition_regions(buf, n,
                                                                    jc)]
                == [dataclasses.astuple(r)
                    for r in t.partition_regions(buf, n, tc)])
    sizes = np.random.default_rng(16).integers(50, 400, size=3000)
    assert j.split_subblocks(sizes, jc) == t.split_subblocks(sizes, tc)


def _ngsc(j, t):
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    ei = importlib.import_module("phyngsc_tpu.container.ngsc_import")
    ti = importlib.import_module("phyngsc_tpu_torch.container.ngsc_import")
    data = synthesize_fastq(700, read_len=76, style="SRR", seed=17)
    blob = j.export_ngsc(data, records_per_subblock=256)
    assert t.export_ngsc(data, records_per_subblock=256) == blob
    assert ti.decompress_ngsc(blob) == ei.decompress_ngsc(blob) == data


def _lens4(j, t):
    """The same words for seeded lengths and singletons, and ValueError on
    a code length of 16 (the nibble + 1 a corrupt container can hold)."""
    rng = np.random.default_rng(23)
    for T in (1, 36, 128):
        lens = rng.integers(0, 16, size=(T, 256)).astype(np.uint8)
        sing = rng.integers(-1, 256, size=T).astype(np.int32)
        want = j.pack_lens4_np(lens, sing)
        got = t.pack_lens4_np(lens, sing)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    lens[0, 3] = 16
    for mod in (j, t):
        with pytest.raises(ValueError, match="code length"):
            mod.pack_lens4_np(lens, sing)


CASES = {"config": ("config", _config), "bitio": ("utils.bitio", _bitio),
         "pack_lens4_np": ("ops.bitpack", _lens4),
         "huffman": ("ops.huffman", _huffman),
         "shapes": ("utils.shapes", _shapes),
         "fastq index_records": ("utils.fastq", _fastq),
         "native": ("utils.native", _native),
         "block": ("container.block", _block),
         "footer": ("container.footer", _footer),
         "partition_regions": ("parallel.partition", _partition),
         "ngsc export -> import": ("container.ngsc_export", _ngsc)}


@pytest.mark.parametrize("case", list(CASES))
def test_copy_behaves_like_its_source(case):
    name, check = CASES[case]
    check(*_pair(name))


#: (source module, port module, copied functions, copied constants)
FUNCTION_COPIES = {
    "ops.bitpack": (["pack_lens4_np"], []),
    "ops.transfer": (
        ["_exc_bucket", "_width", "n_words", "_pack_fixed_np", "pack_seq_np",
         "seq_alpha_small", "pack_qual_np"],
        ["SEQ_RAW", "SEQ_2BIT", "SEQ_3BIT", "SEQ_2BIT_EXC", "QUAL_RAW",
         "QUAL_6BIT", "_PER", "_EXC_MIN_BUCKET"]),
    "pipeline.subblock": (
        ["_qual8_mode", "_out_width", "_out_fetch_words", "_lane_unpack_np",
         "_gather_matrix", "_check_tables"],
        ["_OUT_PER", "FLAG_VARIABLE_LENGTH", "FLAG_DELTA", "FLAG_CRC"]),
}


def _body(fn) -> str:
    """fn's source without its docstring, the imports pointing at
    phyngsc_tpu."""
    src = inspect.getsource(fn)
    doc = fn.__doc__
    if doc:
        src = src.replace(f'"""{doc}"""', '""', 1)
    return re.sub(r"\bphyngsc_tpu_torch\b", "phyngsc_tpu", src)


@pytest.mark.parametrize("module", list(FUNCTION_COPIES))
def test_function_copies_are_their_sources(module):
    """ops/transfer's host half and ops/bitpack_host's pack_lens4_np are
    verbatim copies, docstrings included; the subblock helpers equal
    theirs apart from a docstring that names the source."""
    j, t = _pair(module)
    names, constants = FUNCTION_COPIES[module]
    for name in names:
        a, b = getattr(j, name), getattr(t, name)
        if module in ("ops.transfer", "ops.bitpack"):
            assert re.sub(r"\bphyngsc_tpu_torch\b", "phyngsc_tpu",
                          inspect.getsource(b)) == inspect.getsource(a), name
        else:
            assert _body(b) == _body(a), name
    for name in constants:
        assert getattr(t, name) == getattr(j, name), name

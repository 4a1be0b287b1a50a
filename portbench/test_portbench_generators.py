"""The traffic generators: shapes the configurations state, determinism
from the seed. Run: python -m pytest portbench/"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.generators import err005195, ont_long  # noqa: E402


def _params(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)["params"]


def _records(data: bytes):
    lines = data.split(b"\n")
    assert lines[-1] == b""
    return lines[0:-1:4], lines[1::4], lines[2::4], lines[3::4]


@pytest.fixture(scope="module")
def err():
    p = {**_params("err005195_ga36"), "records_per_file": 200_000}
    return p, err005195.generate(p, 2**31 + 101, 0)


def test_err_reads_are_36_bp_with_err005195_titles(err):
    p, data = err
    titles, seqs, plus, quals = _records(data)
    assert len(titles) == p["records_per_file"]
    assert {len(s) for s in seqs} == {36} == {len(q) for q in quals}
    assert set(plus) == {b"+"}
    assert titles[0].startswith(b"@ERR005195.1 BGI-FC30BFTAAXX_5_1_000:")
    assert titles[-1].startswith(b"@ERR005195.200000 ")
    assert all(t.endswith(b"/2") for t in titles[:1000])


def test_err_iupac_rate_is_0_2_percent(err):
    _, data = err
    _, seqs, _, quals = _records(data)
    s = np.frombuffer(b"".join(seqs), np.uint8)
    q = np.frombuffer(b"".join(quals), np.uint8)
    amb = ~np.isin(s, np.frombuffer(b"ACGT", np.uint8))
    assert abs(amb.mean() - 0.002) <= 0.0005
    assert np.all((q[amb] >= 33) & (q[amb] <= 40))
    assert q.min() >= 33 and q.max() <= 73
    assert np.bincount(q)[73] > np.bincount(q)[50]  # skewed to 'I'


def test_err_second_file_numbers_on():
    p = {**_params("err005195_ga36"), "records_per_file": 10}
    titles = _records(err005195.generate(p, 7, 1))[0]
    assert titles[0].startswith(b"@ERR005195.11 ")


@pytest.mark.parametrize("index", [0, 1])
def test_ont_lengths_have_a_10_kb_n50_within_the_limits(index):
    p = _params("ont_na12878_long")
    lens = ont_long.lengths(p, index)
    assert lens.shape == (4000,)
    assert abs(ont_long.n50(lens) - 10_000) <= 1_000
    assert lens.min() >= 200 and lens.max() <= 65_532
    assert 0.6 <= lens.mean() / ont_long.n50(lens) <= 0.8


def test_ont_file_has_its_lengths_in_the_seeds_order():
    p = {**_params("ont_na12878_long"), "reads_per_file": 40}
    a = ont_long.generate(p, 2**31 + 1, 0)
    b = ont_long.generate(p, 2**31 + 2, 0)
    la = [len(s) for s in _records(a)[1]]
    lb = [len(s) for s in _records(b)[1]]
    assert sorted(la) == sorted(lb) == sorted(ont_long.lengths(p, 0))
    assert la != lb
    titles, seqs, _, quals = _records(a)
    assert all(len(s) == len(q) for s, q in zip(seqs, quals))
    assert set(b"".join(seqs)) <= set(b"ACGT")
    assert titles[0].startswith(b"@") and b" runid=" in titles[0]


@pytest.mark.parametrize("gen,name,small", [
    (err005195, "err005195_ga36", {"records_per_file": 500}),
    (ont_long, "ont_na12878_long", {"reads_per_file": 20})])
def test_generators_are_deterministic_in_the_seed(gen, name, small):
    p = {**_params(name), **small}
    seed = 2**31 + 977
    assert gen.generate(p, seed, 0) == gen.generate(p, seed, 0)
    assert gen.generate(p, seed, 0) != gen.generate(p, seed + 1, 0)
    assert gen.generate(p, seed, 0) != gen.generate(p, seed, 1)

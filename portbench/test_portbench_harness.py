"""The harness on the CPU at a tiny size: a sound run is correct; the
control and every fault the cells can have make it not correct; a new
configuration, traffic mix, cell and metric are new files and entries
only. Run: python -m pytest portbench/"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import control, harness  # noqa: E402

TINY = {
    "err005195_ga36.roundtrip": {"params": {"records_per_file": 3000},
                                 "codec": {"subblock_input_bytes": 1 << 18}},
}


def _run(cell, seed=2**31 + 41, mode=None):
    def go():
        return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                                overrides=TINY[cell])
    if mode is None:
        return go()
    with control.broken(mode):
        return go()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert out["correct"] is True
    assert out["attempted"] == 4 and out["failed"] == 0  # both inputs
    assert set(out["metrics"]) == {"setup_s", "compress_MBps",
                                   "decompress_MBps",
                                   "stored_bytes_per_byte"}
    assert 0 < out["metrics"]["stored_bytes_per_byte"]["value"] < 1
    assert list(out)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0}
               for c in out["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("mode", control.MODES)
def test_the_control_and_each_fault_are_not_correct(cell, mode):
    out = _run(cell, mode=mode)
    assert out["correct"] is False
    assert out["failed"] > 0
    assert out["checks"]["container_bytes_wrong"]["value"] > 0 or \
        out["checks"]["decompress_bytes_wrong"]["value"] > 0


def test_a_call_that_raises_is_counted(monkeypatch):
    from portbench import system
    calls = []
    real = system.decompress

    def flaky(blob, cfg, device):
        calls.append(1)
        if len(calls) == 3:  # the first in the window
            raise RuntimeError("lost")
        return real(blob, cfg, device)
    monkeypatch.setattr(system, "decompress", flaky)
    out = _run("err005195_ga36.roundtrip")
    assert out["correct"] is False
    assert out["checks"]["calls_raised"]["value"] == 1


NEW_METRIC = '''"""round_trips_per_s: the window's round trips over its seconds."""


def read(name, run):
    if name != "round_trips_per_s" or not run.calls:
        return None
    n = sum(c.kind == "decompress" for c in run.calls)
    return n / (run.calls[-1].t1 - run.calls[0].t0)
'''


def test_new_configuration_traffic_cell_and_metric_are_files_only(tmp_path):
    """A temporary copy of the benchmark gains a configuration, a traffic
    mix, a metric reader and their entries, with no edit to any file it
    had; the harness runs the new cell there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    with open(pb / "configs" / "err005195_ga36.json") as f:
        cfg = json.load(f)
    cfg.update(name="err_tiny_76", device="cpu",
               params={**cfg["params"], "records_per_file": 800,
                       "read_len": 76})
    (pb / "configs" / "err_tiny_76.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "roundtrip_closed1_three.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "inputs": 3}))
    (pb / "metrics" / "round_trips_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "err_tiny_76", "source": "x",
                             "file": "portbench/configs/err_tiny_76.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "err_tiny_76.three", "config":
                               "err_tiny_76", "traffic":
                               "roundtrip_closed1_three", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "round_trips_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data  # nothing it had was edited
    code = ("import json, sys; sys.path[:0] = [{tmp!r}, {root!r}]; "
            "from portbench import harness; "
            "print(json.dumps(harness.run_cell('err_tiny_76.three', 5, 0.0, "
            "False)))").format(tmp=str(tmp_path), root=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["attempted"] == 6  # a round trip of each of three inputs
    assert out["metrics"]["round_trips_per_s"]["value"] > 0
    assert "compress_MBps" in out["metrics"]


def test_the_cli_prints_no_result_without_a_card(tmp_path):
    """Where torch sees no card (this box has none) the command exits
    non-zero with nothing on standard output."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "err005195_ga36.roundtrip", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_the_cli_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ cannot run."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "err005195_ga36.roundtrip", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""

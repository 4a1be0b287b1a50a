"""The port's command line (phyngsc_tpu_torch.cli) against phyngsc_tpu's:
the same compress flags write the same .ngsct bytes, decompress and verify
restore the input, .ngsc export / import round-trip through the port's
copies of phyngsc_tpu's host code, --profile writes a torch.profiler trace, and what the port does
not take (--data-shards > 1, --device cuda without a card) raises. The
codec runs its plain versions (--device cpu)."""

import json

import pytest
import torch

from phyngsc_tpu import cli as jcli
from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
from phyngsc_tpu_torch import cli

FLAGS = ["--block-size", str(1 << 16), "--subblock-bytes", str(32 << 10),
         "--substream-records", "16"]


@pytest.fixture
def fastq(tmp_path):
    data = synthesize_fastq(1500, read_len=36, seed=71, ambiguity_rate=0.01)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    return str(p), data


@pytest.mark.parametrize("writers", ["1", "2"])
def test_cli_compress_matches_jax(tmp_path, fastq, writers, capsys):
    path, data = fastq
    ours, theirs = str(tmp_path / "t.ngsct"), str(tmp_path / "j.ngsct")
    assert cli.main(["compress", path, ours, "--writers", writers, *FLAGS,
                     "--device", "cpu"]) == 0
    assert "subblocks=" in capsys.readouterr().out
    assert jcli.main(["compress", path, theirs, "--writers", writers,
                      *FLAGS]) == 0
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    back = str(tmp_path / "back.fastq")
    assert cli.main(["decompress", ours, back, "--device", "cpu"]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def test_cli_verify(fastq, capsys):
    path, _ = fastq
    assert cli.main(["verify", path, "--writers", "2", *FLAGS,
                     "--device", "cpu"]) == 0
    assert "round-trip OK" in capsys.readouterr().out


def test_cli_ngsc_round_trip(tmp_path, fastq):
    path, data = fastq
    ngsc, back = str(tmp_path / "x.ngsc"), str(tmp_path / "back.fastq")
    assert cli.main(["export-ngsc", path, ngsc]) == 0
    assert cli.main(["import-ngsc", ngsc, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def test_cli_profile_writes_a_trace(tmp_path, fastq):
    path, _ = fastq
    trace_dir = tmp_path / "trace"
    assert cli.main(["compress", path, str(tmp_path / "p.ngsct"), *FLAGS,
                     "--device", "cpu", "--profile", str(trace_dir)]) == 0
    with open(trace_dir / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_data_shards_raise(tmp_path, fastq):
    path, _ = fastq
    out = str(tmp_path / "s.ngsct")
    with pytest.raises(NotImplementedError, match="later slice"):
        cli.main(["compress", path, out, "--data-shards", "2",
                  "--device", "cpu"])
    assert cli.main(["compress", path, out, *FLAGS, "--device", "cpu"]) == 0
    with pytest.raises(NotImplementedError, match="later slice"):
        cli.main(["decompress", out, str(tmp_path / "b.fastq"),
                  "--data-shards", "2", "--device", "cpu"])


def test_cli_cuda_without_card_raises(tmp_path, fastq):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _ = fastq
    out = str(tmp_path / "c.ngsct")
    for argv in (["compress", path, out], ["verify", path],
                 ["decompress", out, str(tmp_path / "b.fastq")]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)  # the default device is cuda

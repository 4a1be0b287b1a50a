"""The plain reference decoder against containers the port writes on the
CPU, and its guard against imports. Run: python -m pytest portbench/"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.check import bytes_wrong  # noqa: E402
from portbench.generators import err005195, ont_long  # noqa: E402
from portbench.harness import benchmark, cell  # noqa: E402
from portbench.reference.ngsct import decode_containers  # noqa: E402

SMALL = {"err005195_ga36": {"records_per_file": 6000},
         "ont_na12878_long": {"reads_per_file": 12, "mu": 6.5}}


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _compress(data, codec=None, n_writers=1):
    from phyngsc_tpu_torch.config import CodecConfig
    from phyngsc_tpu_torch.pipeline.compress import compress_bytes
    return compress_bytes(data, CodecConfig(**(codec or {})),
                          n_writers=n_writers, device="cpu")


def _srr_huffman(n, seed):
    """76 bp reads whose leading N keeps a quality outside [33, 40], so it
    stays in the DNA stream, which then takes Huffman codes."""
    from phyngsc_tpu_torch.utils.fastq import synthesize_fastq
    lines = synthesize_fastq(n, read_len=76, style="SRR",
                             seed=seed).split(b"\n")
    for i in range(1, len(lines) - 1, 4):
        if lines[i][:1] == b"N":
            lines[i + 2] = b"B" + lines[i + 2][1:]
    return b"\n".join(lines)


def _solid(n, seed):
    """SOLiD colour space: a base, then colours '0'-'3' (the delta path)."""
    rng = np.random.default_rng(seed)
    seq = (rng.integers(0, 4, size=(n, 50)) + 48).astype(np.uint8)
    seq[:, 0] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    qual = rng.integers(33, 64, size=(n, 50)).astype(np.uint8)
    return b"".join(b"@solid.%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(),
                                               qual[i].tobytes())
                    for i in range(n))


def _inputs():
    err = _config("err005195_ga36")
    ont = _config("ont_na12878_long")
    return {
        "err005195_ga36": err005195.generate(
            {**err["params"], **SMALL["err005195_ga36"]}, 2**31 + 3, 0),
        "ont_na12878_long": ont_long.generate(
            {**ont["params"], **SMALL["ont_na12878_long"]}, 2**31 + 5, 1),
        "srr_huffman_dna": _srr_huffman(3000, 7),
        "solid_delta": _solid(3000, 8),
    }


@pytest.fixture(scope="module")
def containers():
    ins = _inputs()
    small = {"subblock_input_bytes": 1 << 18}
    out = {k: (d, _compress(d, small)) for k, d in ins.items()}
    err = ins["err005195_ga36"]
    out["three_writers"] = (err, _compress(err, small, n_writers=3))
    return out


@pytest.mark.parametrize("name", ["err005195_ga36", "ont_na12878_long",
                                  "srr_huffman_dna", "solid_delta",
                                  "three_writers"])
def test_reference_decodes_the_ports_container(containers, name):
    data, blob = containers[name]
    got = decode_containers([blob])[0]
    assert not isinstance(got, Exception), got
    assert bytes_wrong(got, data) == 0


def test_reference_decodes_several_containers_together(containers):
    blobs = [blob for _, blob in containers.values()]
    for (data, _), got in zip(containers.values(), decode_containers(blobs)):
        assert bytes_wrong(got, data) == 0


@pytest.mark.parametrize("where", [0.3, 0.5, 0.7])
def test_reference_rejects_one_flipped_payload_bit(containers, where):
    data, blob = containers["err005195_ga36"]
    bad = bytearray(blob)
    at = int(len(blob) * where)
    bad[at] ^= 0x10
    got = decode_containers([bytes(bad)])[0]
    assert bytes_wrong(got, data) > 0


def test_reference_counts_a_truncated_container_wrong(containers):
    data, blob = containers["err005195_ga36"]
    got = decode_containers([blob[:len(blob) // 2]])[0]
    assert isinstance(got, Exception)
    assert bytes_wrong(got, data) == len(data)


_GUARD = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", _GUARD.format(
        root=ROOT, imports=imports)], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_imports_load_no_jax_and_not_the_jax_package():
    w, config, traffic, e2e, layers = cell(benchmark(), "err005195_ga36."
                                           "roundtrip")
    mods = ["portbench.run", "portbench.harness", "portbench.system",
            "portbench.check", "portbench.control",
            f"portbench.generators.{config['generator']}"]
    mods += [f"portbench.metrics.{m['name'].split('.')[0]}"
             for m in layers if os.path.exists(os.path.join(
                 ROOT, "portbench", "metrics",
                 m["name"].split(".")[0] + ".py"))]
    mods.append("portbench.metrics.host_clock")
    loaded = _loaded("\n".join(f"import {m}" for m in mods))
    assert "phyngsc_tpu_torch" in loaded  # the adaptor loads the port
    assert not loaded & {"jax", "jaxlib", "flax", "phyngsc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.ngsct, "
                     "portbench.reference.title, portbench.reference.bits")
    assert not loaded & {"jax", "jaxlib", "flax", "phyngsc_tpu",
                         "phyngsc_tpu_torch", "torch"}

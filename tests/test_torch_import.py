"""phyngsc_tpu_torch imports without jax, and never drops to the CPU on its
own: device="cuda" without a card raises, and a wrapper given a tensor that
is neither on the CPU nor on a card raises instead of taking its plain
version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import phyngsc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'phyngsc_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert sys.modules['jax'] is None\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 12  # every module of the package


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phyngsc_tpu_torch.device import resolve
    from phyngsc_tpu_torch.pipeline.compress import compress_bytes
    from phyngsc_tpu_torch.pipeline.decompress import decompress_bytes
    from phyngsc_tpu.utils.fastq import synthesize_fastq

    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda")
    data = synthesize_fastq(20, read_len=36, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        compress_bytes(data)  # the default device is "cuda"
    blob = compress_bytes(data, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        decompress_bytes(blob)
    assert decompress_bytes(blob, device="cpu") == data


def test_wrappers_raise_off_the_cpu():
    from phyngsc_tpu_torch.ops import bitpack, histogram, lookup

    sym = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        histogram.position_histogram(sym, sym.bool(), 256)
    words = torch.zeros(8, dtype=torch.int32, device="meta")
    sub = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bitpack.walk_uniform(words, sub, sub.int(),
                             torch.zeros((1, 4096), dtype=torch.int32,
                                         device="meta"),
                             torch.zeros(4, dtype=torch.int32, device="meta"),
                             12, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        bitpack.walk_masked(words, sub, torch.zeros((2, 8), dtype=torch.bool,
                                                    device="meta"),
                            None, None, 12, True)
    with pytest.raises(ValueError, match="CUDA"):
        lookup.fused_lookup(sym, torch.zeros((8, 64), dtype=torch.int32,
                                             device="meta"))


def test_kernel_library_is_named_by_its_sources():
    from phyngsc_tpu_torch import kernels

    path = kernels.library_path()
    assert path.startswith(kernels.BUILD_DIR)
    assert os.path.basename(path).startswith("libphyngsc_kernels_")
    assert np.all([os.path.exists(os.path.join(kernels.SRC_DIR, f))
                   for f in ("histogram.cu", "lookup.cu", "walk.cu")])

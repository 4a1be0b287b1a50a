#!/usr/bin/env python3
"""K5's device time on chip_smoke's long-lane planes, this tree's kernel
against an older tree's, in one process on one GPU.

    python3 tools/torch_k5_plane_ab.py OLD_TREE

Run from the root of a checkout; OLD_TREE is a checkout of the port whose
csrc/densify.cu launcher takes the lane starts and counts as two arrays,
(words, n, start, sub, S, Wmax, Sp, out, stream), as at commit 5fe62c7
(for example `git archive` of it unpacked into a git-ignored directory).

Builds the first sub-block of chip_smoke's long-lane corpus (lanes of
about 70,000 words), then times each kernel on its quality and DNA planes
under torch.profiler (device time of the kernel alone, the mean over 200
launches), with a new output each call (as the decode allocates it) and
with one output reused, after checking each against the plain version. Both kernels run in the same process, so the
card's L2 and the allocator start each pair from the same state.

Imports neither jax nor phyngsc_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.modules["jax"] = None
sys.modules["phyngsc_tpu"] = None
sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from phyngsc_tpu_torch import kernels  # noqa: E402
from phyngsc_tpu_torch.ops import bitpack  # noqa: E402


def device_ms(fn, reps: int = 200) -> float:
    """Mean device time of densify_kernel per fn() call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if "densify_kernel" in e.key)
    return us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = kernels.build()
    so = os.path.join(kernels.BUILD_DIR, "old_densify.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
                    os.path.join(args.old_tree, "phyngsc_tpu_torch", "csrc",
                                 "densify.cu")], check=True,
                   capture_output=True)
    old = ctypes.CDLL(so).phyngsc_densify
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    old.argtypes = [P, I64, P, P, I, I, I, P, P]
    old.restype = ctypes.c_int

    f = chip_smoke.FirstSubblock(chip_smoke.long_lane_corpus(1500, seed=5),
                                 dev)
    stream = torch.cuda.current_stream().cuda_stream
    for which in ("q", "d"):
        (words, lanes, Wmax, Sp), sub_np = f.stream(which)
        S, n = sub_np.shape[0], words.shape[0]
        start = lanes[0].contiguous()
        sub32 = lanes[1].to(torch.int32).contiguous()
        fixed = torch.empty((Wmax, Sp), dtype=torch.int32, device=dev)

        def this_tree(out=None):
            if out is None:
                return bitpack.dense_words(words, lanes, Wmax, Sp)
            lib.phyngsc_densify(words.data_ptr(), n, lanes.data_ptr(), S,
                                Wmax, Sp, out.data_ptr(), stream)
            return out

        def old_tree(out=None):
            out = torch.empty_like(fixed) if out is None else out
            old(words.data_ptr(), n, start.data_ptr(), sub32.data_ptr(), S,
                Wmax, Sp, out.data_ptr(), stream)
            return out

        ref = bitpack.dense_words_plain(words, lanes, Wmax, Sp)
        for name, fn in (("this tree", this_tree), ("older tree", old_tree)):
            for how, out in (("new output", None), ("one output", fixed)):
                if not torch.equal(fn(out), ref):
                    raise SystemExit(f"{name} differs from the plain version")
                ms = device_ms(lambda: fn(out))
                print(f"{which} plane ({Wmax}, {Sp}), S={S}: {name}, {how}: "
                      f"{ms:.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

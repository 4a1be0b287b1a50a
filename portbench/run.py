"""The benchmark of phyngsc_tpu_torch: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. Prints the run's result as the last line of
standard output: one JSON object with correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last the checks that decided
correct, each number beside its limit (also the last lines of standard
error). Exits non-zero with no result where there is no card, too few,
or the program is missing, or where a JAX module is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program builds its libraries under the checkout's build/ (kernels.py,
# host_runtime.py); any extension or Triton cache goes there too, at a
# fixed path, so that only a checkout's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                               t_start=T_START)
    except harness.SetupError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

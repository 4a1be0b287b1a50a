"""Make the repo's C++ host runtime (native/host_runtime.cpp) loadable.

The port's host stages (record indexing and gathers, Huffman table builds,
the title codec, FASTQ reassembly) go through utils/native.py, the port's
copy of phyngsc_tpu's loader, which finds the same repo-root native/,
builds the runtime with OpenMP at first use and falls back to numpy when
that build fails. A toolchain without an OpenMP runtime (g++ without
libgomp) fails it, so ensure() builds the same sources without -fopenmp:
the pragmas compile away and each call runs on one thread, while the
pipelines' thread pools still overlap sub-blocks. The library lands where
the loader looks first, so ensure() must run before the runtime's first use
in the process; the pipeline drivers call it on entry.
"""

from __future__ import annotations

import os
import subprocess
import threading

#: the repo-root native/ beside this package (utils/native.py's _NATIVE_DIR)
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libphyngsc_host.so")
SERIAL_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17"

_lock = threading.Lock()


def ensure() -> bool:
    """True when the runtime library exists, building it if needed (with
    OpenMP, else without). False when it cannot be built or
    PHYNGSC_NO_NATIVE asks for the numpy fallbacks."""
    with _lock:
        if os.path.exists(LIB_PATH):
            return True
        if os.environ.get("PHYNGSC_NO_NATIVE") or not os.path.isdir(NATIVE_DIR):
            return False
        for flags in ([], [f"CXXFLAGS={SERIAL_CXXFLAGS}"]):
            try:
                res = subprocess.run(["make", "-C", NATIVE_DIR, *flags],
                                     capture_output=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired):
                return False
            if res.returncode == 0:
                return True
        return False

"""Build the port's C++ host runtime (native/host_runtime.cpp beside this
module) into build/host/.

The port's host stages (record indexing and gathers, the wire's packers,
Huffman table builds, the title codec, the decode's tail and FASTQ
reassembly) go through utils/native.py, which loads the library that
ensure() builds and nothing else. The source is a copy of the JAX
package's native/host_runtime.cpp whose OpenMP regions run on a std::thread
pool (native/host_threads.h), so the build needs g++ and pthreads only. It
runs at the first use from any entry point; the library is named by a hash
of the sources and the flags, so a stale build is never loaded, and it is
written to a temporary file and renamed, so processes that start together
each load a whole library. A failed build raises; the callers' numpy
versions run only where PHYNGSC_NO_NATIVE=1 asks for them (utils/native.py).
"""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
#: the compiler and its flags; the sources and -o follow
COMMAND = ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
           "-shared"]

_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha1(" ".join(COMMAND).encode())
    for s in sorted(glob.glob(os.path.join(SRC_DIR, "*"))):  # the header too
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libphyngsc_host_{h.hexdigest()[:12]}.so")


def ensure() -> str:
    """The path of the runtime library, built first if it is not there.
    Raises RuntimeError, with the compiler's output, when it cannot be
    built."""
    with _lock:
        path = library_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        source = os.path.join(SRC_DIR, "host_runtime.cpp")
        try:
            res = subprocess.run([*COMMAND, source, "-o", tmp],
                                 capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"the host runtime cannot be built: {e}") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"the host runtime cannot be built ({res.returncode}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
        return path

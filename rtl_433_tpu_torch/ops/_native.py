"""Build the host slicer library (``csrc/slicers.cpp``).

The batch slicer bank that ``pulse/native_slicers.py`` binds is plain C++
for the host CPU. :func:`build` compiles it with the host ``c++`` into
``_build/libslicers-<hash>.so`` at first use; the hash covers the source,
the compiler and the flags, so an edited source rebuilds and an unchanged
one loads from ``_build/``. A failed build raises with the compiler's
output: nothing falls back to the per-decoder host path because of it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

from ._cuda import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "slicers.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()


def _cxx() -> str:
    path = shutil.which("c++")
    if path is None:
        raise RuntimeError("c++ not found: the slicer library "
                           "(csrc/slicers.cpp) cannot be built")
    return path


def _lib_path() -> str:
    cxx = _cxx()
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libslicers-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/slicers.cpp`` unless it is built already; returns the
    library's path. Raises with the compiler's output if the build fails."""
    with _lock:
        out = _lib_path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"c++ failed for csrc/slicers.cpp:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out

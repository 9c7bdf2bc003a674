"""Build the host libraries: the slicer bank (``csrc/slicers.cpp``) and
the ingest ring (``csrc/ingest.cpp``).

The batch slicer bank that ``pulse/native_slicers.py`` binds and the block
ring of live input (``io/native.py``) are plain C++ for the host CPU.
:func:`build` compiles a source with the host ``c++`` into
``_build/lib<name>-<hash>.so`` at first use; the hash covers the source,
the compiler and the flags, so an edited source rebuilds and an unchanged
one loads from ``_build/``. A failed build raises with the compiler's
output: nothing falls back to a Python path because of it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

from ._cuda import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "slicers.cpp")
INGEST_SOURCE = os.path.join(CSRC, "ingest.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()


def _cxx() -> str:
    path = shutil.which("c++")
    if path is None:
        raise RuntimeError("c++ not found: the host libraries "
                           "(csrc/*.cpp) cannot be built")
    return path


def _lib_path(source: str) -> str:
    cxx = _cxx()
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(source: str = None) -> str:
    """Compile ``source`` (default :data:`SOURCE`, the slicer bank) unless
    it is built already; returns the library's path. Raises with the
    compiler's output if the build fails."""
    source = SOURCE if source is None else source
    with _lock:
        out = _lib_path(source)
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"c++ failed for csrc/"
                               f"{os.path.basename(source)}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out

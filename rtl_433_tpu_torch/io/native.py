"""ctypes binding of the ingest ring (``csrc/ingest.cpp``).

The live path's acquisition buffer: a single-producer, single-consumer
ring of fixed-size byte blocks in C++ (ref include/sdr.h:17-18: 15 async
buffers). ``ops/_native.py`` builds the library with the host ``c++`` at
first use; a build that fails raises with the compiler's output, and there
is no Python ring to fall back to. The library's sample-format conversions
are not bound: cs8/cs16/cf32 input is converted in NumPy
(``io/fileformat.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _native

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_native.build(_native.INGEST_SOURCE))
            lib.ring_create.restype = ctypes.c_void_p
            lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
            lib.ring_free.restype = None
            lib.ring_free.argtypes = [ctypes.c_void_p]
            lib.ring_push.restype = ctypes.c_int
            lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ring_pop.restype = ctypes.c_int
            lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ring_fill.restype = ctypes.c_uint64
            lib.ring_fill.argtypes = [ctypes.c_void_p]
            lib.ring_dropped.restype = ctypes.c_uint64
            lib.ring_dropped.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _buf(arr):
    return arr.ctypes.data_as(ctypes.c_char_p)


class BlockRing:
    """SPSC block ring buffer of ``n_blocks`` blocks of ``block_size``
    bytes: a push into a full ring drops the block and counts it."""

    def __init__(self, block_size: int, n_blocks: int = 15):
        self.block_size = block_size
        self.n_blocks = n_blocks
        self._lib = _load()
        self._ring = self._lib.ring_create(block_size, n_blocks)
        if not self._ring:
            raise MemoryError(f"ring of {n_blocks} x {block_size} bytes")

    def push(self, block: np.ndarray) -> bool:
        block = np.ascontiguousarray(block, dtype=np.uint8)
        if block.nbytes != self.block_size:
            raise ValueError(f"block of {block.nbytes} bytes, ring blocks "
                             f"are {self.block_size}")
        return bool(self._lib.ring_push(self._ring, _buf(block)))

    def pop(self):
        out = np.empty(self.block_size, dtype=np.uint8)
        if self._lib.ring_pop(self._ring, _buf(out)):
            return out
        return None

    @property
    def fill(self) -> int:
        return int(self._lib.ring_fill(self._ring))

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._ring))

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.ring_free(self._ring)
            self._ring = None

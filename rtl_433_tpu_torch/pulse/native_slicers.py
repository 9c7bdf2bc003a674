"""ctypes bindings to the native batch slicer bank (csrc/slicers.cpp).

One ``slice_batch`` call slices a pulse/gap train against every registered
decoder timing spec in tight native loops and returns (a) a ``[n_events, 4]``
int32 summary table ``[spec_idx, arena_offset, num_rows, max_bits]`` for
vectorized decode gating and (b) a byte arena of compact bitbuffer records
that are materialized lazily, only for events that survive the gate.

Semantics match the exact-semantics Python slicers (pulse/slicers.py,
modeled on reference src/pulse_slicer.c:68-930). The library is built from
the source in this package at first use (ops/_native.py); a failed build
raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..bits.bitbuffer import BitBuffer
from ..ops import _native

_lib = None
_lock = threading.Lock()

# modulation string -> native enum (csrc/slicers.cpp Modulation)
MOD_ENUM = {
    "OOK_PULSE_PCM": 0,
    "OOK_PULSE_RZ": 0,
    "FSK_PULSE_PCM": 0,
    "OOK_PULSE_PPM": 1,
    "OOK_PULSE_PWM": 2,
    "FSK_PULSE_PWM": 2,
    "OOK_PULSE_MANCHESTER_ZEROBIT": 3,
    "FSK_PULSE_MANCHESTER_ZEROBIT": 3,
    "OOK_PULSE_DMC": 4,
    "OOK_PULSE_PIWM_RAW": 5,
    "OOK_PULSE_PIWM_DC": 6,
    "OOK_PULSE_NRZS": 7,
    "OOK_PULSE_PWM_OSV1": 8,
    "OOK_PULSE_RZI": 9,
}

SPEC_DTYPE = np.dtype([
    ("modulation", np.int32),
    ("s_short", np.int32),
    ("s_long", np.int32),
    ("s_sync", np.int32),
    ("s_gap", np.int32),
    ("s_reset", np.int32),
    ("s_tol", np.int32),
    ("f_short", np.float64),
    ("f_long", np.float64),
], align=True)
assert SPEC_DTYPE.itemsize == 48


def available() -> bool:
    return bool(_load())


def _load():
    """Build (if needed) and load the shared library; a failed build or
    load raises."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_native.build())
        lib.tpu433_slice_batch.restype = ctypes.c_int64
        lib.tpu433_slice_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _s(us, samples_per_us):
    """int(float32(us) * float32(samples_per_us)) — C truncation, matching
    slicers.py:_s."""
    return int(np.float32(us) * np.float32(samples_per_us))


def build_specs(devices: Sequence, sample_rate: int) -> np.ndarray:
    """Convert RDevice timing specs to the native Spec table.

    Mirrors slicers.py:_timings (µs→samples float32 conversion and the
    rounding-to-zero skip, ref src/pulse_slicer.c:79-87). Disabled or
    unsupported specs get modulation = -1 (native emits nothing, matching
    the Python dispatcher returning []).
    """
    samples_per_us = np.float32(sample_rate) / np.float32(1.0e6)
    specs = np.zeros(len(devices), SPEC_DTYPE)
    for i, dev in enumerate(devices):
        mod = MOD_ENUM.get(dev.modulation, -1)
        s_short = _s(dev.short_width, samples_per_us)
        s_long = _s(dev.long_width, samples_per_us)
        s_sync = _s(dev.sync_width, samples_per_us)
        s_gap = _s(dev.gap_limit, samples_per_us)
        s_reset = _s(dev.reset_limit, samples_per_us)
        s_tol = _s(dev.tolerance, samples_per_us)
        if mod == 9:
            # RZI checks only short/long/reset (slicers.py:483-492)
            if ((dev.short_width > 0 and s_short <= 0)
                    or (dev.long_width > 0 and s_long <= 0)
                    or (dev.reset_limit > 0 and s_reset <= 0)):
                mod = -1
        elif mod >= 0:
            for us, s in ((dev.short_width, s_short), (dev.long_width, s_long),
                          (dev.sync_width, s_sync), (dev.gap_limit, s_gap),
                          (dev.reset_limit, s_reset), (dev.tolerance, s_tol)):
                if us > 0 and s <= 0:
                    mod = -1
                    break
        f_short = f_long = 0.0
        if mod in (0, 5):  # PCM / PIWM_RAW use bit-rate factors
            if dev.short_width > 0:
                f_short = 1.0 / float(np.float32(dev.short_width)
                                      * samples_per_us)
            if dev.long_width > 0:
                f_long = 1.0 / float(np.float32(dev.long_width)
                                     * samples_per_us)
        specs[i] = (mod, s_short, s_long, s_sync, s_gap, s_reset, s_tol,
                    f_short, f_long)
    return specs


class SlicerBank:
    """A compiled timing-spec table + reusable arena for one decoder set."""

    def __init__(self, devices: Sequence, sample_rate: int,
                 arena_mb: int = 8, max_events: int = 65536):
        self.devices = list(devices)
        self.sample_rate = sample_rate
        self.specs = build_specs(self.devices, sample_rate)
        self._arena = np.zeros(arena_mb << 20, np.uint8)
        self._summary = np.zeros((max_events, 4), np.int32)
        self._lib = _load()
        self.meta = None  # per-spec gate/priority arrays (decoders/base.py)

    def slice(self, pulse: np.ndarray, gap: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Slice one package against all specs.

        Returns (summary[int32 n_events, 4], arena bytes view). Grows the
        arena and retries on overflow.
        """
        lib = self._lib
        if not lib:
            raise RuntimeError("native slicer library unavailable")
        pulse = np.ascontiguousarray(pulse, np.int32)
        gap = np.ascontiguousarray(gap, np.int32)
        while True:
            n = lib.tpu433_slice_batch(
                pulse.ctypes.data, gap.ctypes.data, len(pulse),
                self.specs.ctypes.data, len(self.specs),
                self._arena.ctypes.data, self._arena.size,
                self._summary.ctypes.data, self._summary.shape[0])
            if n >= 0:
                return self._summary[:n], self._arena
            # overflow: double both and retry
            self._arena = np.zeros(self._arena.size * 2, np.uint8)
            self._summary = np.zeros((self._summary.shape[0] * 2, 4), np.int32)

    def record_bytes(self, offset: int) -> bytes:
        """Raw serialized record — the content-exact decode-cache key."""
        arena = self._arena
        nr = int(arena[offset:offset + 4].view(np.int32)[0])
        fr = int(arena[offset + 4:offset + 8].view(np.int32)[0])
        head = 8 + ((4 * nr + 3) & ~3)
        return arena[offset: offset + head + fr * 128].tobytes()

    def materialize(self, offset: int) -> BitBuffer:
        """Decode one arena record into a BitBuffer."""
        arena = self._arena
        nr = int(arena[offset:offset + 4].view(np.int32)[0])
        fr = int(arena[offset + 4:offset + 8].view(np.int32)[0])
        head = 8 + ((4 * nr + 3) & ~3)
        u16 = arena[offset + 8: offset + 8 + 4 * nr].view(np.uint16)
        bits_per_row = u16[:nr]
        syncs = u16[nr:2 * nr]
        bb = arena[offset + head: offset + head + fr * 128].reshape(fr, 128)
        return BitBuffer.from_arrays(bb, bits_per_row, nr, syncs)


def materialize_bytes(blob: bytes) -> BitBuffer:
    """Decode a serialized record (``record_bytes`` output) into a
    BitBuffer — used by the train memo, which must outlive the reusable
    arena the record was sliced into."""
    arena = np.frombuffer(blob, np.uint8)
    nr = int(arena[0:4].view(np.int32)[0])
    fr = int(arena[4:8].view(np.int32)[0])
    head = 8 + ((4 * nr + 3) & ~3)
    u16 = arena[8: 8 + 4 * nr].view(np.uint16)
    bits_per_row = u16[:nr]
    syncs = u16[nr:2 * nr]
    bb = arena[head: head + fr * 128].reshape(fr, 128)
    return BitBuffer.from_arrays(bb, bits_per_row, nr, syncs)

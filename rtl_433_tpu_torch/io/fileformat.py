"""Sample file naming / loading.

Mirrors the reference filename conventions (ref src/fileformat.c,
help text src/rtl_433.c:343-363): sample rate and center frequency are
parsed from any path segment ("433.92M", "250k", "1024k", "sps"/"Hz"
suffixes); content type from tokens (cu8 cs8 cs16 cf32 am.s16 fm.s16 ook);
a "fmt:rate:path" prefix overrides. CU8, CS8, CS16 and CF32 load as
samples; the other names are recognised and raise as unsupported sample
formats (``.ook`` and SigMF input have readers of their own).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

KNOWN_FORMATS = ("cu8", "cs8", "cs16", "cf32", "am.s16", "am.f32", "fm.s16",
                 "fm.f32", "ook", "vcd", "sigmf")


@dataclass
class FileInfo:
    path: str = ""
    format: str = ""
    sample_rate: int = 0
    center_frequency: float = 0.0


_NUM = re.compile(r"^(\d+(?:\.\d+)?)([kKmMgG]?)(hz|sps|hZ|Hz|HZ)?$")


def _parse_num_token(tok, with_suffix=False):
    m = _NUM.match(tok)
    if not m:
        return (None, None, None) if with_suffix else (None, None)
    val = float(m.group(1))
    suffix = m.group(2).lower()
    val *= {"": 1, "k": 1e3, "m": 1e6, "g": 1e9}[suffix]
    unit = (m.group(3) or "").lower()
    if with_suffix:
        return val, unit, suffix
    return val, unit


def parse_filename(path: str) -> FileInfo:
    """Guess format/rate/frequency from the file name (ref src/fileformat.c:
    file_info_parse_filename). Also supports the "cu8:250k:path" override
    prefix form."""
    info = FileInfo(path=path)
    p = path
    # prefix overrides, e.g. "cu8:250k:-"
    while ":" in p:
        head, rest = p.split(":", 1)
        hl = head.lower()
        if hl in KNOWN_FORMATS:
            info.format = hl
            p = rest
            continue
        val, unit = _parse_num_token(head)
        if val is not None:
            if unit == "sps" or (unit == "" and val < 1e8):
                info.sample_rate = int(val)
            else:
                info.center_frequency = val
            p = rest
            continue
        break
    info.path = p

    base = os.path.basename(p)
    stem = base
    # extension gives the format
    for fmt in sorted(KNOWN_FORMATS, key=len, reverse=True):
        if stem.lower().endswith("." + fmt):
            if not info.format:
                info.format = fmt
            stem = stem[: -(len(fmt) + 1)]
            break
    # tokens separated by _ or -; the suffix decides the kind exactly like
    # the reference (ref src/fileformat.c:214-219): "M" -> frequency,
    # "k" -> sample rate, "[kMG]Hz" -> frequency, "[kM]sps" -> sample rate
    for tok in re.split(r"[_\-\s]+", stem):
        val, unit, suffix = _parse_num_token(tok, with_suffix=True)
        if val is None:
            continue
        if unit == "hz":
            info.center_frequency = val
        elif unit == "sps":
            info.sample_rate = int(val)
        elif suffix == "m":
            info.center_frequency = val
        elif suffix == "k":
            info.sample_rate = int(val)
    return info


def load_iq(path: str, fmt: str) -> np.ndarray:
    """Load an IQ file into CU8 [N, 2] (the engine's native input).

    CS16/CF32 are converted the way the reference replay does
    (ref src/rtl_433.c:1812-1834): CF32 clamps to CS16; CS8 rebias +128.
    CS16 is scaled to CU8 losing depth (the reference instead runs a CS16
    pipeline; this package converts and documents the difference).
    """
    # a writable buffer, so that torch.from_numpy may take the samples
    return load_iq_bytes(np.fromfile(path, np.uint8), fmt)


def _cs16_to_cu8(s16: np.ndarray) -> np.ndarray:
    return ((s16.astype(np.int32) >> 8) + 128).clip(0, 255).astype(np.uint8)


def load_iq_bytes(raw, fmt: str) -> np.ndarray:
    """Convert raw sample bytes (any buffer) to CU8 [N, 2] (see load_iq)."""
    fmt = fmt.lower()
    if fmt == "cu8":
        arr = np.frombuffer(raw, np.uint8)
    elif fmt == "cs8":
        # rebias (ref src/rtl_433.c:1829-1833)
        arr = (np.frombuffer(raw, np.int8).astype(np.int16) + 128) \
            .astype(np.uint8)
    elif fmt == "cs16":
        arr = _cs16_to_cu8(np.frombuffer(raw, np.int16))
    elif fmt == "cf32":
        # scale and clamp to CS16 (ref src/rtl_433.c:1812-1824)
        s16 = np.clip((np.frombuffer(raw, np.float32) * 32767.0)
                      .astype(np.int64), -32767, 32767)
        arr = _cs16_to_cu8(s16)
    else:
        raise ValueError(f"unsupported sample format: {fmt}")
    return arr[: len(arr) // 2 * 2].reshape(-1, 2)

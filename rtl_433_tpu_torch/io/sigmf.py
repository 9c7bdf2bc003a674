"""SigMF archive reader/writer (ref src/sigmf.c + vendored microtar).

A .sigmf file is an uncompressed tar with a `*.sigmf-meta` JSON member and
a `*.sigmf-data` sample member. Python's tarfile replaces the vendored
microtar. A file this package writes names it as ``core:recorder``.
"""

from __future__ import annotations

import io
import json
import tarfile
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_DATATYPES = {
    "cu8": "cu8", "ru8": "cu8",
    "ci8": "cs8", "cs8": "cs8",
    "ci16_le": "cs16", "cs16": "cs16",
    "cf32_le": "cf32", "cf32": "cf32",
}
_TO_SIGMF = {"cu8": "cu8", "cs8": "ci8", "cs16": "ci16_le",
             "cf32": "cf32_le"}


@dataclass
class SigmfInfo:
    datatype: str = "cu8"
    sample_rate: int = 0
    frequency: int = 0
    recorder: str = ""
    sample_start: int = 0
    data: Optional[np.ndarray] = None  # CU8 [N, 2]


def valid_filename(path: str) -> bool:
    """ref src/sigmf.c:330-337."""
    return path.lower().endswith(".sigmf")


def read(path: str) -> SigmfInfo:
    """Read a SigMF tar: meta JSON + data samples (ref sigmf_reader_open)."""
    from .fileformat import load_iq_bytes

    info = SigmfInfo()
    raw = None
    with tarfile.open(path, "r") as tar:
        for member in tar.getmembers():
            name = member.name.lower()
            f = tar.extractfile(member)
            if f is None:
                continue
            if name.endswith(".sigmf-meta"):
                meta = json.load(f)
                g = meta.get("global", {})
                info.datatype = _DATATYPES.get(
                    g.get("core:datatype", "cu8"), "cu8")
                info.sample_rate = int(g.get("core:sample_rate", 0))
                info.recorder = g.get("core:recorder", "")
                caps = meta.get("captures", [])
                if caps:
                    info.frequency = int(caps[0].get("core:frequency", 0))
                    info.sample_start = int(
                        caps[0].get("core:sample_start", 0))
            elif name.endswith(".sigmf-data"):
                # a writable buffer, so that torch.from_numpy may take
                # the samples
                raw = bytearray(f.read())
    if raw is not None:
        info.data = load_iq_bytes(raw, info.datatype)
    return info


def write(path: str, iq: np.ndarray, sample_rate: int, frequency: int,
          datatype: str = "cu8", recorder: str = "rtl_433_tpu_torch"):
    """Write a SigMF tar (ref sigmf_writer_open/sigmf_write_meta)."""
    meta = {
        "global": {
            "core:datatype": _TO_SIGMF.get(datatype, datatype),
            "core:sample_rate": int(sample_rate),
            "core:recorder": recorder,
            "core:version": "1.0.0",
        },
        "captures": [{
            "core:sample_start": 0,
            "core:frequency": int(frequency),
        }],
        "annotations": [],
    }
    data = np.ascontiguousarray(iq).tobytes()
    meta_bytes = json.dumps(meta).encode()
    with tarfile.open(path, "w") as tar:
        mi = tarfile.TarInfo("samples.sigmf-meta")
        mi.size = len(meta_bytes)
        tar.addfile(mi, io.BytesIO(meta_bytes))
        di = tarfile.TarInfo("samples.sigmf-data")
        di.size = len(data)
        tar.addfile(di, io.BytesIO(data))

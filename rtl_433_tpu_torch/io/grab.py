"""Signal grabber (-S) and output dumpers (-w).

- SampGrab keeps a ring of the recent IQ blocks (ref src/samp_grab.c
  samp_grab_push). Nothing saves it: the reference's retro-save of
  ``g###_<freq>M_<rate>k.cu8`` captures has no caller here, as in the
  JAX package, so ``-S`` writes no file.
- Dumper streams converted sample data to a file while decoding
  (ref src/r_flow.c:386-489 dumper conversions).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

GRAB_RING_BLOCKS = 12  # ref include/rtl_433.h grabber ring default


class SampGrab:
    """Ring of the last GRAB_RING_BLOCKS CU8 blocks (ref src/samp_grab.c
    samp_grab_push); ``mode`` is the -S all|unknown|known choice."""

    def __init__(self, mode: str = "all"):
        self.ring = deque(maxlen=GRAB_RING_BLOCKS)
        self.mode = mode

    def push(self, iq: np.ndarray):
        self.ring.append(np.asarray(iq, np.uint8))


class Dumper:
    """-w <spec> stream dumper (ref src/r_flow.c:386-489). Converts the
    CU8 stream to the requested content type and appends to a file."""

    # named-channel specs used by the sigrok dumper set
    # (ref src/r_api.c:1089-1099 add_sr_dumper)
    _NAMED = {"U8:LOGIC:": "logic", "F32:I:": "i.f32", "F32:Q:": "q.f32",
              "F32:AM:": "am.f32", "F32:FM:": "fm.f32"}

    def __init__(self, spec: str, sample_rate: int = 250_000):
        fmt = None
        path = spec
        for prefix, f in self._NAMED.items():
            if spec.upper().startswith(prefix):
                fmt = f
                path = spec[len(prefix):]
                break
        if fmt is None:
            from .fileformat import parse_filename
            info = parse_filename(spec)
            fmt = (info.format or "cu8").lower()
            path = info.path
        self.format = fmt
        self.path = path
        self.sample_rate = sample_rate
        if fmt in ("ook", "vcd"):
            self.file = open(self.path, "w")
            if fmt == "vcd":
                from ..pulse.data import pulse_data_print_vcd_header
                pulse_data_print_vcd_header(self.file, sample_rate)
        else:
            self.file = open(self.path, "wb")

    @property
    def wants_streams(self) -> bool:
        """True when this dumper needs the filtered am/fm sample streams."""
        return self.format in ("am.s16", "am", "fm.s16", "fm",
                               "am.f32", "fm.f32")

    @property
    def wants_logic(self) -> bool:
        return self.format == "logic"

    def push(self, iq: np.ndarray, am: Optional[np.ndarray] = None,
             fm: Optional[np.ndarray] = None,
             logic: Optional[np.ndarray] = None):
        """iq: CU8 [N, 2]; am/fm: int16 [N]; logic: uint8 [N]."""
        fmt = self.format
        if fmt in ("ook", "vcd"):
            return  # package-level formats, see write_pulses/write_vcd
        if fmt == "logic":
            if logic is not None:
                self.file.write(np.ascontiguousarray(logic,
                                                     np.uint8).tobytes())
        elif fmt == "cu8":
            self.file.write(np.ascontiguousarray(iq, np.uint8).tobytes())
        elif fmt == "cs8":
            self.file.write((iq.astype(np.int16) - 128)
                            .astype(np.int8).tobytes())
        elif fmt == "cs16":
            self.file.write(((iq.astype(np.int16) - 128) << 8)
                            .astype(np.int16).tobytes())
        elif fmt == "cf32":
            # scale from Q0.7 (ref src/r_flow.c:425-428)
            self.file.write(((iq.astype(np.float32) - 128) / 128.0)
                            .astype(np.float32).tobytes())
        elif fmt in ("am.s16", "am"):
            if am is not None:
                self.file.write(np.ascontiguousarray(am, np.int16).tobytes())
        elif fmt in ("fm.s16", "fm"):
            if fm is not None:
                self.file.write(np.ascontiguousarray(fm, np.int16).tobytes())
        elif fmt == "am.f32":
            # scale from Q0.15 (ref src/r_flow.c:444-448)
            if am is not None:
                self.file.write((am.astype(np.float32) / 32768.0)
                                .astype(np.float32).tobytes())
        elif fmt == "fm.f32":
            if fm is not None:
                self.file.write((fm.astype(np.float32) / 32768.0)
                                .astype(np.float32).tobytes())
        elif fmt == "i.f32":
            # scale from Q0.7 (ref src/r_flow.c:456-467)
            self.file.write(((iq[:, 0].astype(np.float32) - 128) / 128.0)
                            .astype(np.float32).tobytes())
        elif fmt == "q.f32":
            self.file.write(((iq[:, 1].astype(np.float32) - 128) / 128.0)
                            .astype(np.float32).tobytes())
        else:
            raise ValueError(f"unsupported dump format: {fmt}")
        self.file.flush()

    def write_pulses(self, pd):
        """OOK text dump for -w file.ook (ref src/pulse_data.c:193)."""
        self.file.write(pd.dump())
        self.file.flush()

    def write_vcd(self, pd, is_fsk: bool):
        """VCD transitions for -w file.vcd (ref src/pulse_data.c:103)."""
        from ..pulse.data import pulse_data_print_vcd
        pulse_data_print_vcd(self.file, pd, '"' if is_fsk else "'")
        self.file.flush()

    def close(self):
        self.file.close()

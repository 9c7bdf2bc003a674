"""Output sinks: console/file JSON, KV, CSV, log (network sinks in
output/network.py).

Mirrors the reference sink behaviors (ref src/output_file.c: JSON :157,
KV :457, CSV :707 with field negotiation via determine_csv_fields,
src/r_api.c:414-436; src/output_log.c for -F log).

Every sink carries a ``log_level``: the log fan-out
(api.RtlTpu.redirect_logging) delivers log events only to sinks whose
log_level admits them (ref include/data.h:191). Defaults match the
reference: json/csv 0 (opt in with ``-F json,v=8``), kv/log LOG_TRACE,
syslog LOG_WARNING (ref src/r_api.c:981-1040 add_*_output).
"""

from __future__ import annotations

import sys
from typing import IO, List, Optional

from .data_model import Event, event_to_json, event_to_jsons, event_to_kv
from .logger import LOG_TRACE


class JsonSink:
    """-F json: one JSON object per line (ref src/output_file.c:157)."""

    def __init__(self, file: Optional[IO] = None, compact: bool = False,
                 log_level: int = 0):
        self.file = file or sys.stdout
        self.compact = compact
        self.log_level = log_level

    def __call__(self, ev: Event):
        s = event_to_jsons(ev) if self.compact else event_to_json(ev)
        print(s, file=self.file, flush=True)


class KvSink:
    """-F kv: human-readable key/value lines (ref src/output_file.c:457)."""

    def __init__(self, file: Optional[IO] = None,
                 log_level: int = LOG_TRACE):
        self.file = file or sys.stdout
        self.log_level = log_level

    def __call__(self, ev: Event):
        print(event_to_kv(ev, color=getattr(self.file, 'isatty', lambda: False)()), file=self.file)
        print("", file=self.file, flush=True)


class LogSink:
    """-F log: prints LOG MESSAGES ONLY as ``src: msg [key value ...]``
    lines, to stderr by default (ref src/output_log.c:100-160). Decoded
    events are ignored — pair with -F json/kv for those."""

    _SKIP_KEYS = ("time", "src", "lvl", "msg", "num_rows")

    def __init__(self, file: Optional[IO] = None,
                 log_level: int = LOG_TRACE):
        self.file = file or sys.stderr
        self.log_level = log_level

    def __call__(self, ev: Event):
        src, lvl, msg = ev.get("src"), ev.get("lvl"), ev.get("msg")
        if src is None or lvl is None or msg is None:
            return  # print log messages only
        parts = [f"{src}: {msg}"]
        for f in ev.fields:
            if f.key in self._SKIP_KEYS:
                continue
            parts.append(f"{f.key} {f.value}")
        print(" ".join(parts), file=self.file, flush=True)


class CsvSink:
    """-F csv with upfront field negotiation (ref src/output_file.c:707)."""

    def __init__(self, fields: List[str], file: Optional[IO] = None,
                 log_level: int = 0):
        self.fields = list(fields)
        self.file = file or sys.stdout
        self.log_level = log_level
        self._wrote_header = False

    def _header(self):
        print(",".join(self.fields), file=self.file)
        self._wrote_header = True

    def __call__(self, ev: Event):
        if not self._wrote_header:
            self._header()
        d = ev.to_dict()
        row = []
        for k in self.fields:
            v = d.get(k, "")
            s = str(v)
            if "," in s or '"' in s:
                s = '"' + s.replace('"', '""') + '"'
            row.append(s)
        print(",".join(row), file=self.file, flush=True)


def well_known_fields(extra_meta: bool = False,
                      verbose_bits: bool = False) -> List[str]:
    """ref src/r_api.c:341-378."""
    out = ["time", "msg", "codes"]
    if verbose_bits:
        out.append("bits")
    if extra_meta:
        out += ["protocol", "description", "mod", "freq", "freq1", "freq2",
                "rssi", "snr", "noise"]
    return out


def determine_csv_fields(devices, extra=(),
                         verbose_bits: bool = False) -> List[str]:
    """Collect CSV fields from registered decoders (ref src/r_api.c:414-436)."""
    seen = []
    for f in well_known_fields(True, verbose_bits):
        if f not in seen:
            seen.append(f)
    for dev in devices:
        for f in dev.fields:
            if f not in seen:
                seen.append(f)
    for f in extra:
        if f not in seen:
            seen.append(f)
    return seen

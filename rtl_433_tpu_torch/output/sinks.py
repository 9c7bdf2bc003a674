"""Output sinks: console/file JSON and KV.

Mirrors the reference sink behaviors (ref src/output_file.c: JSON :157,
KV :457). Every sink carries a ``log_level`` (ref include/data.h:191) with
the reference defaults: json 0, kv LOG_TRACE. CSV, log and the network
sinks are not ported yet.
"""

from __future__ import annotations

import sys
from typing import IO, Optional

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

"""Event data model: ordered typed key/value fields.

Mirrors the reference data model (ref src/data.c, include/data.h:45-78):
each field has a key, pretty-print label, optional printf format (used by
the KV output) and a typed value. JSON/KV/CSV serialization matches the
reference formats (ref src/output_file.c:98 '%.3f' doubles for -F json,
src/data.c:578-596 '%.5f'-trimmed for the jsons-buffer serializer).
"""

from __future__ import annotations

import re
from typing import Any, List, NamedTuple, Optional


class F(NamedTuple):
    """One data field."""
    key: str
    value: Any
    pretty: str = ""
    fmt: Optional[str] = None


class Event:
    """Ordered field list with dict-like access by key (first match)."""

    def __init__(self, fields: Optional[List[F]] = None):
        self.fields: List[F] = list(fields or [])

    @classmethod
    def make(cls, *items):
        """data_make-style: items are (key, value), (key, value, pretty) or
        (key, value, pretty, fmt) tuples; None values are dropped (DATA_COND)."""
        ev = cls()
        for it in items:
            if it is None:
                continue
            ev.fields.append(F(*it))
        return ev

    def get(self, key, default=None):
        for f in self.fields:
            if f.key == key:
                return f.value
        return default

    def __contains__(self, key):
        return any(f.key == key for f in self.fields)

    def prepend(self, *items):
        self.fields = [F(*it) for it in items] + self.fields

    def append(self, *items):
        self.fields += [F(*it) for it in items]

    def replace(self, key, value):
        self.fields = [f._replace(value=value) if f.key == key else f
                       for f in self.fields]

    def to_dict(self):
        return {f.key: f.value for f in self.fields}

    def __repr__(self):
        return f"Event({self.to_dict()})"


# ---------------------------------------------------------------------------
# unit conversion by key suffix (ref src/r_api.c:652-791)

def _cvt(val, key, fmt, pairs):
    for suffix, new_suffix, conv, fmt_old, fmt_new in pairs:
        if key.endswith(suffix):
            nf = fmt.replace(fmt_old, fmt_new) if fmt else fmt
            return conv(val), key[: -len(suffix)] + new_suffix, nf
    return None

_SI = [
    ("_F", "_C", lambda v: (v - 32) / 1.8, "F", "C"),
    ("_mi_h", "_km_h", lambda v: v * 1.609344, "mi/h", "km/h"),
    ("_in_h", "_mm_h", lambda v: v * 25.4, "in/h", "mm/h"),
    ("_inHg", "_hPa", lambda v: v * 33.8639, "inHg", "hPa"),
    ("_in", "_mm", lambda v: v * 25.4, "in", "mm"),
    ("_PSI", "_kPa", lambda v: v * 6.89476, "PSI", "kPa"),
]
_CUSTOMARY = [
    ("_C", "_F", lambda v: v * 1.8 + 32, "C", "F"),
    ("_km_h", "_mi_h", lambda v: v / 1.609344, "km/h", "mi/h"),
    ("_m_s", "_mi_h", lambda v: v * 2.2369363, "m/s", "mi/h"),
    ("_mm_h", "_in_h", lambda v: v / 25.4, "mm/h", "in/h"),
    ("_mm", "_in", lambda v: v / 25.4, "mm", "in"),
    ("_hPa", "_inHg", lambda v: v / 33.8639, "hPa", "inHg"),
    ("_kPa", "_PSI", lambda v: v / 6.89476, "kPa", "PSI"),
]


def convert_units(ev: Event, mode: str) -> Event:
    """-C si|customary conversion on double fields (ref src/r_api.c:652-791)."""
    if mode not in ("si", "customary"):
        return ev
    pairs = _SI if mode == "si" else _CUSTOMARY
    out = []
    for f in ev.fields:
        if isinstance(f.value, float):
            r = _cvt(f.value, f.key, f.fmt, pairs)
            if r is not None:
                val, key, fmt = r
                out.append(F(key, val, f.pretty, fmt))
                continue
        out.append(f)
    return Event(out)


# ---------------------------------------------------------------------------
# serializers

def _json_escape(s: str) -> str:
    out = []
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def _json_value_file(v) -> str:
    """-F json value formatting (ref src/output_file.c:64-109)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return f"{v:.3f}"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_json_value_file(x) for x in v) + "]"
    if isinstance(v, Event):
        return event_to_json(v)
    return '"' + _json_escape(str(v)) + '"'


def event_to_json(ev: Event) -> str:
    """One JSON object, reference '-F json' style (spaces around colons)."""
    parts = []
    for f in ev.fields:
        parts.append(f'"{_json_escape(f.key)}" : {_json_value_file(f.value)}')
    return "{" + ", ".join(parts) + "}"


def _jsons_value(v) -> str:
    """data_print_jsons formatting (ref src/data.c:578-596)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        if v > 1e7 or v < 1e-4:
            return f"{v:g}"
        s = f"{v:.5f}"
        s = re.sub(r"(\.\d)0+$", r"\1", s)
        s = re.sub(r"(\.\d*[1-9])0+$", r"\1", s)
        return s
    if isinstance(v, int):
        return str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_jsons_value(x) for x in v) + "]"
    if isinstance(v, Event):
        return event_to_jsons(v)
    return '"' + _json_escape(str(v)) + '"'


def event_to_jsons(ev: Event) -> str:
    """Compact JSON (MQTT/syslog payloads, ref src/data.c:607-632)."""
    return "{" + ",".join(
        f'"{_json_escape(f.key)}":{_jsons_value(f.value)}' for f in ev.fields) + "}"


# -F kv value colors by key (ref src/output_file.c:183-198)
_KV_COLORS = {
    "tag": "\033[34m", "time": "\033[34m",                       # blue
    "model": "\033[31m", "type": "\033[31m", "id": "\033[31m",   # red
    "mic": "\033[36m",                                           # cyan
    "mod": "\033[35m", "freq": "\033[35m",                       # magenta
    "freq1": "\033[35m", "freq2": "\033[35m",
    "rssi": "\033[33m", "snr": "\033[33m", "noise": "\033[33m",  # yellow
}
_KV_GREEN = "\033[32m"
_KV_RESET = "\033[0m"
_KV_BREAK_BEFORE = {"model", "mod", "rssi", "codes"}
_KV_BREAK_AFTER = {"id", "mic"}


def event_to_kv(ev: Event, width: int = 78, color: bool = False) -> str:
    """-F kv output: 26-column aligned key/value layout with break rules
    and (optionally) per-key ANSI value colors (ref src/output_file.c:
    326-370 layout, :183-216 color/break tables)."""
    out = []
    column = 0
    for f in ev.fields:
        sval = _kv_value_str(f)
        key = f.pretty if f.pretty else f.key
        if column > 0 and f.key in _KV_BREAK_BEFORE:
            out.append("\n")
            column = 0
        elif column >= width - 26:
            out.append("\n")
            column = 0
        elif 0 < column < width - 26:
            pad = 25 - column % 26
            out.append(" " * pad)
            column += pad
        cell = f"{key:<10}: "
        out.append(cell)
        column += len(cell)
        if color:
            out.append(_KV_COLORS.get(f.key, _KV_GREEN))
        out.append(sval)
        column += len(sval)
        if color:
            out.append(_KV_RESET)
        if column > 0 and f.key in _KV_BREAK_AFTER:
            column = width  # force break before the next key
    return "".join(out)


def _kv_value_str(f: F) -> str:
    v = f.value
    if isinstance(v, Event):
        return " ".join(_kv_value_str(g) for g in v.fields)
    if isinstance(v, list):
        return ", ".join(str(x) for x in v)
    if f.fmt and isinstance(v, (int, float)):
        try:
            return _c_format(f.fmt, v)
        except (ValueError, TypeError):
            return str(v)
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _c_format(fmt: str, val) -> str:
    """Apply a C printf-style format with one argument."""
    m = re.search(r"%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGs]", fmt)
    if not m:
        return str(val)
    spec = m.group(0)
    if spec[-1] in "diouxX":
        val = int(val)
        if spec[-1] in "ouxX" and val < 0:
            # C prints negative ints as unsigned 32-bit under %u/%o/%x
            val &= 0xFFFFFFFF
    out = fmt[: m.start()] + (spec % val) + fmt[m.end():]
    return out.replace("%%", "%")

"""Flex decoder: runtime-configurable general-purpose decoder (-X).

Re-implements the reference flex decoder (ref src/devices/flex.c): a spec
string like

  -X 'n=NAME,m=OOK_PWM,s=264,l=744,r=12000,bits>=10,get=@0:{8}:id'

compiles into an RDevice whose decode function applies row/bit constraints,
invert/reflect, match/preamble search, symbol/UART/DM/MC decodes and
getter field extraction (ref flex_callback :154-369, spec parsing :666-875).
"""

from __future__ import annotations

import re
from typing import List

from ..bits import util
from ..bits.bitbuffer import BitBuffer
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_SANITY,
    RDevice,
)

MODULATIONS = {
    "OOK_MC_ZEROBIT": "OOK_PULSE_MANCHESTER_ZEROBIT",
    "OOK_PCM": "OOK_PULSE_PCM",
    "OOK_RZ": "OOK_PULSE_RZ",
    "OOK_PPM": "OOK_PULSE_PPM",
    "OOK_PWM": "OOK_PULSE_PWM",
    "OOK_DMC": "OOK_PULSE_DMC",
    "OOK_PIWM_RAW": "OOK_PULSE_PIWM_RAW",
    "OOK_PIWM_DC": "OOK_PULSE_PIWM_DC",
    "OOK_MC_OSV1": "OOK_PULSE_PWM_OSV1",
    "OOK_PWM_OSV1": "OOK_PULSE_PWM_OSV1",
    "OOK_NRZS": "OOK_PULSE_NRZS",
    "OOK_RZI": "OOK_PULSE_RZI",
    "FSK_PCM": "FSK_PULSE_PCM",
    "FSK_PWM": "FSK_PULSE_PWM",
    "FSK_MC_ZEROBIT": "FSK_PULSE_MANCHESTER_ZEROBIT",
}


class FlexGetter:
    def __init__(self):
        self.bit_offset = 0
        self.bit_count = 0
        self.mask = 0
        self.name = ""
        self.map = []  # (key, val)
        self.format = ""


class FlexParams:
    def __init__(self):
        self.name = ""
        self.min_rows = 0
        self.max_rows = 0
        self.min_bits = 0
        self.max_bits = 0
        self.min_repeats = 0
        self.max_repeats = 0
        self.invert = 0
        self.reflect = 0
        self.unique = 0
        self.count_only = 0
        self.match = None        # (bytes, len)
        self.preamble = None
        self.symbol_zero = 0
        self.symbol_one = 0
        self.symbol_sync = 0
        self.getters: List[FlexGetter] = []
        self.decode_uart = ""
        self.decode_dm = 0
        self.decode_mc = 0


def _bit(data, b):
    return (int(data[b >> 3]) >> (7 - (b & 7))) & 1


def _compact_number(data, bit_offset, mask):
    """Ref src/devices/flex.c:30-45."""
    top_bit = 0
    while mask >> top_bit:
        top_bit += 1
    val = 0
    for b in range(top_bit - 1, -1, -1):
        if mask & (1 << b):
            val = (val << 1) | _bit(data, bit_offset)
        bit_offset += 1
    return val


def _extract_number(data, bit_offset, bit_count):
    """Ref src/devices/flex.c:48-66."""
    val = 0
    for i in range(bit_count):
        val = (val << 1) | _bit(data, bit_offset + i)
    return val


def _parse_bits(code):
    bits = BitBuffer.parse(code)
    if bits.num_rows != 1:
        raise ValueError("flex: match/preamble/mask needs one bit row")
    n = bits.bits_per_row[0]
    return bytes(bits.row_bytes(0)), n


def _parse_symbol(code):
    b, n = _parse_bits(code)
    if n > 27:
        raise ValueError("flex: symbol up to 27 bits")
    word = 0
    for i in range(4):
        word = (word << 8) | (b[i] if i < len(b) else 0)
    return word | n


def _strtol0(s):
    """C strtol(s, NULL, 0): 0x->hex, leading 0->octal, else decimal
    (ref src/devices/flex.c:585 parses map keys this way, so a key like
    ``02`` is octal — Python's int(s, 0) would reject it)."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if s[:2].lower() == "0x":
        v = int(s[2:], 16)
    elif len(s) > 1 and s[0] == "0":
        v = int(s, 8)
    else:
        v = int(s, 10)
    return -v if neg else v


def _parse_getter(arg):
    g = FlexGetter()
    rest = arg
    while rest:
        if rest[0] == "[":
            end = rest.index("]")
            body = rest[1:end]
            for part in body.split():
                if ":" in part:
                    k, v = part.split(":", 1)
                    g.map.append((_strtol0(k), v))
            rest = rest[end + 1:].lstrip(":")
            continue
        if ":" in rest:
            tok, rest = rest.split(":", 1)
        else:
            tok, rest = rest, ""
        if not tok:
            continue
        if tok.startswith("["):
            continue
        if tok[0] == "@":
            g.bit_offset = int(tok[1:], 0)
        elif tok[0] == "{" or tok[0].isdigit():
            b, n = _parse_bits(tok)
            g.bit_count = n
            g.mask = _extract_number(b, 0, n)
        elif tok[0] == "%":
            g.format = tok
        else:
            g.name = tok
    if not g.name:
        raise ValueError("flex: get missing name")
    return g


def parse_spec(spec: str) -> tuple:
    """Parse the -X kwargs spec into (RDevice timing kwargs, FlexParams)."""
    params = FlexParams()
    dev_kw = dict(modulation="", short_width=0.0, long_width=0.0,
                  sync_width=0.0, gap_limit=0.0, reset_limit=0.0,
                  tolerance=0.0, priority=0)
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        m = re.match(r"([\w]+)\s*(>=|<=|=)?\s*(.*)$", item)
        if not m:
            continue
        key, op, val = m.group(1), m.group(2) or "", m.group(3)
        if key in ("n", "name"):
            params.name = val
        elif key in ("m", "modulation"):
            if val not in MODULATIONS:
                raise ValueError(f"flex: unknown modulation {val}")
            dev_kw["modulation"] = MODULATIONS[val]
        elif key in ("s", "short"):
            dev_kw["short_width"] = float(val)
        elif key in ("l", "long"):
            dev_kw["long_width"] = float(val)
        elif key in ("y", "sync"):
            dev_kw["sync_width"] = float(val)
        elif key in ("g", "gap"):
            dev_kw["gap_limit"] = float(val)
        elif key in ("r", "reset"):
            dev_kw["reset_limit"] = float(val)
        elif key in ("t", "tolerance"):
            dev_kw["tolerance"] = float(val)
        elif key in ("prio", "priority"):
            dev_kw["priority"] = int(val)
        elif key == "bits":
            if op == ">=":
                params.min_bits = int(val)
            elif op == "<=":
                params.max_bits = int(val)
            else:
                params.min_bits = params.max_bits = int(val)
        elif key == "rows":
            if op == ">=":
                params.min_rows = int(val)
            elif op == "<=":
                params.max_rows = int(val)
            else:
                params.min_rows = params.max_rows = int(val)
        elif key == "repeats":
            if op == ">=":
                params.min_repeats = int(val)
            elif op == "<=":
                params.max_repeats = int(val)
            else:
                params.min_repeats = params.max_repeats = int(val)
        elif key == "invert":
            params.invert = int(val) if val else 1
        elif key == "reflect":
            params.reflect = int(val) if val else 1
        elif key == "match":
            params.match = _parse_bits(val)
        elif key == "preamble":
            params.preamble = _parse_bits(val)
        elif key == "countonly":
            params.count_only = int(val) if val else 1
        elif key == "unique":
            params.unique = int(val) if val else 1
        elif key == "decode_uart":
            params.decode_uart = val or "8n1"
        elif key == "decode_dm":
            params.decode_dm = int(val) if val else 1
        elif key == "decode_mc":
            params.decode_mc = int(val) if val else 1
        elif key == "symbol_zero":
            params.symbol_zero = _parse_symbol(val)
        elif key == "symbol_one":
            params.symbol_one = _parse_symbol(val)
        elif key == "symbol_sync":
            params.symbol_sync = _parse_symbol(val)
        elif key == "get":
            params.getters.append(_parse_getter(val))
        elif key in ("v", "verbose"):
            pass
        else:
            raise ValueError(f"flex: unknown keyword {key}")
    if not params.name:
        raise ValueError("flex: name missing")
    if not dev_kw["modulation"]:
        raise ValueError("flex: modulation missing")
    # note: reference requires short/long/reset for most modulations
    return dev_kw, params


def _row_hex(bits, row):
    n = bits.bits_per_row[row]
    b = bits.bb[row:].reshape(-1)
    s = "".join(f"{int(x):02x}" for x in b[: (n + 7) // 8])
    return s[: 2 * (n + 3) // 8]


def _render_getters(ev_items, row_bytes, params):
    for g in params.getters:
        if g.bit_count <= 0:
            continue
        if g.mask and (g.mask & (g.mask + 1)) != 0:
            val = _compact_number(row_bytes, g.bit_offset, g.mask)
        elif g.mask:
            val = _compact_number(row_bytes, g.bit_offset, g.mask)
        else:
            val = _extract_number(row_bytes, g.bit_offset, g.bit_count)
        mapped = None
        for k, v in g.map:
            if k == val:
                mapped = v
                break
        if mapped is not None:
            ev_items.append((g.name, mapped))
        else:
            # data_int takes a C int: values >= 2^31 wrap negative
            # (ref src/devices/flex.c:146 data_int(..., val))
            ival = int(val) & 0xFFFFFFFF
            if ival >= 1 << 31:
                ival -= 1 << 32
            ev_items.append((g.name, ival, "", g.format or None))


def make_decode_fn(params: FlexParams):
    def decode(bits: BitBuffer, dev):
        """Ref flex_callback (src/devices/flex.c:154-369)."""
        if (bits.num_rows < params.min_rows
                or (params.max_rows and bits.num_rows > params.max_rows)):
            return DECODE_ABORT_LENGTH
        match_count = 0
        for i in range(bits.num_rows):
            if (bits.bits_per_row[i] >= params.min_bits
                    and (not params.max_bits
                         or bits.bits_per_row[i] <= params.max_bits)):
                match_count += 1
        if not match_count:
            return DECODE_ABORT_LENGTH
        r = bits.find_repeated_row(params.min_repeats, params.min_bits)
        if r < 0:
            return DECODE_ABORT_EARLY

        if params.invert:
            bits.invert()
        if params.reflect:
            for i in range(bits.num_rows):
                n = (bits.bits_per_row[i] + 7) // 8
                flat = bits.bb[i:].reshape(-1)
                flat[:n] = util.reflect_bytes(bytes(flat[:n].tolist()))

        if params.match:
            pat, plen = params.match
            r = -1
            match_count = 0
            for i in range(bits.num_rows):
                if bits.search(i, 0, pat, plen) < bits.bits_per_row[i]:
                    if r < 0:
                        r = i
                    match_count += 1
            if not match_count:
                return DECODE_FAIL_SANITY

        if params.preamble:
            pat, plen = params.preamble
            r = -1
            match_count = 0
            for i in range(bits.num_rows):
                pos = bits.search(i, 0, pat, plen)
                if pos < bits.bits_per_row[i]:
                    if r < 0:
                        r = i
                    match_count += 1
                    pos += plen
                    length = bits.bits_per_row[i] - pos
                    extracted = bits.extract_bytes(i, pos, length)
                    flat = bits.bb[i:].reshape(-1)
                    flat[: len(extracted)] = extracted
                    bits.bits_per_row[i] = length
            if not match_count:
                return DECODE_FAIL_SANITY

        if params.symbol_zero:
            for i in range(bits.num_rows):
                n = bits.bits_per_row[i]
                row = bytes(bits.bb[i:].reshape(-1)[: (n + 7) // 8].tolist())
                out_bits = util.extract_bits_symbols(
                    row, 0, n, params.symbol_zero, params.symbol_one,
                    params.symbol_sync)
                flat = bits.bb[i:].reshape(-1)
                flat[: (len(out_bits) + 7) // 8] = 0
                for k, v in enumerate(out_bits):
                    if v:
                        flat[k // 8] |= 0x80 >> (k % 8)
                bits.bits_per_row[i] = len(out_bits)

        if params.decode_uart:
            fn = {"8n1": util.extract_bytes_uart_8n1,
                  "8n2": util.extract_bytes_uart_8n2,
                  "8o1": util.extract_bytes_uart_8o1}[params.decode_uart]
            for i in range(bits.num_rows):
                n = bits.bits_per_row[i]
                row = bytes(bits.bb[i:].reshape(-1)[: (n + 7) // 8].tolist())
                out = fn(row, 0, n)
                flat = bits.bb[i:].reshape(-1)
                for k, v in enumerate(out):
                    flat[k] = v
                bits.bits_per_row[i] = len(out) * 8

        if params.decode_dm:
            for i in range(bits.num_rows):
                tmp = BitBuffer()
                bits.differential_manchester_decode(i, 0, tmp, bits.bits_per_row[i])
                n = tmp.bits_per_row[0]
                flat = bits.bb[i:].reshape(-1)
                flat[: (n + 7) // 8] = tmp.bb[0, : (n + 7) // 8]
                bits.bits_per_row[i] = n

        if params.decode_mc:
            for i in range(bits.num_rows):
                tmp = BitBuffer()
                bits.manchester_decode(i, 0, tmp, bits.bits_per_row[i])
                n = tmp.bits_per_row[0]
                flat = bits.bb[i:].reshape(-1)
                flat[: (n + 7) // 8] = tmp.bb[0, : (n + 7) // 8]
                bits.bits_per_row[i] = n

        if params.unique:
            row_bytes = bits.row_bytes(r)
            items = [("model", params.name), ("count", match_count),
                     ("num_rows", bits.num_rows),
                     ("len", bits.bits_per_row[r]),
                     ("data", _row_hex(bits, r))]
            _render_getters(items, row_bytes, params)
            return [Event.make(*items)]

        if params.count_only:
            return [Event.make(("model", params.name), ("count", match_count))]

        rows = []
        codes = []
        for i in range(bits.num_rows):
            hexs = _row_hex(bits, i)
            items = [("len", bits.bits_per_row[i]), ("data", hexs)]
            _render_getters(items, bits.row_bytes(i), params)
            rows.append(Event.make(*items))
            codes.append(f"{{{bits.bits_per_row[i]}}}{hexs if hexs else '0'}")
        return [Event.make(
            ("model", params.name),
            ("count", match_count),
            ("num_rows", bits.num_rows),
            ("rows", rows),
            ("codes", codes),
        )]

    return decode


def flex_create_device(spec: str) -> RDevice:
    """Compile a -X spec into a registered decoder (ref flex_create_device,
    src/devices/flex.c:666-875)."""
    dev_kw, params = parse_spec(spec)
    dev = RDevice(num=0, symbol=f"flex_{params.name}", name=params.name,
                  **dev_kw)
    dev.fields = ["model", "count", "num_rows", "rows", "codes"] + \
        [g.name for g in params.getters]
    dev.decode_fn = make_decode_fn(params)
    return dev

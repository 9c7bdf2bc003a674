"""Misc decoders batch Q (reference files cited per function):
Vivint door/window sensors (Rabbit-cipher status field).
"""

from __future__ import annotations

from ..bits import util
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
    decoder,
)

_M32 = 0xFFFFFFFF
_RABBIT_A = [0x4D34D34D, 0xD34D34D3, 0x34D34D34, 0x4D34D34D,
             0xD34D34D3, 0x34D34D34, 0x4D34D34D, 0xD34D34D3]


def _rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & _M32


class _VivintRabbit:
    """Rabbit stream cipher core, RFC 4503 variant keyed by a 16-bit
    per-device seed (ref src/devices/vivint.c:79-316)."""

    def __init__(self, seed):
        self.m = bytearray(0x300)
        base = (seed ^ 0x0008) & 0xFFFF
        init = [base, (base + 0x25) & 0xFFFF, (base - 0x04) & 0xFFFF,
                (base + 0x2C) & 0xFFFF, (base - 0x09) & 0xFFFF,
                (base - 0x1D) & 0xFFFF, base ^ 0x00F9, base ^ 0x0022]
        for i in range(8):
            self.w16(0x27A + 2 * i, init[i])

    def r16(self, a):
        return self.m[a] | (self.m[a + 1] << 8)

    def w16(self, a, v):
        self.m[a] = v & 0xFF
        self.m[a + 1] = (v >> 8) & 0xFF

    def r32(self, a):
        return self.r16(a) | (self.r16(a + 2) << 16)

    def w32(self, a, v):
        self.w16(a, v & 0xFFFF)
        self.w16(a + 2, (v >> 16) & 0xFFFF)

    def key_setup(self):
        counter = self.r16(0x206)
        m = counter % 7
        self.w16(0x27A + m * 2, (self.r16(0x27A + m * 2) + counter + m)
                 & 0xFFFF)
        self.w16(0x288, self.r16(0x288) ^ m)
        e = [self.r16(0x27A + 2 * i) for i in range(8)]
        x_words = [0] * 16
        c_words = [0] * 16
        for r in range(8):
            if r % 2 == 0:
                x_words[2 * r] = e[r]
                x_words[2 * r + 1] = e[(r + 1) % 8]
                c_words[2 * r] = e[(r + 5) % 8]
                c_words[2 * r + 1] = e[(r + 4) % 8]
            else:
                x_words[2 * r] = e[(r + 4) % 8]
                x_words[2 * r + 1] = e[(r + 5) % 8]
                c_words[2 * r] = e[(r + 1) % 8]
                c_words[2 * r + 1] = e[r]
        for i in range(16):
            self.w16(0x232 + 2 * i, x_words[i])
            self.w16(0x252 + 2 * i, c_words[i])

    def next_state(self):
        scratch = 0x294
        for r8 in range(8):
            self.w16(scratch + r8 * 4, self.r16(0x252 + r8 * 4))
            self.w16(scratch + 2 + r8 * 4, self.r16(0x254 + r8 * 4))
        lcg = (self.r32(0x272) + _RABBIT_A[0]) & _M32
        self.w32(0x252, (self.r32(0x252) + lcg) & _M32)
        for r8 in range(1, 8):
            a = self.r32(0x252 + r8 * 4)
            b = self.r32(0x24E + r8 * 4)
            sub = self.r32(scratch - 4 + r8 * 4)
            borrow = 1 if b < sub else 0
            self.w32(0x252 + r8 * 4, (a + _RABBIT_A[r8] + borrow) & _M32)
        borrow = 1 if self.r32(0x26E) < self.r32(0x2B0) else 0
        self.w16(0x272, borrow)
        self.w16(0x274, 0)
        for r8 in range(8):
            x = (self.r32(0x232 + r8 * 4) + self.r32(0x252 + r8 * 4)) & _M32
            lo = x & 0xFFFF
            hi = x >> 16
            xsq = (x * x) & _M32
            acc = ((lo * lo) & _M32) >> 16 >> 1
            acc = (acc + lo * hi) & _M32
            acc >>= 15
            acc = (acc + hi * hi) & _M32
            acc ^= xsq
            self.w32(scratch + r8 * 4, acc)
        r11 = 7
        r10 = 6
        for r8 in (0, 2, 4, 6):
            t1 = _rotl32(self.r32(scratch + r11 * 4), 16)
            t2 = _rotl32(self.r32(scratch + r10 * 4), 16)
            self.w32(0x232 + r8 * 4,
                     (t1 + self.r32(scratch + r8 * 4) + t2) & _M32)
            r11 = (r11 + 1) % 8
            r10 = (r10 + 1) % 8
            t3 = _rotl32(self.r32(scratch + r11 * 4), 8)
            self.w32(0x236 + r8 * 4,
                     (t3 + self.r32(scratch + 4 + r8 * 4)
                      + self.r32(scratch + r10 * 4)) & _M32)
            r11 = (r11 + 1) % 8
            r10 = (r10 + 1) % 8

    def counter_remix(self):
        for r10 in range(8):
            r11 = r10 * 4
            r14 = ((r10 + 4) % 8) * 4
            self.w16(0x252 + r11,
                     self.r16(0x252 + r11) ^ self.r16(0x232 + r14))
            self.w16(0x254 + r11,
                     self.r16(0x254 + r11) ^ self.r16(0x234 + r14))

    def extract(self):
        k = self.r16(0x206) & 3
        if k == 0:
            r14 = self.r16(0x23E)
            r12 = self.r16(0x248) ^ self.r16(0x232)
            r13 = self.r16(0x234)
        elif k == 1:
            r14 = self.r16(0x246)
            r12 = self.r16(0x250) ^ self.r16(0x23A)
            r13 = self.r16(0x23C)
        elif k == 2:
            r14 = self.r16(0x24E)
            r12 = self.r16(0x238) ^ self.r16(0x242)
            r13 = self.r16(0x244)
        else:
            r14 = self.r16(0x236)
            r12 = self.r16(0x240) ^ self.r16(0x24A)
            r13 = self.r16(0x24C)
        r13 ^= r14
        self.m[0x2C1] = r12 & 0xFF
        self.m[0x2C2] = (r12 >> 8) & 0xFF
        self.m[0x2C3] = r13 & 0xFF
        self.m[0x2C4] = (r13 >> 8) & 0xFF

    def reseed(self):
        self.w16(0x272, 0)
        self.w16(0x274, 0)
        self.key_setup()
        for _ in range(4):
            self.next_state()
        self.counter_remix()
        self.next_state()
        self.extract()

    def tick(self, counter):
        counter = 0 if counter == 0xFFF7 else (counter + 1) & 0xFFFF
        self.w16(0x206, counter)
        if counter % 12 == 0:
            self.reseed()
        elif counter % 4 == 0:
            self.next_state()
            self.extract()
        else:
            self.extract()
        return counter, self.m[0x2C1]


_VIVINT_ENTRY_COUNTER = 0x17


class _VivintSeed:
    def __init__(self, sid, seed):
        self.id = sid
        self.seed = seed
        self.reset()

    def reset(self):
        self.gen = _VivintRabbit(self.seed)
        self.counter = _VIVINT_ENTRY_COUNTER
        self.last_c1 = 0
        self.has_last_c1 = False

    def c1_at(self, target):
        """Status-key byte at counter `target`
        (ref src/devices/vivint.c:343)."""
        if self.has_last_c1 and target == self.counter:
            return self.last_c1
        if target < self.counter:
            self.reset()
        steps = 0
        while self.counter != target:
            self.counter, c1 = self.gen.tick(self.counter)
            self.last_c1 = c1
            self.has_last_c1 = True
            if self.counter == target:
                return c1
            steps += 1
            if steps > 0x10000:
                return -1
        return -1


def _vivint_ctx(dev):
    ctx = getattr(dev, "_vivint_ctx", None)
    if ctx is None:
        ctx = []
        args = getattr(dev, "arg", None)
        if args:
            for tok in args.split(","):
                try:
                    idpart, seedhex = tok.split("=")
                    p1, p2 = idpart.split("-")
                    sid = ((int(p1) & 0xFFF) << 20) | (int(p2) & 0xFFFFF)
                    ctx.append(_VivintSeed(sid, int(seedhex, 16) & 0xFFFF))
                except ValueError:
                    continue
        dev._vivint_ctx = ctx
    return ctx


@decoder("vivint")
def vivint(bits, dev):
    """Vivint V-DW21R-345 / V-DW11-345 (ref src/devices/vivint.c:433)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bits.invert()
    pos = bits.search(0, 0, bytes([0xFF, 0xE0]), 12) + 12
    if bits.bits_per_row[0] - pos < 80:
        return DECODE_ABORT_LENGTH
    b = [int(x) for x in bits.extract_bytes(0, pos, 80)]
    event_type = b[0]
    counter = (b[1] << 8) | b[2]
    flags = b[3]
    sid = (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]
    crc = (b[8] << 8) | b[9]
    if sid == 0 or sid == 0xFFFFFFFF:
        return DECODE_FAIL_SANITY
    if event_type == 0xD0:
        crc_valid = crc == util.crc16(bytes(b[:8]), 8, 0x8050, 0)
    else:
        masked = bytes(b[:8] + [b[8] & 0xF0])
        check12 = util.crc16(masked, 9, 0x8050, 0) >> 4
        stored12 = ((b[8] & 0x0F) << 8) | b[9]
        crc_valid = check12 == stored12
    if not crc_valid:
        return DECODE_FAIL_MIC
    id_str = "%04u-%07u" % ((sid >> 20) & 0xFFF, sid & 0xFFFFF)
    has_contact = False
    dec = 0
    if event_type == 0x7A:
        for s in _vivint_ctx(dev):
            if s.id == sid:
                c1 = s.c1_at(counter & 0xFFFF)
                if c1 >= 0:
                    has_contact = True
                    dec = flags ^ c1
                break
    payload = "".join("%02x" % x for x in b[:10])
    return [Event.make(
        ("model", "Vivint-Security"),
        ("id", id_str, ""),
        ("counter", counter, "", "%04x"),
        ("flags", flags, "", "%02x"),
        ("event_type", event_type, "", "%02x"),
        ("state", "open" if dec & 0x80 else "closed", "")
        if has_contact else None,
        ("contact_open", 1 if dec & 0x80 else 0, "")
        if has_contact else None,
        ("tamper", 1 if dec & 0x40 else 0, "") if has_contact else None,
        ("reed", 1 if dec & 0x20 else 0, "") if has_contact else None,
        ("alarm", 1 if dec & 0x10 else 0, "") if has_contact else None,
        ("battery_low", 1 if dec & 0x08 else 0, "Battery")
        if has_contact else None,
        ("heartbeat", 1 if dec & 0x04 else 0, "") if has_contact else None,
        ("data", payload, "") if not has_contact else None,
        ("mic", "CRC", "Integrity"),
    )]


# --- Arad/Master Meter Dialog3G -------------------------------------------

_ARAD_MASK = 0xFFFFFFFFFF
_ARAD_KEY = 0x3037889DD8
_ARAD_GEN39 = 0x00014013F8
_ARAD_GEN31 = 0x201080D890
_ARAD_GEN23 = 0x00018F36C8
_ARAD_KEYS = []


def _arad_keys():
    """Per-bit checksum keys (ref src/devices/arad_ms_meter.c:258)."""
    if not _ARAD_KEYS:
        key = _ARAD_KEY
        keys = [0] * 88
        for j in range(87, -1, -1):
            keys[j] = key
            nxt = (key << 1) & _ARAD_MASK
            if key & (1 << 39):
                nxt ^= _ARAD_GEN39
            if key & (1 << 31):
                nxt ^= _ARAD_GEN31
            if key & (1 << 23):
                nxt ^= _ARAD_GEN23
            key = nxt
        _ARAD_KEYS.extend(keys)
    return _ARAD_KEYS


def _arad_checksum(b):
    keys = _arad_keys()
    s = 0
    for n in range(11):
        for i in range(8):
            if (b[n] >> (7 - i)) & 1:
                s ^= keys[n * 8 + i]
    return s


def _arad_correct_bits(b, syndrome):
    """Correct up to 3 flipped payload bits via the linear syndrome
    (ref src/devices/arad_ms_meter.c:296)."""
    keys = _arad_keys()

    def flip(i):
        b[i // 8] ^= 1 << (7 - (i % 8))

    for i in range(88):
        if keys[i] == syndrome:
            flip(i)
            return 1
    for i in range(88):
        ki = keys[i]
        for j in range(i + 1, 88):
            if (ki ^ keys[j]) == syndrome:
                flip(i)
                flip(j)
                return 2
    for i in range(88):
        for j in range(i + 1, 88):
            x = keys[i] ^ keys[j]
            for k in range(j + 1, 88):
                if (x ^ keys[k]) == syndrome:
                    flip(i)
                    flip(j)
                    flip(k)
                    return 3
    return -1


_ARAD_UNITS = {"m3": "m3", "l": "l", "liter": "l", "liters": "l",
               "cf": "cu ft", "cuft": "cu ft", "cu_ft": "cu ft",
               "usg": "gal", "gal": "gal", "gallon": "gal",
               "gallons": "gal"}
_ARAD_GEARS = {"0.01": 0.01, "0.1": 0.1, "1": 1.0, "1.0": 1.0, "10": 10.0,
               "10.0": 10.0, "100": 100.0, "100.0": 100.0}


def _arad_ctx(dev):
    ctx = getattr(dev, "_arad_ctx", None)
    if ctx is None:
        ctx = {"serials": [], "gear": None, "unit": None}
        args = getattr(dev, "arg", None) or ""
        import re
        for tok in re.split("[,:]", args):
            tok = tok.strip()
            if "=" not in tok:
                continue
            key, val = tok.split("=", 1)
            key = key.strip().lower()
            val = val.strip()
            if key in ("serial", "serials"):
                for s in val.split(";"):
                    s = s.strip()
                    if not s:
                        continue
                    if "-" in s:
                        ser, suf = s.split("-", 1)
                        try:
                            suf_v = int(suf.strip(), 0)
                            if suf_v <= 0xFF:
                                ctx["serials"].append(
                                    (int(ser.strip(), 0) & 0xFFFFFF, suf_v))
                        except ValueError:
                            pass
                    else:
                        try:
                            ctx["serials"].append((int(s, 0) & 0xFFFFFF, -1))
                        except ValueError:
                            pass
            elif key == "gear" and val in _ARAD_GEARS:
                ctx["gear"] = _ARAD_GEARS[val]
            elif key == "units" and val.lower() in _ARAD_UNITS:
                ctx["unit"] = _ARAD_UNITS[val.lower()]
        dev._arad_ctx = ctx
    return ctx


@decoder("arad_ms_meter")
def arad_ms_meter(bits, dev):
    """Arad/Master Meter Dialog3G (ref src/devices/arad_ms_meter.c:519)."""
    import numpy as np
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    if bits.bits_per_row[0] < 18 * 8:
        return DECODE_ABORT_LENGTH
    match_pos = bits.search(0, 0, bytes([0xF5, 0x13, 0x85, 0x37]), 32)
    if match_pos + 32 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    uid_start = max(0, match_pos - 16)
    payload_start = match_pos + 32
    if payload_start + 128 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    uid_bits = min(payload_start - uid_start, 56)
    bits.invert()
    u = [int(x) for x in bits.extract_bytes(0, uid_start, uid_bits)]
    uid_str = "".join("%02x" % x for x in u[:(uid_bits + 7) // 8])
    b = [int(x) for x in bits.extract_bytes(0, payload_start, 128)]
    xor_raw = (b[11] << 32) | (b[12] << 24) | (b[13] << 16) | (b[14] << 8) \
        | b[15]
    xor_cal = _arad_checksum(b)
    corrections = 0
    if xor_raw != xor_cal:
        corrections = _arad_correct_bits(b, xor_raw ^ xor_cal)
        if corrections < 0:
            return DECODE_FAIL_MIC
    leaking = (b[0] & 0x20) >> 5
    serno = b[1] | (b[2] << 8) | (b[3] << 16)
    sn_sufx = b[4]
    flags1 = b[5]
    wreadraw = b[6] | (b[7] << 8) | (b[8] << 16)
    flags2 = b[10]
    scale = 0.1
    unit = "m3"
    if sn_sufx == 0x00 and flags1 in (0x00, 0x40):
        scale = 0.01
        unit = "m3"
    elif sn_sufx == 0x27 and flags1 == 0x00:
        scale = 0.1
        unit = "gal"
    ctx = _arad_ctx(dev)
    if ctx["serials"]:
        ok = any(s == serno and (suf < 0 or suf == sn_sufx)
                 for s, suf in ctx["serials"])
        if not ok:
            return DECODE_ABORT_EARLY
    if ctx["gear"] is not None:
        scale = ctx["gear"]
    if ctx["unit"] is not None:
        unit = ctx["unit"]
    volume = float(np.float32(wreadraw) * np.float32(scale))
    return [Event.make(
        ("model", "AradMsMeter-Dialog3G"),
        ("id", "%08u-%02x" % (serno, sn_sufx), "Serial No"),
        ("uid", uid_str, "UID"),
        ("leaking", leaking, "Leaking"),
        ("flags1", flags1, "Flags 1", "%02x"),
        ("gear", float(np.float64(np.float32(scale))), "Gear"),
        ("volume", volume, "Volume"),
        ("unit", unit, "Unit"),
        ("flags2", flags2, "Flags 2", "%02x"),
        ("corrections", corrections, "Corrections"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

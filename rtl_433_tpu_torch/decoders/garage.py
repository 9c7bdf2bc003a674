"""Garage/gate/entry remotes and alarm sensors (reference files cited
per function): Microchip HCS200, Linear Megacode, Chuango, X10-Security,
Somfy RTS, Nice Flor-s, Visonic Powercode, Security+ v1/v2, Cavius,
DirecTV RC66RX.
"""

from __future__ import annotations

import time

from ..bits import util
from ..bits.bitbuffer import BitBuffer
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
    DECODE_FAIL_OTHER,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


@decoder("hcs200", "hcs200_fsk")
def hcs200(bits, dev):
    """Microchip HCS200/HCS300 KeeLoq remotes (ref src/devices/hcs200.c)."""
    if bits.bits_per_row[0] != 12 or (bits.num_rows < 2
                                      or bits.bits_per_row[1] != 66):
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if b[0] != 0xFF or (b[1] & 0xF0) != 0xF0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[1])
    if all(b[i] == 0xFF for i in range(1, 8)):
        return DECODE_FAIL_SANITY
    encrypted = ((util.reverse8(b[3]) << 24) | (util.reverse8(b[2]) << 16)
                 | (util.reverse8(b[1]) << 8) | util.reverse8(b[0]))
    serial = ((util.reverse8(b[7] & 0xF0) << 24) | (util.reverse8(b[6]) << 16)
              | (util.reverse8(b[5]) << 8) | util.reverse8(b[4]))
    btn = b[7] & 0x0F
    btn_num = (btn & 0x08) | ((btn & 0x01) << 2) | (btn & 0x02) | ((btn & 0x04) >> 2)
    return [Event.make(
        ("model", "Microchip-HCS200"),
        ("id", "%07X" % serial),
        ("battery_ok", int(not (b[8] & 0x80)), "Battery"),
        ("button", btn_num, "Button"),
        ("learn", int(btn == 0x0F), "Learn mode"),
        ("repeat", int((b[8] & 0x40) == 0x40), "Repeat"),
        ("encrypted", "%08X" % encrypted),
    )]


@decoder("megacode")
def megacode(bits, dev):
    """Linear Megacode garage/gate remotes (ref src/devices/megacode.c)."""
    row = bits.find_repeated_row(1, 144)
    if row < 0:
        return DECODE_ABORT_LENGTH
    length = bits.bits_per_row[row]
    if length < 136 or length > 148:
        return DECODE_ABORT_LENGTH
    b = bits.bb[row]
    raw = 0
    frames = 0
    for i in range(length):
        if (int(b[i // 8]) << (i % 8)) & 0x80:
            if (i + 4) % 6 > 2:
                raw |= 0x800000 >> ((i + 4) // 6)
            frames += 1
    if frames != 24:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Megacode-Remote"),
        ("id", (raw >> 3) & 0xFFFF, "Transmitter ID"),
        ("raw", raw, "Raw", "%06X"),
        ("facility", (raw >> 19) & 0xF, "Facility Code"),
        ("button", raw & 0x7, "Button"),
    )]


_CHUANGO_CMDS = {
    0xF: "?", 0xE: "?", 0xD: "Low Battery", 0xC: "Closing",
    0xB: "24H Zone", 0xA: "Single Delay Zone", 0x9: "?", 0x8: "Arm",
    0x7: "Normal Zone", 0x6: "Home Mode Zone", 0x5: "On", 0x4: "Home Mode",
    0x3: "Tamper", 0x2: "Alarm", 0x1: "Disarm", 0x0: "Test",
}


@decoder("chuango")
def chuango(bits, dev):
    """Chuango Security (x1527-style) (ref src/devices/chuango.c)."""
    if bits.bits_per_row[0] != 25:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    b[0] = ~b[0] & 0xFF
    b[1] = ~b[1] & 0xFF
    b[2] = ~b[2] & 0xFF
    if not (b[3] & 0x80) or (not b[0] and not b[1] and not (b[2] & 0xF0)):
        return DECODE_ABORT_EARLY
    cmd = b[2] & 0x0F
    return [Event.make(
        ("model", "Chuango-Security"),
        ("id", (b[0] << 12) | (b[1] << 4) | (b[2] >> 4), "ID"),
        ("cmd", _CHUANGO_CMDS.get(cmd, ""), "CMD"),
        ("cmd_id", cmd, "CMD_ID"),
    )]


@decoder("x10_sec")
def x10_sec(bits, dev):
    """X10 Security sensors (ref src/devices/x10_sec.c)."""
    if bits.num_rows != 2:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[1] < 41:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[1])
    if (b[0] ^ b[1]) != 0x0F or (b[2] ^ b[3]) != 0xFF:
        return DECODE_FAIL_SANITY
    parity = b[0] ^ b[1] ^ b[2] ^ b[3] ^ b[4] ^ (b[5] & 0x80)
    parity = (parity >> 4) ^ (parity & 0xF)
    parity = (parity >> 2) ^ (parity & 0x3)
    parity = (parity >> 1) ^ (parity & 0x1)
    if parity:
        return DECODE_FAIL_MIC
    battery_low = b[2] & 0x01
    event = b[2] & 0xFE
    event_str = "UNKNOWN"
    delay = 0
    tamper = 0
    if event in (0x00, 0x04, 0x40, 0x44):
        event_str = "DOOR/WINDOW OPEN"
        delay = int(not (b[2] & 0x04))
        tamper = (b[2] & 0x40) >> 6
    elif event in (0x80, 0x84, 0xC0, 0xC4):
        event_str = "DOOR/WINDOW CLOSED"
        delay = int(not (b[2] & 0x04))
        tamper = (b[2] & 0x40) >> 6
    elif event == 0x06:
        event_str = "KEY-FOB ARM"
    elif event in (0x0C, 0x4C):
        event_str = "MOTION TRIPPED"
        tamper = (b[2] & 0x40) >> 6
    elif event == 0x26:
        event_str = "KR18 PANIC"
    elif event == 0x42:
        event_str = "KEY-FOB LIGHTS A ON"
    elif event == 0x46:
        event_str = "KEY-FOB LIGHTS B ON"
    elif event == 0x82:
        event_str = "SH624 SEC-REMOTE DISARM"
    elif event == 0x86:
        event_str = "KEY-FOB DISARM"
    elif event == 0x88:
        event_str = "KR15 PANIC"
    elif event in (0x8C, 0xCC):
        event_str = "MOTION READY"
        tamper = (b[2] & 0x40) >> 6
    elif event == 0x98:
        event_str = "KR15 PANIC-3SECOND"
    elif event == 0xC2:
        event_str = "KEY-FOB LIGHTS A OFF"
    elif event == 0xC6:
        event_str = "KEY-FOB LIGHTS B OFF"
    return [Event.make(
        ("model", "X10-Security"),
        ("id", "%02x%02x" % (b[0], b[4]), "Device ID"),
        ("code", "%02x" % b[2], "Code"),
        ("event", event_str, "Event"),
        ("delay", delay, "Delay") if delay else None,
        ("battery_ok", int(not battery_low), "Battery") if battery_low else None,
        ("tamper", tamper, "Tamper") if tamper else None,
        ("mic", "CRC", "Integrity"),
    )]


_SOMFY_CONTROLS = [
    "? (0)", "My (1)", "Up (2)", "My + Up (3)", "Down (4)", "My + Down (5)",
    "Up + Down (6)", "My + Up + Down (7)", "Prog (8)", "Sun + Flag (9)",
    "Flag (10)", "? (11)", "? (12)", "? (13)", "? (14)", "? (15)",
]
_SOMFY_SEEDS = [
    "? (0)", "? (1)", "? (2)", "? (3)", "? (4)", "Stop (5)", "Up (6)",
    "? (7)", "Down (8)", "? (9)", "? (10)", "? (11)", "Prog (12)",
    "? (13)", "? (14)", "? (15)",
]


@decoder("somfy_rts")
def somfy_rts(bits, dev):
    """Somfy RTS blinds remote (ref src/devices/somfy_rts.c)."""
    pre_long = bytes([0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xFF, 0x00])
    pre_rate = bytes([0xF0, 0xF0, 0xF0, 0xF0, 0xF0, 0xFE, 0x00])
    pre_short = bytes([0xF0, 0xF0, 0xFF, 0x00])
    is_retransmission = 0
    decode_row = -1
    bitpos = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] > 170:
            is_retransmission = 1
            bitpos = bits.search(row, 0, pre_long, 49) + 49
            if bitpos + 56 * 2 > bits.bits_per_row[row]:
                bitpos = bits.search(row, 0, pre_rate, 48) + 48
            if bitpos + 56 * 2 <= bits.bits_per_row[row]:
                decode_row = row
                break
        elif bits.bits_per_row[row] > 130:
            is_retransmission = 0
            bitpos = bits.search(row, 0, pre_short, 25) + 25
            if bitpos + 56 * 2 <= bits.bits_per_row[row]:
                decode_row = row
                break
    if decode_row < 0:
        return DECODE_ABORT_EARLY
    if bitpos + 56 * 2 > bits.bits_per_row[decode_row]:
        return DECODE_ABORT_LENGTH
    decoded = BitBuffer()
    bits.manchester_decode(decode_row, bitpos, decoded, 80)
    if decoded.num_rows == 0 or decoded.bits_per_row[0] < 56:
        return DECODE_ABORT_LENGTH
    b = _ints(decoded.bb[0])
    for i in range(6, 0, -1):
        b[i] ^= b[i - 1]
    chk = util.xor_bytes(bytes(b[:7]), 7)
    if ((chk & 0xF) ^ (chk >> 4)) != 0:
        return DECODE_FAIL_MIC
    seed = b[0]
    control = (b[1] & 0xF0) >> 4
    counter = (b[2] << 8) | b[3]
    address = (b[6] << 16) | (b[5] << 8) | b[4]
    control_str = _SOMFY_CONTROLS[control]
    if control == 0xF:
        control_str = _SOMFY_SEEDS[seed & 0xF]  # TEL-FIX quirk
    return [Event.make(
        ("model", "Somfy-RTS"),
        ("id", address, "", "%06X"),
        ("control", control_str, "Control"),
        ("counter", counter, "Counter"),
        ("retransmission", is_retransmission, "Retransmission"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_NICE_LEAF = [
    25, 5, 63, 97, 203, 109, 69, 10, 3, 7, 64, 5, 71, 134, 180, 74,
    41, 158, 102, 199, 93, 118, 175, 101, 60, 77, 143, 174, 103, 148, 29, 85,
]


def _nice_pl_reverse(p):
    """Nice Flor-s code de-obfuscation (ref src/devices/nice_flor_s.c:38-76)."""
    def xor_array(k):
        for i in range(1, 6):
            p[i] ^= k

    k = ~p[4] & 0xFF
    p[5] = ~p[5] & 0xFF
    p[4] = ~p[2] & 0xFF
    p[2] = ~p[0] & 0xFF
    p[0] = k
    k = ~p[3] & 0xFF
    p[3] = ~p[1] & 0xFF
    p[1] = k
    for y in range(2):
        k = (_NICE_LEAF[p[0] >> 3] + 0x25) & 0xFF
        xor_array(k)
        p[5] &= 0x0F
        p[0] ^= k & 0x7
        k = _NICE_LEAF[p[0] & 0x1F]
        xor_array(k)
        p[5] &= 0x0F
        p[0] ^= k & 0xE0
        if y == 0:
            p[0], p[1] = p[1], p[0]
    return (p[1] << 8) | p[0]


@decoder("nice_flor_s")
def nice_flor_s(bits, dev):
    """Nice Flor-s gate remote (ref src/devices/nice_flor_s.c)."""
    if bits.num_rows != 2 or bits.bits_per_row[1] != 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] not in (52, 72):
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[0])
    t_buf = [(b[0] >> 4) & 0x0F]
    for i in range(6):
        t_buf.append(((b[i] << 4) & 0xF0) | ((b[i + 1] >> 4) & 0x0F))
    p = [t_buf[6], t_buf[5], t_buf[4], t_buf[3], t_buf[2], t_buf[1] & 0x0F, 0]
    code = _nice_pl_reverse(p)
    serial = (p[5] << 24) | (p[4] << 16) | (p[3] << 8) | p[2]
    return [Event.make(
        ("model", "Nice-FlorS"),
        ("button", t_buf[0] & 0x0F, "Button ID"),
        ("serial", serial, "Serial", "%07x"),
        ("code", code, "Code", "%04x"),
        ("count", ((t_buf[1] >> 4) & 0x0F) ^ (t_buf[0] & 0x0F) ^ 0x0F),
    )]


@decoder("visonic_powercode")
def visonic_powercode(bits, dev):
    """Visonic Powercode sensors (ref src/devices/visonic_powercode.c)."""
    row = bits.find_repeated_row(2, 37)
    if row == -1 or bits.bits_per_row[row] != 37:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(row, 1, 36))
    if not any(msg[:5]):
        return DECODE_FAIL_SANITY
    lrc = util.xor_bytes(bytes(msg[:5]), 5)
    if ((lrc >> 4) ^ (lrc & 0xF)) != 0:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Visonic-Powercode", "Model"),
        ("id", "%02x%02x%02x" % (msg[0], msg[1], msg[2]), "ID"),
        ("tamper", int((msg[3] & 0x80) == 0x80), "Tamper"),
        ("alarm", int((msg[3] & 0x40) == 0x40), "Alarm"),
        ("battery_ok", int((msg[3] & 0x20) != 0x20), "Battery"),
        ("else", int((msg[3] & 0x10) == 0x10), "Else"),
        ("restore", int((msg[3] & 0x08) == 0x08), "Restore"),
        ("supervised", int((msg[3] & 0x04) == 0x04), "Supervised"),
        ("spidernet", int((msg[3] & 0x02) == 0x02), "Spidernet"),
        ("repeater", int((msg[3] & 0x01) == 0x01), "Repeater"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


# --- Security+ 1.0 ----------------------------------------------------------

_SECV1_CACHE_MAX_AGE = 0.8  # seconds (ref src/devices/secplus_v1.c:137)


def _secplus_v1_decode_half(buf):
    """Binary groups-of-ones to trinary (ref src/devices/secplus_v1.c:58-100).

    Returns the digit list or None on invalid run length.
    """
    result = []
    x = 0
    for i in range(11):
        for j in range(8):
            if (buf[i] << j) & 0x80:
                x += 1
            else:
                if x == 0:
                    continue
                if x > 3:
                    return None
                result.append(x - 1)
                x = 0
    return result


def _secplus_v1_find_next(bits, cur):
    """Locate next packet start (ref src/devices/secplus_v1.c:112-134)."""
    b0 = int(bits.bb[0][0])
    if cur == 0 and ((b0 & 0xF0) == 0x10 or (b0 & 0xF0) == 0x70):
        return 0
    if cur == 0 and ((b0 & 0xE0) == 0xE0 or (b0 & 0xC0) == 0x80):
        return 0
    i1 = bits.search(0, cur, bytes([0x02]), 8) + 3
    i2 = bits.search(0, cur, bytes([0x07]), 8) + 3
    return min(i1, i2)


@decoder("secplus_v1")
def secplus_v1(bits, dev):
    """Security+ 1.0 rolling-code keyfob (ref src/devices/secplus_v1.c).

    Stateful: the two halves of a transmission arrive as separate packages
    and the first is cached (800 ms) until the second arrives.
    """
    length = bits.bits_per_row[0]
    if length < 84 or length > 130:
        return DECODE_ABORT_LENGTH

    result_1 = result_2 = None
    status = 0
    search_index = 0
    while search_index < length and status == 0:
        search_index = _secplus_v1_find_next(bits, search_index)
        if search_index + 84 > length:
            break
        buf = _ints(bits.extract_bytes(0, search_index, 84))
        digits = _secplus_v1_decode_half(buf)
        if digits is not None:
            # the reference stores into a zero-filled 22-byte buffer
            digits = (digits + [0] * 22)[:22]
        dr = -1 if digits is None else digits[0]
        if dr < 0 or dr == 1:
            search_index += 4
            continue
        if dr == 0:
            result_1 = digits
            status ^= 0x1
            search_index += 88
        elif dr == 2:
            result_2 = digits
            status ^= 0x2
            search_index += 88
        if status == 3:
            break
    if status == 0:
        return DECODE_FAIL_OTHER

    cache = getattr(dev, "_secplus_v1_cache", None)
    if cache is not None:
        cached_digits, cached_t = cache
        if time.monotonic() - cached_t < _SECV1_CACHE_MAX_AGE:
            if status == 2 and cached_digits[0] == 0:
                result_1 = cached_digits
                status = 3
            elif status == 1 and cached_digits[0] == 2:
                result_2 = cached_digits
                status = 3
        dev._secplus_v1_cache = None

    if status == 1:
        dev._secplus_v1_cache = (result_1, time.monotonic())
        return DECODE_FAIL_OTHER
    if status == 2:
        dev._secplus_v1_cache = (result_2, time.monotonic())
        return DECODE_FAIL_OTHER

    rolling_temp = 0
    fixed = 0
    for res in (result_1, result_2):
        digits = res[1:21]
        acc = 0
        for i in range(0, 20, 2):
            digit = digits[i]
            rolling_temp = (rolling_temp * 3 + digit) & 0xFFFFFFFF
            acc += digit
            digit = (60 + digits[i + 1] - acc) % 3
            fixed = fixed * 3 + digit
            acc += digit
    rolling = util.reverse32(rolling_temp)

    switch_id = fixed % 3
    id0 = (fixed // 3) % 3
    id1 = (fixed // 9) % 3
    pad_id = 0
    pin = 0
    pin_s = ""
    remote_id = 0
    button = ""
    if id1 == 0:
        pad_id = (fixed // 27) % 2187
        dev_id = pad_id
        pin = (fixed // 59049) % 19683
        if 0 <= pin <= 9999:
            pin_s = "%04d" % pin
        elif 10000 <= pin <= 11029:
            pin_s = "enter"
        pin_suffix = (fixed // 1162261467) % 3
        if pin_suffix == 1:
            pin_s += "#"
        elif pin_suffix == 2:
            pin_s += "*"
    else:
        # the reference computes `(int)fixed / 27`: fixed (uint32) is cast
        # to signed and the divide truncates toward zero (ref secplus_v1.c:322)
        sf = _s32(fixed)
        remote_id = -((-sf) // 27) if sf < 0 else sf // 27
        dev_id = remote_id
        if switch_id == 1:
            button = "left"
        elif switch_id == 0:
            button = "middle"
        elif switch_id == 2:
            button = "right"
    return [Event.make(
        ("model", "Secplus-v1"),
        ("id", dev_id),
        ("id0", id0, "ID_0"),
        ("id1", id1, "ID_1"),
        ("switch_id", switch_id, "Switch-ID"),
        ("pad_id", pad_id, "Pad-ID") if pad_id else None,
        ("pin", pin_s, "Pin") if pin else None,
        ("remote_id", remote_id, "Remote-ID") if remote_id else None,
        ("button_id", button, "Button-ID") if remote_id else None,
        ("fixed", "%u" % fixed, "Fixed_Code"),
        ("rolling", "%u" % rolling, "Rolling_Code"),
    )]


# --- Security+ 2.0 ----------------------------------------------------------

_SECV2_INVERT = {
    0x00: (True, True, False), 0x01: (False, True, False),
    0x02: (False, False, True), 0x04: (True, True, True),
    0x05: (True, False, True), 0x0A: (True, False, True),
    0x06: (False, True, True), 0x08: (True, False, False),
    0x09: (False, False, False),
}
_SECV2_ORDER = {
    0x06: (2, 1, 0), 0x09: (2, 1, 0), 0x08: (1, 2, 0), 0x04: (1, 2, 0),
    0x01: (2, 0, 1), 0x00: (0, 2, 1), 0x05: (1, 0, 2), 0x02: (0, 1, 2),
    0x0A: (0, 1, 2),
}


def _secplus_v2_decode_half(mc):
    """Decode one Security+ 2.0 half (ref src/devices/secplus_v2.c:84-233).

    Returns (roll_array, fixed_20bits) or None on sanity failure.
    """
    buf = mc.extract_bytes(0, 4, 8)
    order = int(buf[0]) >> 4
    invert = int(buf[0]) & 0x0F
    buf = mc.extract_bytes(0, 12, 30)
    x = ((int(buf[0]) << 24) | (int(buf[1]) << 16)
         | (int(buf[2]) << 8) | int(buf[3])) >> 2
    p = [0, 0, 0]
    for i in range(10):
        p[2] ^= (x & 1) << i
        x >>= 1
        p[1] ^= (x & 1) << i
        x >>= 1
        p[0] ^= (x & 1) << i
        x >>= 1
    if invert not in _SECV2_INVERT:
        return None
    inv = _SECV2_INVERT[invert]
    for i in range(3):
        if inv[i]:
            p[i] = ~p[i] & 0x03FF
    if order not in _SECV2_ORDER:
        return None
    dest = _SECV2_ORDER[order]
    q = [0, 0, 0]
    for i in range(3):
        q[dest[i]] = p[i]
    p0, p1, p2 = q
    roll = []
    ob = int(mc.extract_bytes(0, 4, 8)[0])
    for i in range(6, -1, -2):
        roll.append((ob >> i) & 0x03)
    for i in range(8, -1, -2):
        roll.append((p2 >> i) & 0x03)
    if any(r == 3 for r in roll):
        return None
    fixed = (p0 << 10) | p1
    return roll, fixed


@decoder("secplus_v2")
def secplus_v2(bits, dev):
    """Security+ 2.0 rolling-code keyfob (ref src/devices/secplus_v2.c).

    Stateful: caches one half (800 ms) until the other arrives; both
    halves may also appear as two rows of one package.
    """
    preamble = bytes([0xAA, 0xAA, 0x95, 0x60])
    half_1 = half_2 = None
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 110:
            continue
        idx = bits.search(row, 0, preamble, 28)
        if idx >= bits.bits_per_row[row]:
            break
        mc = BitBuffer()
        bits.manchester_decode(row, idx + 26, mc, 80)
        if mc.bits_per_row[0] < 42:
            continue
        b0 = int(mc.bb[0][0])
        if b0 & 0xB0:
            continue
        half = _secplus_v2_decode_half(mc)
        if b0 & 0xC0:
            half_2 = half or half_2
        else:
            half_1 = half or half_1
        if half_1 and half_2:
            break

    if half_1 and half_2:
        dev._secplus_v2_cache = {}
    else:
        cache = getattr(dev, "_secplus_v2_cache", None) or {}
        now = time.monotonic()
        if half_1:
            cache[1] = (half_1, now)
        if half_2:
            cache[2] = (half_2, now)
        dev._secplus_v2_cache = cache
        if 1 in cache and 2 in cache:
            t1 = cache[1][1]
            t2 = cache[2][1]
            if abs(t1 - t2) < 0.8:
                half_1 = cache[1][0]
                half_2 = cache[2][0]
                dev._secplus_v2_cache = {}
            else:
                dev._secplus_v2_cache = {}
                return DECODE_FAIL_SANITY
        else:
            return DECODE_FAIL_SANITY

    if not half_1 or not half_2:
        return DECODE_FAIL_SANITY
    roll_1, fixed_1 = half_1
    roll_2, fixed_2 = half_2

    digits = [roll_2[8], roll_1[8]]
    digits += roll_2[4:8] + roll_1[4:8] + roll_2[0:4] + roll_1[0:4]
    rolling_temp = 0
    for i in range(18):
        rolling_temp = rolling_temp * 3 + digits[i]
    if rolling_temp >= 0x10000000:
        return DECODE_FAIL_SANITY
    rolling_total = util.reverse32(rolling_temp) >> 4

    fixed_total = (fixed_1 << 20) | fixed_2
    return [Event.make(
        ("model", "Secplus-v2", "Model"),
        ("id", _s32(fixed_total & 0xFFFFFFFF)),
        ("button_id", fixed_total >> 32, "Button-ID"),
        ("remote_id", _s32(fixed_total & 0xFFFFFFFF), "Remote-ID"),
        ("fixed", "%u" % fixed_total, "Fixed_Code"),
        ("rolling", "%u" % rolling_total, "Rolling_Code"),
    )]


# --- Cavius ------------------------------------------------------------------

_CAVIUS_TEXT = {
    0x20: "Fire alarm", 0x04: "Alarm muted", 0x80: "Pairing",
    0x40: "Test alarm", 0x10: "Warning/Water detected",
}


@decoder("cavius")
def cavius(bits, dev):
    """Cavius smoke/heat/water alarms (ref src/devices/cavius.c:41-120)."""
    preamble = bytes([0x43, 0x61, 0x76, 0x69])  # 'Cavi'
    offset = bits.search(0, 0, preamble, 32)
    if offset + 22 * 8 >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    offset += 32
    databits = BitBuffer()
    bits.manchester_decode(0, offset, databits, 88)
    databits.invert()
    if databits.bits_per_row[0] < 88:
        return DECODE_FAIL_SANITY
    b = _ints(databits.bb[0])
    if util.crc8le(bytes(b[:7]), 7, 0x31, 0x0) != 0:
        return DECODE_FAIL_MIC
    batt_low = (b[4] & 0x08) != 0
    message = b[4] & ~0x08
    text = _CAVIUS_TEXT.get(message, "Battery low" if batt_low else "Unknown")
    net_id = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    sender_id = (b[7] << 24) | (b[8] << 16) | (b[9] << 8) | b[10]
    return [Event.make(
        ("model", "Cavius-Security"),
        ("id", _s32(sender_id), "Device ID"),
        ("battery_ok", int(not batt_low), "Battery"),
        ("net_id", _s32(net_id), "Net ID"),
        ("message", message, "Message"),
        ("text", text, "Description"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("cavius_door")
def cavius_door(bits, dev):
    """Cavius door/window sensor (ref src/devices/cavius.c:148-230)."""
    preamble = bytes([0xAA, 0xAA, 0xAA, 0xD3, 0x15, 0x27])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    row_len = bits.bits_per_row[0]
    offset = bits.search(0, 0, preamble, 48)
    if offset >= row_len:
        return DECODE_ABORT_EARLY
    offset += 48
    if offset + 9 * 8 > row_len:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 9 * 8))
    if util.crc8(bytes(b[:8]), 8, 0x07, 0x00) != b[8]:
        return DECODE_FAIL_MIC
    if b[7] == 0x25:
        state = "open"
    elif b[7] == 0x24:
        state = "closed"
    else:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Cavius-Door"),
        ("id", "%02x%02x%02x%02x%02x%02x" % tuple(b[1:7])),
        ("state", state),
        ("counter", b[0]),
        ("mic", "CRC"),
    )]


# --- DirecTV -----------------------------------------------------------------

_DTV_BUTTONS = {
    0x01: "1", 0x02: "2", 0x03: "3", 0x04: "4", 0x05: "5", 0x06: "6",
    0x07: "7", 0x08: "8", 0x09: "9", 0x0D: "CH UP", 0x0E: "CH DOWN",
    0x0F: "CH PREV", 0x10: "PWR", 0x11: "0", 0x12: "DASH", 0x13: "ENTER",
    0x14: "DASH REPEAT", 0x15: "ENTER REPEAT", 0x20: "MENU", 0x21: "UP",
    0x22: "DOWN", 0x23: "LEFT", 0x24: "RIGHT", 0x25: "SELECT", 0x26: "EXIT",
    0x27: "BACK", 0x28: "GUIDE", 0x29: "ACTIVE", 0x2A: "LIST",
    0x2B: "LIST REPEAT", 0x2C: "INFO REPEAT", 0x2D: "GUIDE REPEAT",
    0x2E: "INFO", 0x30: "VCR PLAY", 0x31: "VCR STOP", 0x32: "VCR PAUSE",
    0x33: "VCR RWD", 0x34: "VCR FFD", 0x35: "VCR REC", 0x36: "VCR BACK",
    0x37: "VCR SKIP", 0x38: "VCR SKIP REPEAT", 0x3A: "VCR PLAY REPEAT",
    0x3B: "VCR PAUSE REPEAT", 0x3C: "VCR RWD REPEAT", 0x3D: "VCR FFD REPEAT",
    0x3E: "VCR REC REPEAT", 0x3F: "VCR BACK REPEAT", 0x41: "RED",
    0x42: "YELLOW", 0x43: "GREEN", 0x44: "BLUE", 0x45: "MENU REPEAT",
    0x46: "ACTIVE REPEAT", 0x4A: "RED REPEAT", 0x4B: "YELLOW REPEAT",
    0x4C: "GREEN REPEAT", 0x4D: "BLUE REPEAT", 0x51: "TV: VCR ALERT",
    0x59: "VOLUME ALERT", 0x5A: "AV1/AV2/TV: IR ALERT 1",
    0x5B: "DTV: IR ALERT", 0x5C: "AV1/AV2/TV: IR ALERT 2",
    0x5D: "TV: DTV ALERT", 0x5E: "AV1: DTV ALERT", 0x5F: "AV2: DTV ALERT",
    0x60: "0 REPEAT", 0x61: "1 REPEAT", 0x62: "2 REPEAT", 0x63: "3 REPEAT",
    0x64: "4 REPEAT", 0x65: "5 REPEAT", 0x66: "6 REPEAT", 0x67: "7 REPEAT",
    0x68: "8 REPEAT", 0x69: "9 REPEAT", 0x73: "FORMAT",
    0x75: "FORMAT REPEAT", 0x80: "DTV: DTV&TV POWER ON",
    0x81: "DTV: DTV&TV POWER OFF", 0xD6: "SELECT RELEASE",
}


def _dpwm_decode(bitrow, bit_len):
    """Differential PWM decode (ref src/devices/directv.c:216-266).

    Returns (data_bits: list[int], sync_pos, sync_len). A run of >=3 alike
    symbols is a sync (resets data); runs of 1/2 decode to bits 0/1 at each
    transition; the trailing unflushed run is dropped.
    """
    out = []
    buf_pos = -1
    cur_len = None  # plays the C code's (unsigned)-1 initial value
    sync_pos = 0
    sync_len = 0
    sync_in_progress = True
    prev = None
    for pos in range(bit_len):
        this = (bitrow[pos // 8] >> (7 - (pos % 8))) & 1
        if this == prev:
            cur_len += 1
            if cur_len > 1:
                sync_in_progress = True
        else:
            if sync_in_progress:
                sync_len = cur_len + 1 if cur_len is not None else 0
                sync_pos = pos - cur_len - 1 if cur_len is not None else 0
                buf_pos = -1
                out = []
                sync_in_progress = False
            else:
                if buf_pos >= 0:
                    out.append(1 if cur_len else 0)
                buf_pos += 1
            cur_len = 0
        prev = this
    if sync_in_progress:
        buf_pos -= 1
    return out[:max(buf_pos, 0)], sync_pos, sync_len


@decoder("directv")
def directv(bits, dev):
    """DirecTV RC66RX remote (ref src/devices/directv.c)."""
    bit_len = bits.bits_per_row[0]
    if bit_len < 44 or bit_len > 99:
        return DECODE_FAIL_SANITY
    bitrow = _ints(bits.extract_bytes(0, 0, bit_len))
    data, sync_pos, sync_len = _dpwm_decode(bitrow, bit_len)
    if len(data) != 40:
        return DECODE_ABORT_LENGTH
    b = [0, 0, 0, 0, 0]
    for i, bit in enumerate(data):
        if bit:
            b[i // 8] |= 0x80 >> (i % 8)
    if b[0] != 0x10:
        return DECODE_FAIL_SANITY
    checksum = ((b[0] >> 4) + (b[0] & 0xF) + (b[1] >> 4) + (b[1] & 0xF)
                + (b[2] >> 4) + (b[2] & 0xF) + (b[3] >> 4) + (b[3] & 0xF)
                + (b[4] >> 4)) & 0xF
    if checksum != (b[4] & 0xF):
        return DECODE_FAIL_MIC
    device_id = (b[1] << 12) | (b[2] << 4) | (b[3] >> 4)
    if device_id > 999999:
        return DECODE_FAIL_SANITY
    button_id = ((b[3] << 4) | (b[4] >> 4)) & 0xFF
    return [Event.make(
        ("model", "DirecTV-RC66RX"),
        ("id", device_id, "", "%06d"),
        ("button_id", button_id, "", "0x%02X"),
        ("button_name", _DTV_BUTTONS.get(button_id, "unknown")),
        ("event", "INITIAL" if sync_len > 5 else "REPEAT"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _s32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000

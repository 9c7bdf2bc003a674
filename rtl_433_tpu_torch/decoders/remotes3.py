"""Remotes / home automation, part 3 (reference files cited per
function): Markisol curtains, Quinetic switches, Regency fan, Yale HSA,
Proflame 2, Funkbus/Instafunk.
"""

from __future__ import annotations

from ..bits import util
from ..bits.bitbuffer import BitBuffer
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


_MARKISOL_CONTROL = [
    "Limit (0)", "Down (1)", "? (2)", "H-Down (3)", "Confirm (4)",
    "Stop (5)", "? (6)", "? (7)", "? (8)", "? (9)", "? (10)", "? (11)",
    "Up (12)", "Limit (13)", "H-Up (14)", "? (15)",
]


@decoder("markisol")
def markisol(bits, dev):
    """Markisol / E-Motion / BOFU curtain remote
    (ref src/devices/markisol.c)."""
    buf = None
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] in (41, 42):
            b = _ints(bits.bb[i])
            buf = [(~util.reverse8(((b[j] << 1) | (b[j + 1] >> 7)) & 0xFF))
                   & 0xFF for j in range(5)]
            break
    if buf is None:
        return DECODE_ABORT_EARLY
    if sum(buf) & 0xFF != 1:
        return DECODE_FAIL_MIC
    control = ((buf[2] >> 4) & ~2 & 0xF) | ((buf[3] & 0x10) >> 3)
    return [Event.make(
        ("model", "Markisol", "Model"),
        ("id", (buf[0] << 8) | buf[1], "", "%04X"),
        ("control", _MARKISOL_CONTROL[control], "Control"),
        ("channel", buf[2] & 0xF, "Channel"),
        ("zone", ((buf[2] & 0x20) >> 5) + ((buf[3] & 0x80) >> 6) + 1,
         "Zone"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("quinetic")
def quinetic(bits, dev):
    """Quinetic switches and sensors (ref src/devices/quinetic.c)."""
    if bits.bits_per_row[0] < 110 or bits.bits_per_row[0] > 140:
        return DECODE_ABORT_LENGTH
    sync = bits.search(0, 0, bytes([0xA4, 0x23]), 16)
    if sync >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, sync + 16, 40))
    if util.crc16(bytes(b), 5, 0x1021, 0x1D0F) != 0:
        return DECODE_FAIL_MIC
    if b[2] == 192:  # button release: button number unknown
        return DECODE_ABORT_EARLY
    return [Event.make(
        ("model", "Quinetic", "Model"),
        ("id", (b[0] << 8) | b[1], "ID", "%04x"),
        ("channel", b[2], "Channel"),
        ("mic", "CRC", "Integrity"),
    )]


_REGENCY_COMMANDS = ["invalid", "fan_speed", "fan_speed", "invalid",
                     "light_intensity", "light_delay", "fan_direction"]


@decoder("regency_fan")
def regency_fan(bits, dev):
    """Regency ceiling fan remote (ref src/devices/regency_fan.c)."""
    bits.invert()
    row = bits.find_repeated_row(4, 21)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 21:
        return DECODE_ABORT_LENGTH
    b = [util.reverse8(x) for x in _ints(bits.extract_bytes(row, 1, 20))]
    if (util.add_nibbles(bytes(b[:2]), 2) & 0x0F) != b[2]:
        return DECODE_FAIL_MIC
    command = b[0] >> 4
    value = b[1]
    if command == 1:
        value_string = "stop"
    elif command == 2:
        if value < 0x01 or value > 0x07:
            return DECODE_FAIL_SANITY
        value_string = "speed %d" % value
    elif command == 4:
        if value > 0xC3:
            return DECODE_FAIL_SANITY
        value_string = "%d %%" % value
    elif command == 5:
        if value not in (0x00, 0x01):
            return DECODE_FAIL_SANITY
        value_string = "off" if value == 0 else "on"
    elif command == 6:
        if value not in (0x07, 0x83):
            return DECODE_FAIL_SANITY
        value_string = "clockwise" if value == 0x07 else "counter-clockwise"
    else:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Regency-Remote"),
        ("channel", ~b[0] & 0x0F, ""),
        ("command", _REGENCY_COMMANDS[command], ""),
        ("value", value_string, ""),
        ("mic", "CHECKSUM", ""),
    )]


@decoder("yale_hsa")
def yale_hsa(bits, dev):
    """Yale HSA home security alarm (ref src/devices/yale_hsa.c)."""
    if bits.num_rows < 6:
        return DECODE_ABORT_EARLY
    row = 0
    while row < bits.num_rows:
        msg = [0] * 6
        ok = False
        i = 0
        start_row = row
        while i < 6 and row < bits.num_rows:
            if bits.bits_per_row[row] != 13:
                break
            b0 = int(bits.bb[row][0])
            if (b0 & 0xF0) != 0x50:
                break
            eom = b0 & 0x08
            if (i < 5 and eom) or (i == 5 and not eom):
                break
            msg[i] = int(bits.extract_bytes(row, 5, 8)[0])
            if i == 5:
                ok = True
            i += 1
            row += 1
        if not ok:
            # skip to end-of-message
            row = start_row
            while row < bits.num_rows:
                if int(bits.bb[row][0]) & 0x08:
                    break
                row += 1
            row += 1
            continue
        if util.add_bytes(bytes(msg)) & 0xFF:
            row += 1
            continue
        return [Event.make(
            ("model", "Yale-HSA"),
            ("id", (msg[0] << 8) | msg[1], "", "%04x"),
            ("stype", msg[2], "Sensor type", "%02x"),
            ("state", msg[3], "State", "%02x"),
            ("event", msg[4], "Event", "%02x"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return 0


def _proflame2_mc(bits, row, start, out):
    """Sync-framed Manchester words (ref src/devices/proflame2.c:45)."""
    pos = start
    f = 0
    while True:
        if bits.bits_per_row[row] - pos < 26:
            return f
        b = bits.bb[row]
        sync = (util.bit_at(b, pos) << 3 | util.bit_at(b, pos + 1) << 2
                | util.bit_at(b, pos + 2) << 1 | util.bit_at(b, pos + 3))
        pos += 4
        if sync != 0xE:
            return f
        decoded = BitBuffer()
        pos = bits.manchester_decode(row, pos, decoded, 11)
        if decoded.bits_per_row[0] != 11:
            return f
        data = int(decoded.bb[0][0]) ^ 0xFF
        flag = int(decoded.bb[0][1]) ^ 0xE0
        pad = (flag >> 7) & 1
        par = (flag >> 6) & 1
        end = (flag >> 5) & 1
        if pad != (1 if f == 0 else 0):
            return f
        if util.parity8(data) ^ pad ^ par:
            return f
        if end != 1:
            return f
        out[f] = data
        f += 1


@decoder("proflame2")
def proflame2(bits, dev):
    """SmartFire Proflame 2 remote (ref src/devices/proflame2.c)."""
    for row in range(bits.num_rows):
        b = [0] * 7
        if _proflame2_mc(bits, row, 0, b) != 7:
            continue
        return [Event.make(
            ("model", "Proflame2-Remote"),
            ("id", (b[0] << 16) | (b[1] << 8) | b[2], "Id", "%06x"),
            ("cmd1", b[3], "Cmd1", "%02x"),
            ("cmd2", b[4], "Cmd2", "%02x"),
            ("err1", b[5], "Err1", "%02x"),
            ("err2", b[6], "Err2", "%02x"),
            ("pilot", b[3] >> 7, "Pilot"),
            ("light", (b[3] & 0x70) >> 4, "Light"),
            ("thermostat", (b[3] & 0x02) >> 1, "Thermostat"),
            ("power", b[3] & 0x01, "Power"),
            ("front", b[4] >> 7, "Front"),
            ("fan", (b[4] & 0x70) >> 4, "Fan"),
            ("aux", (b[4] & 0x08) >> 3, "Aux"),
            ("flame", b[4] & 0x07, "Flame"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return 0


def _funkbus_get_bits_reflect(b, start, length):
    result = 0
    for i in range(length):
        if util.bit_at(b, start + i):
            result |= 1 << i
    return result


def _funkbus_checksum(b, length):
    full_bytes = length // 8
    bits_left = length % 8
    xor_byte = util.xor_bytes(bytes(_ints(b)[:full_bytes]))
    mask = (0xFF << (8 - bits_left)) & 0xFF
    xor_byte ^= int(b[full_bytes]) & mask
    xor_nibble = ((xor_byte & 0xF0) >> 4) ^ (xor_byte & 0x0F)
    result = 0
    if xor_nibble & 0x8:
        result ^= 0x8C
    if xor_nibble & 0x4:
        result ^= 0x32
    if xor_nibble & 0x2:
        result ^= 0xC8
    if xor_nibble & 0x1:
        result ^= 0x23
    result &= 0xF
    result |= util.parity8(xor_byte) << 4
    return result


@decoder("funkbus_remote")
def funkbus_remote(bits, dev):
    """Funkbus / Instafunk remote (ref src/devices/funkbus.c)."""
    events = []
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 48:
            return DECODE_ABORT_LENGTH
        b = bits.bb[row]
        typ = _funkbus_get_bits_reflect(b, 0, 4)
        subtyp = _funkbus_get_bits_reflect(b, 4, 4)
        if typ != 0x4 or subtyp != 0x3:
            return DECODE_ABORT_EARLY
        parity = _funkbus_get_bits_reflect(b, 43, 1)
        check = _funkbus_get_bits_reflect(b, 44, 4)
        checksum = _funkbus_checksum(b, 43)
        if (check != util.reflect4(checksum & 0xF)
                or parity != (checksum >> 4)):
            return DECODE_FAIL_MIC
        events.append(Event.make(
            ("model", "Funkbus-Remote"),
            ("id", _funkbus_get_bits_reflect(b, 8, 20), "Serial number"),
            ("battery_ok", 0 if _funkbus_get_bits_reflect(b, 30, 1) else 1,
             "Battery"),
            ("command", _funkbus_get_bits_reflect(b, 33, 3), "Switch"),
            ("group", _funkbus_get_bits_reflect(b, 36, 2), "Group"),
            ("action", _funkbus_get_bits_reflect(b, 39, 2), "Action"),
            ("repeat", _funkbus_get_bits_reflect(b, 41, 1), "Repeat"),
            ("longpress", _funkbus_get_bits_reflect(b, 42, 1), "Longpress"),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return events

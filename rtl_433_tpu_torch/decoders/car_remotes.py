"""Car remote decoders (reference files cited per function):
Astrostart 2000, Compustar 1WG3R, Nidec OUCG8D, Continental KR5V2X,
Honda keyfob, Code Alarm FRDPC2002, 2GIG KEY2E.
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


_ASTROSTART_BUTTONS = [
    ("Lock", [0x2B, 0x03, 0x27, 0x0F, 0x35, 0x37]),
    ("Panic", [0x1F, 0x35, 0x0D, 0x25, 0x15, 0x2D]),
    ("Start", [0x13, 0x37, 0x2D, 0x33, 0x3D, 0x3B]),
    ("Stop", [0x2F, 0x0D, 0x33, 0x03, 0x1D, 0x17]),
    ("Trunk", [0x23, 0x25, 0x3D, 0x1D, 0x27, 0x07]),
    ("Unlock", [0x0B, 0x15, 0x3B, 0x17, 0x07, 0x0F]),
    ("Multiple", [0x3F]),
]


@decoder("astrostart_2000")
def astrostart_2000(bits, dev):
    """Astrostart 2000 car remote (ref src/devices/astrostart_2000.c)."""
    if bits.bits_per_row[0] != 52:
        return DECODE_ABORT_LENGTH
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[0])
    if b[0] != (~b[1] & 0xFF):
        return DECODE_FAIL_MIC
    expected = 0
    for i in range(2, 6):
        expected = (expected + (b[i] >> 4)) & 0xF
        expected = (expected + b[i]) & 0xF
    if (b[6] >> 4) != expected:
        return DECODE_FAIL_MIC
    button = b[0]
    names = [name for name, vals in _ASTROSTART_BUTTONS if button in vals]
    return [Event.make(
        ("model", "Astrostart-2000", "model"),
        ("id", "%08X" % ((b[2] << 24) | (b[3] << 16) | (b[4] << 8) | b[5]),
         "ID"),
        ("button_code", button, "Button Code"),
        ("button_str", "; ".join(names) if names else "?", "Button"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_COMPUSTAR_BUTTONS = [
    ("Lock", [0x03, 0x05, 0x09, 0x0B, 0x0D, 0x0F, 0x1F, 0x17, 0x13, 0x15,
              0x19, 0x1B, 0x1D]),
    ("Panic", [0x18]),
    ("Start", [0x09, 0x0A, 0x0C, 0x0B, 0x0E, 0x0D, 0x04, 0x1F, 0x08, 0x19,
               0x1A, 0x1C, 0x1B, 0x1E, 0x1D, 0x12]),
    ("Trunk", [0x05, 0x06, 0x0C, 0x0E, 0x0D, 0x1F, 0x17, 0x02, 0x15, 0x16,
               0x1C, 0x1E, 0x1D, 0x08, 0x14]),
    ("Unlock", [0x03, 0x06, 0x0A, 0x0B, 0x0E, 0x1F, 0x07, 0x17, 0x13, 0x16,
                0x1A, 0x1B, 0x1E]),
    ("Long Press", [0x23, 0x31, 0x13, 0x16, 0x17, 0x1A, 0x1B, 0x1E, 0x15,
                    0x16, 0x1C, 0x1E, 0x1D, 0x08, 0x14, 0x08, 0x19, 0x1A,
                    0x1C, 0x1B, 0x1E, 0x1D, 0x12, 0x13, 0x15, 0x19, 0x1B,
                    0x1D]),
]


@decoder("compustar_1wg3r")
def compustar_1wg3r(bits, dev):
    """Compustar 1WG3R car remote (ref src/devices/compustar_1wg3r.c)."""
    events = []
    previous_row = -1
    for row in range(bits.num_rows):
        b = _ints(bits.bb[row])
        if bits.bits_per_row[row] == 5 and (b[0] & 0xF8) == 0xF8:
            previous_row = -1
            continue
        if bits.bits_per_row[row] < 35:
            continue
        if (b[2] & 0xE0) != 0xE0 or (b[4] & 1) != 0x0:
            continue
        if ((b[0] == 0xFF and b[1] == 0xFF)
                or (b[0] == 0x00 and b[1] == 0x00)):
            continue
        button_inverse = ((b[2] << 3) & 0xFF) | (b[3] >> 5)
        button = ((b[3] << 3) & 0xFF) | (b[4] >> 5)
        if (~button_inverse & 0xFF) != button:
            continue
        names = [name for name, vals in _COMPUSTAR_BUTTONS
                 if (button & 0x7F) in vals]
        button_str = "; ".join(names) if names else "?"
        if button & 0x80:
            button_str += "; Secondary Mode" if names else "Secondary Mode"
        if previous_row >= 0 and bits.compare_rows(previous_row, row, 35):
            continue
        previous_row = row
        events.append(Event.make(
            ("model", "Compustar-1WG3R", "model"),
            ("id", "%04X" % ((b[0] << 8) | b[1]), "ID"),
            ("button_code", button, "Button Code"),
            ("button_str", button_str, "Button"),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return events


_NIDEC_BUTTONS = {0x3: "Lock", 0x4: "Unlock",
                  0x5: "Trunk/Panic Short Press", 0x6: "Panic Long Press",
                  0xF: "Trunk Long Press"}


@decoder("nidec_car_remote")
def nidec_car_remote(bits, dev):
    """Nidec OUCG8D car remote (ref src/devices/nidec_car_remote.c)."""
    if bits.bits_per_row[0] < 128:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xFF, 0xFF, 0xFF, 0xF0]), 32) + 32
    if bits.bits_per_row[0] - offset < 56:
        return DECODE_ABORT_EARLY
    security_bits = min(bits.bits_per_row[0] - offset - 48, 16)
    bits.invert()
    b = _ints(bits.extract_bytes(0, offset, 64))
    sequence = (b[0] << 8) | b[1]
    rid = (b[2] << 16) | (b[3] << 8) | b[4]
    button = b[5] & 0xF
    security = (b[6] << 8) | b[7]
    if (b[5] & 0xF0) != 0x50:
        return DECODE_FAIL_SANITY
    if (rid == 0 or sequence == 0 or rid == 0xFFFFFF or sequence == 0xFFFF
            or security == 0 or security == 0xFFFF):
        return DECODE_FAIL_SANITY
    if button not in _NIDEC_BUTTONS:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Nidec-OUCG8D", "model"),
        ("id", "%06X" % rid, "ID"),
        ("security", "%04X" % security, ""),
        ("security_bits", security_bits, "Security Bits"),
        ("sequence", sequence, "Sequence"),
        ("button_code", button, "Button Code"),
        ("button_str", _NIDEC_BUTTONS.get(button, "?"), "Button"),
    )]


_CONTINENTAL_BUTTONS = {0x1: "Lock", 0x3: "Unlock", 0x9: "Trunk Long Press",
                        0xA: "Trunk/Panic Short Press",
                        0xB: "Panic Long Press"}


@decoder("continental_car_remote")
def continental_car_remote(bits, dev):
    """Continental KR5V2X car remote
    (ref src/devices/continental_car_remote.c)."""
    if bits.bits_per_row[0] < 132:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xF0, 0xF0, 0x60]), 20) + 20
    if bits.bits_per_row[0] - offset < 112:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, offset, 112))
    rid = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    button = b[5] >> 4
    sequence = (b[6] << 16) | (b[7] << 8) | b[8]
    encrypted = (b[9] << 24) | (b[10] << 16) | (b[11] << 8) | b[12]
    if (rid == 0 or button == 0 or sequence == 0 or rid == 0xFFFFFFF
            or encrypted == 0xFFFFFFF or sequence == 0xFFFFFF):
        return DECODE_FAIL_SANITY
    if util.xor_bytes(bytes(b[:14])):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Continental-KR5V2X", "model"),
        ("id", "%08X" % rid, "ID"),
        ("encrypted", "%08X" % encrypted, ""),
        ("sequence", sequence, "Sequence"),
        ("button_code", button, "Button Code"),
        ("button_str", _CONTINENTAL_BUTTONS.get(button, "?"), "Button"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_HONDA_EVENTS = {0x21: "Lock", 0x22: "Unlock", 0x24: "Trunk",
                 0x27: "Emergency", 0x2D: "RemoteStart"}


@decoder("honda_keyfob")
def honda_keyfob(bits, dev):
    """Honda keyfob KR5V2X/1X (ref src/devices/continental_car_remote.c:174)."""
    if bits.num_rows > 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 150 or bits.bits_per_row[0] > 184:
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, bytes([0xEC, 0x0F, 0x62]), 24)
    if bit_offset + 16 + 120 > bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, bit_offset + 16, 120))
    if util.crc8(bytes(b[:14]), 14, 0x2F, 0x00) != b[14]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Honda-KR5V2X1X", "model"),
        ("id", (b[2] << 24) | (b[3] << 16) | (b[4] << 8) | b[5],
         "Device ID", "%08x"),
        ("event", _HONDA_EVENTS.get(b[6], "?"), "Event"),
        ("counter", (b[7] << 16) | (b[8] << 8) | b[9], "Counter", "%06x"),
        ("code", ((((b[10] << 24) | (b[11] << 16) | (b[12] << 8) | b[13])
                   ^ 0x80000000) - 0x80000000), "Code", "%08x"),
        ("mic", "CRC", "Integrity"),
    )]


_CODEALARM_BUTTONS = [
    ("Multiple", [0x7]),
    ("Lock", [0x6, 0x4]),
    ("Panic", [0x1, 0x3]),
    ("Start", [0x0, 0x3]),
    ("Unlock", [0x5, 0x4]),
]


@decoder("code_alarm_frdpc2000_car_remote")
def code_alarm_frdpc2000(bits, dev):
    """Code Alarm FRDPC2002 car remote
    (ref src/devices/code_alarm_car_remote.c)."""
    if bits.bits_per_row[0] != 60:
        return DECODE_ABORT_LENGTH
    if int(bits.bb[0][0]) != 0x00 or int(bits.bb[0][1]) != 0x00:
        return DECODE_FAIL_SANITY
    b = _ints(bits.extract_bytes(0, 19, 40))
    s = util.add_bytes(bytes(b))
    if s == 0 or s >= 0xFF * 5:
        return DECODE_FAIL_SANITY
    code = _ints(bits.extract_bytes(0, 23, 36))
    rid = (((code[0] ^ code[1]) << 16) | ((code[1] ^ code[2]) << 8)
           | (code[2] ^ code[3]))
    button = b[0] >> 4
    names = [name for name, vals in _CODEALARM_BUTTONS if button in vals]
    return [Event.make(
        ("model", "CodeAlarm-FRDPC2002", "model"),
        ("id", "%06X" % rid, "ID"),
        ("button_code", button, "Button Code"),
        ("button_str", "; ".join(names) if names else "?", "Button"),
        ("data", "%02X%02X%02X%02X%02X" % tuple(b), "Data"),
    )]


@decoder("twogig_key2e")
def twogig_key2e(bits, dev):
    """2GIG-KEY2E-345 encrypted keyfob (ref src/devices/twogig_key2e.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 96:
        return DECODE_ABORT_LENGTH
    raw_pos = bits.search(0, 0, bytes([0x55, 0x55, 0x56]), 24)
    if raw_pos + 24 >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    decoded = BitBuffer()
    bits.manchester_decode(0, raw_pos + 24, decoded, 72)
    if decoded.bits_per_row[0] < 72:
        return DECODE_ABORT_LENGTH
    b = _ints(decoded.bb[0])[:9]
    if b[4] != 0x25:
        return DECODE_ABORT_EARLY
    if util.crc16(bytes(b[:7]), 7, 0x8005, 0x4C57) != ((b[7] << 8) | b[8]):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "TwoGig-KEY2E345"),
        ("encrypted_id", "%02x%02x%02x%02x" % (b[0], b[1], b[2], b[3]),
         "Encrypted ID"),
        ("encrypted_status", "%02x%02x" % (b[5], b[6]), "Encrypted Status"),
        ("mic", "CRC", "Integrity"),
    )]

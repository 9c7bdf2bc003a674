"""TPMS decoders, part 3 (reference files cited per function):
TyreGuard 400, EezTire E618, BMW Gen4/5 + Audi, BMW Gen2/3, GM aftermarket,
Renault 0435R, SmarTire, Mercedes-Benz Sprinter.
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
    DECODE_FAIL_OTHER,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


@decoder("tpms_tyreguard400")
def tpms_tyreguard400(bits, dev):
    """Davies Craig TyreGuard 400 TPMS (ref src/devices/tpms_tyreguard400.c)."""
    sync = bytes([0xFD, 0x5F, 0xD5, 0xF0])
    events = []
    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 88:
            continue
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, sync, 28)
            if bitpos + 88 > bits.bits_per_row[row]:
                break
            b = _ints(bits.extract_bytes(row, bitpos, 88))
            if util.crc8(bytes(b[:11]), 11, 0x31, 0xDD) != 0:
                ret = DECODE_FAIL_MIC
                bitpos += 88
                continue
            flags = b[9]
            tpms_id = (((b[3] & 0xF) << 24) | (b[4] << 16) | (b[5] << 8)
                       | b[6])
            events.append(Event.make(
                ("model", "TyreGuard400", "Model"),
                ("type", "TPMS", "Type"),
                ("id", "%07x" % tpms_id, "ID"),
                ("pressure_kPa", float(b[7] | ((flags & 0x70) << 4)),
                 "Pressure", "%.1f kPa"),
                ("temperature_C", float(b[8] - 40), "Temperature", "%.0f C"),
                ("peering_request", flags & 0x3, "Peering req"),
                ("leaking", flags & 0x3, "Leaking detected"),
                ("ack_leaking", flags & 0x8, "Ack leaking"),
                ("mic", "CRC", "Integrity"),
            ))
            bitpos += 88
    return events if events else ret


@decoder("tpms_eezrv")
def tpms_eezrv(bits, dev):
    """EezTire E618 / Carchet / TST-507 TPMS (ref src/devices/tpms_eezrv.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bits.invert()
    pos = bits.search(0, 0, bytes([0xFF, 0xFF]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if pos + 8 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    cc = int(bits.extract_bytes(0, pos + 16, 8)[0])
    b = _ints(bits.extract_bytes(0, pos + 24, 7 * 8))
    checksum = util.add_bytes(bytes(b), 7)
    if checksum > 0xFF:
        checksum |= 0x80
    if (checksum & 0xFF) != cc:
        return DECODE_FAIL_MIC
    flags1 = b[5]
    flags2 = b[6]
    fast_leak_detected = flags1 & 0x10
    infl_detected = (flags1 & 0x20) >> 5
    return [Event.make(
        ("model", "EezTire-E618"),
        ("type", "TPMS"),
        ("id", "%02x%02x%02x" % (b[0], b[1], b[2])),
        ("battery_ok", int(not (flags1 >> 7)), "Battery_OK"),
        ("pressure_kPa", (((flags2 & 0x01) << 8) + b[3]) * 2.5,
         "Pressure", "%.0f kPa"),
        ("temperature_C", float(b[4] - 50), "Temperature", "%.1f C"),
        ("flags", "%02x%02x" % (flags1, flags2), "Flags"),
        ("fast_leak", int(bool(fast_leak_detected and not infl_detected)),
         "Fast Leak"),
        ("inflate", infl_detected, "Inflate"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tpms_bmw")
def tpms_bmw(bits, dev):
    """BMW Gen4/Gen5 and Audi pressure-alert TPMS (ref
    src/devices/tpms_bmw.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0xAA, 0x59]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    decoded = BitBuffer()
    bits.manchester_decode(0, pos + 16, decoded, 11 * 8)
    len_msg = 11
    if decoded.bits_per_row[0] < 88:
        if decoded.bits_per_row[0] >= 64:
            len_msg = 8
        else:
            return DECODE_ABORT_LENGTH
    decoded.invert()
    b = _ints(decoded.bb[0])
    if util.crc8(bytes(b[:len_msg]), len_msg, 0x2F, 0xAA):
        return DECODE_FAIL_MIC
    if len_msg == 11:
        msg = "".join("%02x" % x for x in b[:11])
    else:
        msg = "".join("%02x" % x for x in b[:8])
    return [Event.make(
        ("model", "BMW-GEN5" if len_msg == 11 else "Audi-PressureAlert"),
        ("type", "TPMS"),
        ("alert", "Alert Pressure increase/decrease !", "Alert")
        if len_msg == 8 else None,
        ("brand", b[0], "Brand"),
        ("id", "%02x%02x%02x%02x" % tuple(b[1:5])),
        ("pressure_kPa", b[5] * 2.45, "Pressure", "%.1f kPa"),
        ("temperature_C", float(b[6] - 52), "Temperature", "%.1f C"),
        ("flags1", b[7]) if len_msg == 11 else None,
        ("flags2", b[8]) if len_msg == 11 else None,
        ("flags3", b[9]) if len_msg == 11 else None,
        ("msg", msg, "msg"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("tpms_bmwg3")
def tpms_bmwg3(bits, dev):
    """BMW Gen2/Gen3 TPMS (ref src/devices/tpms_bmw_g3.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0xCC, 0xCD]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    decoded = BitBuffer()
    bits.differential_manchester_decode(0, pos + 16, decoded, 88)
    msg_len = decoded.bits_per_row[0]
    is_gen2 = 80 <= msg_len < 88
    if msg_len < 80:
        return DECODE_ABORT_LENGTH
    b = _ints(decoded.bb[0])
    if util.crc16(bytes(b[:11 - is_gen2]), 11 - is_gen2, 0x1021, 0x0000):
        return DECODE_FAIL_MIC
    tpms_id = ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]) & 0xFFFFFFFF
    msg = "".join("%02x" % x for x in b[:10 if is_gen2 else 11])
    return [Event.make(
        ("model", "BMW-GEN2" if is_gen2 else "BMW-GEN3"),
        ("type", "TPMS"),
        ("id", ((tpms_id ^ 0x80000000) - 0x80000000), "", "%u"),
        ("uid", "%u" % tpms_id),
        ("pressure_kPa", (b[4] - 43) * 2.5, "Pressure", "%.1f kPa"),
        ("temperature_C", float(b[5] - 40), "Temperature", "%.1f C"),
        ("flags1", b[6], "", "%08b"),
        ("flags2", b[7], "", "%08b"),
        ("flags3", b[8], "", "%08b") if not is_gen2 else None,
        ("msg", msg, "msg"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("tpms_gm")
def tpms_gm(bits, dev):
    """GM aftermarket TPMS (ref src/devices/tpms_gm.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 130:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 0, 130))
    if any(b[i] != 0 for i in range(6)):
        return DECODE_ABORT_EARLY
    checksum = sum(b[6:15]) & 0xFF
    if checksum != b[15]:
        return DECODE_FAIL_MIC
    if all(x == 0 for x in b[6:15]) and b[15] == 0:
        return DECODE_FAIL_SANITY
    # the reference passes the 40-bit id through DATA_INT (C int varargs),
    # truncating to the low 32 bits with sign wrap
    sensor_id = ((b[8] << 32) | (b[9] << 24) | (b[10] << 16) | (b[11] << 8)
                 | b[12])
    sensor_id = ((sensor_id & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    flags = (b[6] << 8) | b[7]
    learn_mode = int(((flags >> 8) & 1) == 0 and ((flags >> 1) & 1) == 0
                     and (flags & 1) == 0)
    return [Event.make(
        ("model", "GM-Aftermarket"),
        ("type", "TPMS"),
        ("id", sensor_id),
        ("flags", flags),
        ("learn_mode", learn_mode),
        ("battery_ok", int(not ((flags >> 5) & 1))),
        ("pressure_kPa", b[13] * 2.75),
        ("temperature_C", float(b[14] - 60), "", "%.0f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tpms_renault_0435r")
def tpms_renault_0435r(bits, dev):
    """Renault 0435R TPMS (ref src/devices/tpms_renault_0435r.c)."""
    def decode_at(row, bitpos):
        packet = BitBuffer()
        bits.manchester_decode(row, bitpos, packet, 160)
        if packet.bits_per_row[0] < 72:
            return DECODE_ABORT_EARLY
        b = _ints(packet.bb[0])
        if util.xor_bytes(bytes(b[:9]), 9) != 0:
            return DECODE_FAIL_MIC
        tick = b[8] & 0x7F
        has_tick = b[8] >> 7
        if b[8] and (not has_tick or tick > 30):
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "Renault-0435R"),
            ("type", "TPMS"),
            ("id", "%02x%02x%02x" % (b[0], b[1], b[2])),
            ("flags", "%02x" % b[3]),
            ("pressure_kPa", b[4] / 0.75, "Pressure", "%.1f kPa"),
            ("temperature_C", float(b[5] - 50), "Temperature", "%.0f C"),
            ("centrifugal_acc", float(b[6] * 5), "Centrifugal Acceleration",
             "%.0f m/s2"),
            ("mic", "CRC"),
            ("has_tick", has_tick),
            ("tick", tick - 0x80 * (1 - has_tick)),
        )]

    bits.invert()
    events = []
    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, bytes([0xAA, 0xA9]), 16)
            if bitpos + 160 > bits.bits_per_row[row]:
                break
            ret = decode_at(row, bitpos + 16)
            if isinstance(ret, list):
                events += ret
            bitpos += 15
    return events if events else ret


@decoder("tpms_smartire")
def tpms_smartire(bits, dev):
    """SmarTire / Aston Martin TPMS (ref src/devices/tpms_smartire.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x32, 0xB4]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    decoded = BitBuffer()
    bits.differential_manchester_decode(0, pos + 16, decoded, 48)
    if decoded.bits_per_row[0] < 47:
        return DECODE_ABORT_LENGTH
    b = _ints(decoded.bb[0])
    if util.crc7(bytes(b[:6]), 6, 0x45, 0x6F):
        return DECODE_FAIL_MIC
    msg_type = (b[1] & 0xC0) >> 6
    value = b[0] - 40
    if msg_type not in (0, 1):
        return DECODE_ABORT_EARLY
    inflate = (b[4] & 0x80) >> 7
    return [Event.make(
        ("model", "SmarTire-AM"),
        ("type", "TPMS"),
        ("id", ((b[1] & 0x3F) << 16) | (b[2] << 8) | b[3]),
        ("pressure_kPa", value * 2.5, "Pressure", "%.1f kPa")
        if msg_type == 0 else None,
        ("temperature_C", float(value), "Temperature", "%.1f C")
        if msg_type == 1 else None,
        ("inflate", 1, "Inflate") if inflate == 1 else None,
        ("flags", b[4] & 0x7F, "Flags", "%07b"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("tpms_mercedes_benz")
def tpms_mercedes_benz(bits, dev):
    """Mercedes-Benz Sprinter TPMS (ref src/devices/tpms_mercedes_benz.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x00, 0x20]), 12)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 80:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos + 12, 80))
    if util.crc8(bytes(b[:10]), 10, 0x2F, 0xAA):
        return DECODE_FAIL_MIC
    if b[0] != 0x83 and b[0] != 0xA3:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "MercedesBenz-Sprinter"),
        ("type", "TPMS"),
        ("id", "%02x%02x%02x%02x" % tuple(b[1:5])),
        ("pressure_PSI", b[5] / 2.75, "Pressure", "%.1f PSI"),
        ("temperature_C", float(b[6] - 51), "Temperature", "%.1f C"),
        ("counter", b[7] & 0x1F, "Counter"),
        ("flags1", b[7] >> 5, "Flags 1", "0b%03b"),
        ("flags2", b[8], "Flags 2"),
        ("mic", "CRC", "Integrity"),
    )]

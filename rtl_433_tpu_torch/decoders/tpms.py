"""TPMS decoders: Citroen, Renault, Ford, Schrader family, Steelmate
(ref src/devices/tpms_citroen.c, tpms_renault.c, tpms_ford.c, schraeder.c,
steelmate.c). Toyota is in protocols.py."""

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


@decoder("tpms_citroen")
def tpms_citroen(bits, dev):
    """Citroen TPMS (ref src/devices/tpms_citroen.c:30-115): inverted,
    Manchester after aaa9, XOR checksum."""
    preamble = bytes([0xAA, 0xA9])
    bits.invert()
    bitpos = 0
    ret = 0
    out = []
    while True:
        bitpos = bits.search(0, bitpos, preamble, 16)
        if bitpos + 178 > bits.bits_per_row[0]:
            break
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos + 16, packet, 88)
        bitpos += 2
        if packet.bits_per_row[0] < 80:
            ret = DECODE_FAIL_SANITY
            continue
        b = _ints(packet.bb[0])
        if b[6] == 0 or b[7] == 0:
            ret = DECODE_ABORT_EARLY
            continue
        crc = b[1] ^ b[2] ^ b[3] ^ b[4] ^ b[5] ^ b[6] ^ b[7] ^ b[8] ^ b[9]
        if crc != 0:
            ret = DECODE_FAIL_MIC
            continue
        id_ = (b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4]
        out.append(Event.make(
            ("model", "Citroen"),
            ("type", "TPMS"),
            ("id", "%08x" % id_),
            ("state", "%02x" % b[0]),
            ("flags", b[5] >> 4),
            ("repeat", b[5] & 0x0F),
            ("pressure_kPa", b[6] * 1.364, "Pressure", "%.0f kPa"),
            ("temperature_C", b[7] - 50.0, "Temperature", "%.0f C"),
            ("maybe_battery", b[8]),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out if out else ret


@decoder("tpms_renault")
def tpms_renault(bits, dev):
    """Renault TPMS (ref src/devices/tpms_renault.c:25-98): inverted,
    Manchester after aaa9, CRC-8 poly 0x07."""
    preamble = bytes([0xAA, 0xA9])
    bits.invert()
    out = []
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, preamble, 16)
            if bitpos + 160 > bits.bits_per_row[row]:
                break
            packet = BitBuffer()
            bits.manchester_decode(row, bitpos + 16, packet, 160)
            bitpos += 15
            if packet.bits_per_row[0] < 72:
                continue
            b = _ints(packet.bb[0])
            if util.crc8(bytes(b[:8]), 8, 0x07, 0x00) != b[8]:
                continue
            id_ = (b[5] << 16) | (b[4] << 8) | b[3]
            pressure_raw = ((b[0] & 0x03) << 8) | b[1]
            out.append(Event.make(
                ("model", "Renault"),
                ("type", "TPMS"),
                ("id", "%06x" % id_),
                ("flags", "%02x" % (b[0] >> 2)),
                ("pressure_kPa", pressure_raw * 0.75, "", "%.1f kPa"),
                ("temperature_C", float(b[2] - 30), "", "%.0f C"),
                ("mic", "CRC", "Integrity"),
            ))
    return out if out else 0


@decoder("tpms_ford")
def tpms_ford(bits, dev):
    """Ford TPMS (ref src/devices/tpms_ford.c:35-160): inverted, Manchester
    after aaa9, 8-bit additive checksum, flag syndrome filter."""
    preamble = bytes([0xAA, 0xA9])
    bits.invert()
    out = []
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, preamble, 16)
            if bitpos + 160 > bits.bits_per_row[row]:
                break
            packet = BitBuffer()
            bits.manchester_decode(row, bitpos + 16, packet, 160)
            bitpos += 15
            if packet.bits_per_row[0] < 64:
                continue
            b = _ints(packet.bb[0])
            if (sum(b[:7]) & 0xFF) != b[7]:
                continue
            id_ = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
            code = (b[4] << 16) | (b[5] << 8) | b[6]
            psibits = ((b[6] & 0x20) << 3) | b[4]
            temperature_valid = (b[5] & 0x80) == 0
            temperature_c = (b[5] & 0x7F) - 56
            learn = moving = unknown = 0
            mode = b[6] & 0x4C
            if mode == 0x8:
                learn = 1
            elif mode == 0x4:
                pass
            elif mode == 0x44:
                moving = 1
            else:
                unknown = mode
            unknown |= b[6] & 0x90
            if unknown != 0:
                continue
            out.append(Event.make(
                ("model", "Ford"),
                ("type", "TPMS"),
                ("id", "%08x" % id_),
                ("pressure_PSI", psibits * 0.25, "Pressure", "%.2f PSI"),
                ("temperature_C", float(temperature_c), "Temperature",
                 "%.1f C") if temperature_valid else None,
                ("moving", moving, "Moving"),
                ("learn", learn, "Learn"),
                ("code", "%06x" % code),
                ("unknown", "%02x" % unknown),
                ("unknown_3", "%01x" % (b[6] & 0x3)),
                ("mic", "CHECKSUM", "Integrity"),
            ))
    return out if out else 0


@decoder("schraeder")
def schraeder(bits, dev):
    """Schrader TPMS (ref src/devices/schraeder.c:45-100): 68-bit row,
    CRC-8 poly 0x07 init 0xf0."""
    if bits.bits_per_row[0] != 68:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 4, 64))
    if b[7] != util.crc8(bytes(b[:7]), 7, 0x07, 0xF0):
        return DECODE_FAIL_MIC
    serial_id = ((b[1] & 0x0F) << 24) | (b[2] << 16) | (b[3] << 8) | b[4]
    flags = ((b[0] & 0x0F) << 4) | (b[1] >> 4)
    return [Event.make(
        ("model", "Schrader"),
        ("type", "TPMS"),
        ("flags", "%02x" % flags),
        ("id", "%07X" % serial_id, "ID"),
        ("pressure_kPa", b[5] * 25 * 0.1, "Pressure", "%.1f kPa"),
        ("temperature_C", float(b[6] - 50), "Temperature", "%.0f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("schrader_EG53MA4")
def schrader_eg53ma4(bits, dev):
    """Schrader-EG53MA4 (ref src/devices/schraeder.c:120-170): 120-bit
    row, additive checksum."""
    if bits.bits_per_row[0] != 120:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 40, 80))
    if not b[1] and not b[2] and not b[4] and not b[5] and not b[7] \
            and not b[8]:
        return DECODE_FAIL_SANITY
    if (sum(b[:9]) & 0xFF) != b[9]:
        return DECODE_FAIL_MIC
    serial_id = (b[4] << 16) | (b[5] << 8) | b[6]
    flags = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    return [Event.make(
        ("model", "Schrader-EG53MA4"),
        ("type", "TPMS"),
        ("flags", "%08x" % flags),
        ("id", "%06X" % serial_id, "ID"),
        ("pressure_kPa", b[7] * 25 * 0.1, "Pressure", "%.1f kPa"),
        ("temperature_F", float(b[8]), "Temperature", "%.1f F"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("schrader_SMD3MA4")
def schrader_smd3ma4(bits, dev):
    """Schrader-SMD3MA4 (ref src/devices/schraeder.c:246-333): Manchester
    after a 0xF5555555E preamble, 2-bit additive checksum."""
    n = bits.bits_per_row[0]
    if n < 36 // 2 + 2 * 38 or n >= 36 + 2 * 38 + 8:
        return DECODE_ABORT_LENGTH
    bitpos = bits.search(0, 0, bytes([0x55, 0x5E]), 16) + 14
    if bitpos + 38 * 2 > n:
        return DECODE_ABORT_EARLY
    decoded = BitBuffer()
    ret = bits.manchester_decode(0, bitpos, decoded, 38)
    if ret != bitpos + 38 * 2:
        return DECODE_FAIL_MIC
    decoded.invert()
    b = _ints(decoded.bb[0])
    if not b[0] and not b[1] and not b[2] and not b[3]:
        return DECODE_FAIL_SANITY
    s = 0
    for i in range(5):
        s += (b[i] & 0x3) + ((b[i] >> 2) & 0x3) + ((b[i] >> 4) & 0x3) \
            + ((b[i] >> 6) & 0x3)
    if (s & 0x3) != 1:
        return DECODE_FAIL_MIC
    flags = (b[0] & 0x70) >> 4
    serial_id = ((b[0] & 0x0F) << 20) | (b[1] << 12) | (b[2] << 4) | (b[3] >> 4)
    pressure = ((b[3] & 0x0F) << 4) | (b[4] >> 4)
    return [Event.make(
        ("model", "Schrader-SMD3MA4"),
        ("type", "TPMS"),
        ("id", "%06X" % serial_id, "ID"),
        ("flags", flags, "Flags"),
        ("learn", 1, "Learn") if flags == 0x0 else None,
        ("alarm", 1, "Alarm") if flags == 0x3 else None,
        ("wakeup", 1, "Wakeup") if flags == 0x5 else None,
        ("pressure_PSI", pressure * 0.2, "Pressure", "%.1f PSI"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("steelmate")
def steelmate(bits, dev):
    """Steelmate TPMS (ref src/devices/steelmate.c:30-85): inverted,
    reflected bytes, additive checksum."""
    preamble = bytes([0x00, 0x00, 0x7F])
    for row in range(bits.num_rows):
        row_len = bits.bits_per_row[row]
        if row_len not in (72, 73, 208, 209):
            continue
        bitpos = bits.search(row, 0, preamble, 24)
        if bitpos > row_len - 72:
            continue
        bits.invert()
        b = [util.reverse8(x) for x in _ints(bits.extract_bytes(row, bitpos, 72))]
        if (sum(b[2:8]) & 0xFF) != b[8]:
            continue
        b1 = b[7]
        sensor_id = (b[3] << 8) | b[4]
        return [Event.make(
            ("type", "TPMS"),
            ("model", "Steelmate"),
            ("id", "0x%04x" % sensor_id),
            ("pressure_kPa", b[5] * 3.125, "", "%.0f kPa"),
            ("temperature_C", b[6] - 50, "", "%d C"),
            ("battery_mV", 3900 - b1 * 10, "") if b1 < 0xFE else None,
            ("alarm", "fast leak", "") if b1 == 0xFF else None,
            ("alarm", "slow leak", "") if b1 == 0xFE else None,
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return DECODE_FAIL_SANITY

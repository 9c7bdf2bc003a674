"""TPMS decoders, part 2 (reference files cited per function):
Toyota PMV-107J, Jansite, Elantra 2012, Abarth 124 / Q85, Hyundai VDO,
truck SolarTPMS, Kia, AVE.
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


@decoder("tpms_pmv107j")
def tpms_pmv107j(bits, dev):
    """Toyota PMV-107J TPMS (ref src/devices/tpms_pmv107j.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        start_pos = bits.differential_manchester_decode(0, bitpos, packet, 70)
        if start_pos - bitpos < 67 * 2:
            return 0
        b = [int(packet.bb[0][0]) >> 6] + _ints(packet.extract_bytes(0, 2, 64))
        if util.crc8(bytes(b[:8]), 8, 0x13, 0x00) != b[8]:
            return 0
        if b[5] != (b[6] ^ 0xFF):
            return 0
        tpms_id = ((b[0] << 26) | (b[1] << 18) | (b[2] << 10) | (b[3] << 2)
                   | (b[4] >> 6)) & 0xFFFFFFFF
        return [Event.make(
            ("model", "PMV-107J"),
            ("type", "TPMS"),
            ("id", "%08x" % tpms_id),
            ("status", b[4] & 0x3F),
            ("battery_ok", int(not ((b[4] & 0x20) >> 5))),
            ("counter", (b[4] & 0x18) >> 3),
            ("rapid_change", (b[4] & 0x2) >> 1),
            ("failed", "FAIL" if b[4] & 0x01 else "OK"),
            ("pressure_kPa", (b[5] - 40.0) * 2.48),
            ("temperature_C", b[7] - 40.0, "", "%.1f C"),
            ("mic", "CRC", "Integrity"),
        )]

    events = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xF8]), 6)
        if bitpos + 67 * 2 > bits.bits_per_row[0]:
            break
        ret = decode_at(bitpos + 6)
        if ret:
            events += ret
        bitpos += 2
    return events


@decoder("tpms_jansite")
def tpms_jansite(bits, dev):
    """Jansite TY02S solar TPMS (ref src/devices/tpms_jansite.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos, packet, 56)
        if packet.bits_per_row[0] < 56:
            return DECODE_FAIL_SANITY
        b = _ints(packet.bb[0])
        tpms_id = (b[0] << 20) | (b[1] << 12) | (b[2] << 4) | (b[3] >> 4)
        return [Event.make(
            ("model", "Jansite"),
            ("type", "TPMS"),
            ("id", "%07x" % tpms_id),
            ("flags", b[3] & 0x0F),
            ("pressure_kPa", b[4] * 1.7, "Pressure", "%.0f kPa"),
            ("temperature_C", b[5] - 50.0, "Temperature", "%.0f C"),
            ("code", "%02x%02x%02x%02x%02x%02x%02x" % tuple(b[:7])),
        )]

    bits.invert()
    events = []
    ret = DECODE_FAIL_OTHER
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xAA, 0xAA, 0xA9]), 24)
        if bitpos + 80 > bits.bits_per_row[0]:
            break
        ret = decode_at(bitpos + 24)
        if isinstance(ret, list):
            events += ret
        bitpos += 2
    return events if events else ret


@decoder("tpms_elantra2012")
def tpms_elantra2012(bits, dev):
    """Hyundai Elantra 2012 / TRW GQ4-44T TPMS (ref
    src/devices/tpms_elantra2012.c)."""
    def decode_at(row, bitpos):
        packet = BitBuffer()
        bits.manchester_decode(row, bitpos, packet, 64)
        if packet.bits_per_row[0] < 64:
            return DECODE_ABORT_LENGTH
        b = _ints(packet.bb[0])
        if util.crc8(bytes(b[:8]), 8, 0x07, 0x00):
            return DECODE_FAIL_MIC
        tpms_id = ((b[2] << 24) | (b[3] << 16) | (b[4] << 8) | b[5]) & 0xFFFFFFFF
        return [Event.make(
            ("model", "Elantra2012"),
            ("type", "TPMS"),
            ("id", "%08x" % tpms_id),
            ("pressure_kPa", float(b[0] + 60), "Pressure", "%.1f kPa"),
            ("temperature_C", float(b[1] - 50), "Temperature", "%.0f C"),
            ("battery_ok", int(not ((b[6] & 0x02) >> 1)), "Battery"),
            ("triggered", b[6] & 0x01, "LF Triggered"),
            ("storage", (b[6] & 0x04) >> 2, "Storage mode"),
            ("flags", "%x" % b[6], "All Flags"),
            ("mic", "CRC", "Integrity"),
        )]

    events = []
    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, bytes([0x71, 0x55]), 16)
            if bitpos + 128 > bits.bits_per_row[row]:
                break
            ret = decode_at(row, bitpos + 16)
            if isinstance(ret, list):
                events += ret
            bitpos += 15
    return events if events else ret


@decoder("tpms_abarth124")
def tpms_abarth124(bits, dev):
    """Abarth 124 Spider (VDO TG1C) / Shenzhen EGQ Q85 TPMS (ref
    src/devices/tpms_abarth124.c)."""
    def decode_at(bitpos, q85):
        data_len = 96 if q85 else 72
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos, packet, data_len)
        if packet.bits_per_row[0] < data_len:
            return 0
        b = _ints(packet.bb[0])
        if util.xor_bytes(bytes(b[:9]), 9) != 0:
            return 0
        temp_c = b[6] - (55.0 if q85 else 50.0)
        if q85 and not (-20.0 <= temp_c <= 80.0):
            return 0
        if not q85 and not (-50.0 <= temp_c <= 125.0):
            return 0
        if q85:
            crc_le = (b[11] << 8) | b[10]
            if util.crc16(bytes(b[:10]), 10, 0x1021, 0xFFFF) != crc_le:
                return 0
        return [Event.make(
            ("model", "Shenzhen-EGQQ85" if q85 else "Abarth-124Spider"),
            ("type", "TPMS"),
            ("id", "%02x%02x%02x%02x" % tuple(b[:4])),
            ("flags", "%02x" % b[4]),
            ("pressure_kPa", b[5] * (3.0 if q85 else 1.38),
             "Pressure", "%.0f kPa"),
            ("temperature_C", temp_c, "Temperature", "%.0f C"),
            ("status", b[7]),
            ("mic", "CRC" if q85 else "CHECKSUM", "Integrity"),
        )]

    bits.invert()
    nbits = bits.bits_per_row[0]
    if 150 < nbits < 210:
        q85 = False
    elif 210 < nbits < 400:
        q85 = True
    else:
        return DECODE_ABORT_LENGTH
    events = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xAA, 0xAA, 0xA9]), 24)
        if bitpos + 80 > nbits:
            break
        ret = decode_at(bitpos + 24, q85)
        if ret:
            events += ret
        bitpos += 2
    return events


@decoder("tpms_hyundai_vdo")
def tpms_hyundai_vdo(bits, dev):
    """Hyundai VDO TG1C TPMS (ref src/devices/tpms_hyundai_vdo.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos, packet, 80)
        if packet.bits_per_row[0] < 80:
            return DECODE_FAIL_SANITY
        b = _ints(packet.bb[0])
        if util.crc8(bytes(b[:9]), 9, 0x07, 0xAA) != b[9]:
            return 0
        tpms_id = ((b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4]) & 0xFFFFFFFF
        return [Event.make(
            ("model", "Hyundai-VDO"),
            ("type", "TPMS"),
            ("id", "%08x" % tpms_id),
            ("state", b[0]),
            ("flags", b[5] >> 4),
            ("repeat", b[5] & 0x0F, "repetition"),
            ("pressure_kPa", b[6] * 1.375, "pressure", "%.0f kPa"),
            ("temperature_C", b[7] - 50.0, "temp", "%.0f C"),
            ("maybe_battery", b[8]),
            ("mic", "CRC", "Integrity"),
        )]

    bits.invert()
    events = []
    ret = DECODE_FAIL_OTHER
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xAA, 0xAA, 0xAA, 0xA9]), 32)
        if bitpos + 80 > bits.bits_per_row[0]:
            break
        ret = decode_at(bitpos + 32)
        if isinstance(ret, list):
            events += ret
        bitpos += 2
    return events if events else (ret if isinstance(ret, int) else 0)


@decoder("tpms_truck")
def tpms_truck(bits, dev):
    """Unbranded truck SolarTPMS (ref src/devices/tpms_truck.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos, packet, 76)
        if packet.bits_per_row[0] < 76:
            return 0
        b = _ints(packet.extract_bytes(0, 4, 72))
        if not b[0] and not b[1] and not b[2] and not b[3]:
            return 0
        if util.xor_bytes(bytes(b[:9]), 9) != 0:
            return 0
        tpms_id = ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]) & 0xFFFFFFFF
        flags = b[5] >> 4
        pressure_alert = (flags & 0x4) == 0x4
        return [Event.make(
            ("model", "Truck"),
            ("type", "TPMS"),
            ("id", "%08x" % tpms_id),
            ("wheel", b[4]),
            ("pressure_kPa", float(((b[5] & 0x0F) << 8) | b[6]),
             "Pressure", "%.0f kPa"),
            ("temperature_C", float(b[7]), "Temperature", "%.0f C"),
            ("pressure_alert", int(pressure_alert), "Pressure Alert")
            if pressure_alert else None,
            ("battery_ok", int((flags & 0x3) == 0x3), "Battery Ok"),
            ("flags", flags, "Flag?", "%x"),
            ("mic", "CHECKSUM", "Integrity"),
        )]

    bits.invert()
    events = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xAA, 0xAA, 0xA9]), 24)
        if bitpos + 160 > bits.bits_per_row[0]:
            break
        ret = decode_at(bitpos + 24)
        if ret:
            events += ret
        bitpos += 2
    return events


@decoder("tpms_kia")
def tpms_kia(bits, dev):
    """Kia Rio III (UB) TPMS (ref src/devices/tpms_kia.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        start_pos = bits.manchester_decode(0, bitpos, packet, 154 - 16)
        if start_pos - bitpos < 154 - 16:
            return DECODE_ABORT_LENGTH
        b = _ints(packet.bb[0])
        crc = b[8] & ~0x7
        if crc != util.crc8(bytes(b[:8]), 8, 0x07, 0x76):
            return DECODE_FAIL_MIC
        pressure = ((b[0] << 4) | (b[1] >> 4)) & 0xFF
        temperature = ((b[1] << 4) | (b[2] >> 4)) & 0xFF
        tpms_id = ((b[2] << 28) | (b[3] << 20) | (b[4] << 12) | (b[5] << 4)
                   | (b[6] >> 4)) & 0xFFFFFFFF
        return [Event.make(
            ("model", "Kia"),
            ("type", "TPMS"),
            ("id", "%08x" % tpms_id),
            ("unknown1", "%02x" % (b[0] >> 4)),
            ("unknown2", "%03x" % b[7]),  # (uint8 truncation in reference)
            ("pressure_PSI", pressure / 5.0, "pressure", "%.1f PSI"),
            ("temperature_C", temperature - 50.0, "temperature", "%.0f C"),
            ("raw", "%02x%02x%02x%02x%02x%02x%02x%02x%02x" % tuple(b[:9])),
            ("mic", "CRC", "Integrity"),
        )]

    events = []
    ret = DECODE_FAIL_OTHER
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xED, 0x71]), 16)
        if bitpos + 154 > bits.bits_per_row[0]:
            break
        ret = decode_at(bitpos + 16)
        if isinstance(ret, list):
            events += ret
        bitpos += 2
    return events if events else ret


@decoder("tpms_ave")
def tpms_ave(bits, dev):
    """AVE TPMS (ref src/devices/tpms_ave.c)."""
    def decode_at(row, bitpos):
        packet = BitBuffer()
        bits.differential_manchester_decode(0, bitpos, packet, 160)
        # the reference indexes the decoded buffer with the outer row (quirk)
        if row >= packet.num_rows or packet.bits_per_row[row] < 64:
            return DECODE_ABORT_LENGTH
        b = _ints(packet.bb[row])
        if util.crc8(bytes(b[:8]), 8, 0x31, 0xFF) != 0:
            return DECODE_FAIL_MIC
        tpms_id = ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]) & 0xFFFFFFFF
        mode = (b[6] >> 6) & 0x3
        battery_raw = (b[6] >> 3) & 0x7
        battery_pct = 100
        if battery_raw == 6:
            battery_pct = 75
        elif battery_raw == 7:
            battery_pct = 25
        ratio, offset = {0: (2.352, 47.0), 1: (2.352, 0.0),
                         2: (5.491, 18.2), 3: (5.491, 0.0)}[mode]
        return [Event.make(
            ("model", "AVE", "Model"),
            ("type", "TPMS", "Type"),
            ("id", "%08x" % tpms_id, "Id"),
            ("mode", mode, "Mode", "M%d"),
            ("pressure_kPa", (b[4] - offset) * ratio, "Pressure", "%.1f kPa"),
            ("temperature_C", b[5] - 50.0, "Temperature", "%.0f C"),
            ("battery_ok", int(battery_raw != 7), "Battery"),
            ("battery_pct", battery_pct, "Battery level"),
            ("flags", b[6] & 0x7, "Flags", "0x%x"),
            ("mic", "CRC", "Integrity"),
        )]

    events = []
    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(0, bitpos, bytes([0xCC, 0xCC, 0xCC, 0xCD]), 32)
            if bitpos + 132 > bits.bits_per_row[0]:
                break
            ret = decode_at(row, bitpos + 32)
            if isinstance(ret, list):
                events += ret
                bitpos += 132
            bitpos += 31
    return events if events else ret

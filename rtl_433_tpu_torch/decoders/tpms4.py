"""TPMS decoders, part 4 (reference files cited per function):
Airpuxem, TRW OOK/FSK, Gear Hive, Jansite TY468/TY588, iMars T240,
Schrader MRXBC5A4/NIS315G3, Jeep, Honda TRW, Sefis M3.
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


def _s8(v):
    return ((int(v) & 0xFF) ^ 0x80) - 0x80


@decoder("tpms_airpuxem")
def tpms_airpuxem(bits, dev):
    """Airpuxem TYH11_EU6_ZQ TPMS (ref src/devices/tpms_airpuxem.c)."""
    bits.invert()
    ret = 0
    events = []
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, bytes([0xAA, 0xAA, 0xA9]), 24)
            if bitpos + 80 > bits.bits_per_row[row]:
                break
            dec = BitBuffer()
            bits.manchester_decode(row, bitpos + 24, dec, 354)
            bitpos += 2
            if dec.bits_per_row[0] < 84:
                ret = DECODE_FAIL_SANITY
                continue
            b = _ints(dec.bb[0])
            if (b[0] >> 4) != 0x5:
                ret = DECODE_FAIL_SANITY
                continue
            payload = _ints(dec.extract_bytes(0, 4, 64))
            crcs = _ints(dec.extract_bytes(0, 68, 16))
            if crcs[0] != util.crc8(bytes(payload), 8, 0x2F, 0xAA):
                ret = DECODE_FAIL_MIC
                continue
            d = _ints(dec.extract_bytes(0, 4, 80))
            pressure = (d[5] | (((d[4] >> 7) & 1) << 8)
                        | (((d[4] >> 3) & 1) << 9)) - 100
            code = "".join("%02x" % x for x in b[:11])
            events.append(Event.make(
                ("model", "Airpuxem-TYH11EU6ZQ"),
                ("type", "TPMS"),
                ("id", "%08x" % ((d[0] << 24) | (d[1] << 16) | (d[2] << 8)
                                 | d[3])),
                ("position", d[4] & 0x07, ""),
                ("flags", (d[4] >> 4) & 0x07, ""),
                ("pressure_kPa", float(pressure), "Pressure", "%.0f kPa"),
                ("temperature_C", float(_s8(d[6])), "Temperature",
                 "%.0f C"),
                ("battery_V", d[7] * 0.02, "Battery", "%.1f V"),
                ("code", code, ""),
                ("mic", "CRC", "Integrity"),
            ))
    return events if events else ret


def _tpms_trw(bits, pre):
    """TRW TPMS common frame (ref src/devices/tpms_trw.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    msg_len = bits.bits_per_row[0]
    if msg_len > 98:
        return DECODE_ABORT_LENGTH
    pos = bits.search(0, 0, pre, 16)
    if pos >= msg_len:
        return DECODE_ABORT_EARLY
    if pos + 88 > msg_len:
        return DECODE_ABORT_LENGTH
    pos += 16
    if msg_len - pos < 81:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 88))
    if util.crc8(bytes(b[:10]), 10, 0x07, 0x00):
        return DECODE_FAIL_MIC
    flags = (b[5] & 0xF0) >> 4
    motion_flags = b[8]
    oem_model = (b[10] & 0xF0) >> 4
    return [Event.make(
        ("model", "TRW"),
        ("type", "TPMS"),
        ("mode", b[0], "", "%02x"),
        ("id", (b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4], "",
         "%08x"),
        ("flags", flags, "Flags", "%01x"),
        ("alert", "Pressure increase/decrease !", "Alert")
        if flags in (0x6, 0x9) else None,
        ("seq_num", b[5] & 0x0F, "Seq Num"),
        ("pressure_PSI", b[6] * 0.4, "Pressure", "%.1f PSI"),
        ("temperature_C", float(b[7] - 50), "Temperature", "%.0f C"),
        ("motion_flags", motion_flags, "Motion flags", "%02x"),
        ("motion_status", "Parked" if motion_flags == 0x0E else "Moving",
         "Motion"),
        ("oem_model", "OEM", "OEM Model") if oem_model == 0x4 else
        (("oem_model", "Clone", "OEM Model") if oem_model == 0x0 else None),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("tpms_trw_ook")
def tpms_trw_ook(bits, dev):
    """TRW TPMS OOK variant (ref src/devices/tpms_trw.c)."""
    return _tpms_trw(bits, bytes([0x00, 0x01]))


@decoder("tpms_trw_fsk")
def tpms_trw_fsk(bits, dev):
    """TRW TPMS FSK variant (ref src/devices/tpms_trw.c)."""
    return _tpms_trw(bits, bytes([0x7F, 0xFF]))


@decoder("tmps_gear_hive")
def tmps_gear_hive(bits, dev):
    """Gear Hive aftermarket TPMS (ref src/devices/tpms_gear_hive.c)."""
    ret = 0
    events = []
    for row in range(bits.num_rows):
        bitpos = 0
        while True:
            bitpos = bits.search(row, bitpos, bytes([0x25, 0x94]), 16)
            if bitpos + 16 + 72 > bits.bits_per_row[row]:
                break
            raw = _ints(bits.extract_bytes(row, bitpos + 16, 72))
            bitpos += 16
            p = [raw[0] ^ 0x94] + [raw[i] ^ raw[i - 1] for i in range(1, 9)]
            if (p[6] & 0x3C) != 0x20 or (p[7] & 0x3F) != 0x35:
                ret = DECODE_FAIL_SANITY
                continue
            sensor_class = p[1] & 0x0F
            base = (80 + sensor_class * 64) & 0xFF
            temp_bits = (p[7] >> 6) | ((p[6] & 0x03) << 2)
            events.append(Event.make(
                ("model", "Gear-Hive", "Model"),
                ("type", "TPMS", "Type"),
                ("id", "%06x" % ((p[2] << 16) | (p[3] << 8) | p[4]), "ID"),
                ("counter", ((p[1] >> 4) << 8) | p[0], "Counter"),
                ("pressure_kPa", ((p[5] - base + 256) & 0xFF) * 6.25,
                 "Pressure", "%.0f kPa"),
                ("temperature_C", float(temp_bits) + 21.0, "Temperature",
                 "%.0f C"),
                ("mic", "CHECKSUM", "Integrity"),
            ))
    return events if events else ret


def _jansite_sp372_decode(bits):
    """SP372-family frame (ref src/devices/tpms_jansite_ty468.c,
    src/devices/tpms_imars_t240.c): returns decoded 8 bytes or code."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    length = bits.bits_per_row[0]
    pos = bits.search(0, 0, bytes([0xAA, 0xAA, 0xAA]), 24)
    if pos >= length:
        return DECODE_ABORT_EARLY
    if length - pos < 160:
        return DECODE_ABORT_LENGTH
    packet = BitBuffer()
    bits.manchester_decode(0, pos + 32, packet, 64)
    packet.invert()
    if packet.bits_per_row[0] < 64:
        return DECODE_FAIL_SANITY
    b = _ints(packet.bb[0])
    if b[7] != b[0]:
        return DECODE_FAIL_SANITY
    if (b[0] & 0x0F) != (b[1] & 0x0F):
        return DECODE_FAIL_SANITY
    return b


@decoder("tpms_jansite_ty468")
def tpms_jansite_ty468(bits, dev):
    """Jansite TY-468-eu2 / KKMOON TPMS
    (ref src/devices/tpms_jansite_ty468.c)."""
    b = _jansite_sp372_decode(bits)
    if isinstance(b, int):
        return b
    checksum = (b[3] + b[4]) & 0xFF
    if checksum == 0xFB:
        temp_offset, pressure_offset = 224, 273
    elif checksum == 0x64:
        temp_offset, pressure_offset = 153, 201
    else:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Jansite-TY468"),
        ("type", "TPMS"),
        ("temperature_C", float(temp_offset - ((b[2] + b[5]) & 0xFF)),
         "Temperature", "%.0f C"),
        ("pressure_kPa",
         (pressure_offset - ((b[5] + b[6]) & 0xFF)) * 2.5, "Pressure",
         "%.1f kPa"),
        ("code", "".join("%02x" % x for x in b[:7]), ""),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tpms_imars_t240")
def tpms_imars_t240(bits, dev):
    """iMars T240 TPMS (ref src/devices/tpms_imars_t240.c)."""
    b = _jansite_sp372_decode(bits)
    if isinstance(b, int):
        return b
    checksum = (b[3] + b[4]) & 0xFF
    if checksum != 0x41 and checksum != 0x3C:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "iMars-T240"),
        ("type", "TPMS"),
        ("code", "".join("%02x" % x for x in b[:7]), ""),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tpms_jansite_ty588")
def tpms_jansite_ty588(bits, dev):
    """Jansite TY588-EU2 TPMS (ref src/devices/tpms_jansite_ty588.c)."""
    bitpos = 0
    ret = 0
    events = []
    while True:
        bitpos = bits.search(0, bitpos, bytes([0x99, 0xAA, 0x5A]), 24)
        if bitpos + 172 > bits.bits_per_row[0]:
            break
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos + 44, packet, 64)
        bitpos += 2
        if packet.bits_per_row[0] < 64:
            ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(packet.bb[0])
        if b[7] != b[0]:
            ret = DECODE_FAIL_MIC
            continue
        if ((b[3] + b[4]) & 0xFF) != 0x30 or (b[0] & 0x0F) != (b[1] & 0x0F):
            ret = DECODE_FAIL_SANITY
            continue
        temperature = ((b[2] + b[5]) & 0xFF) - 139
        pressure_raw = ((b[5] + b[6]) & 0xFF) - 90
        if pressure_raw < 0 or temperature < -40 or temperature > 120:
            ret = DECODE_FAIL_SANITY
            continue
        events.append(Event.make(
            ("model", "Jansite-TY588"),
            ("type", "TPMS"),
            ("pressure_kPa", pressure_raw * 2.5, "Pressure", "%.1f kPa"),
            ("temperature_C", float(temperature), "Temperature", "%.0f C"),
            ("code", "".join("%02x" % x for x in b[:7]), ""),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return events if events else ret


def _schrader_smd3ma4_family(bits, model, pressure_scale):
    """Schrader SMD3MA4/NIS315G3 frame (ref src/devices/schraeder.c:247)."""
    if bits.bits_per_row[0] < 36 // 2 + 2 * 38 or \
            bits.bits_per_row[0] >= 36 + 2 * 38 + 8:
        return DECODE_ABORT_LENGTH
    bitpos = bits.search(0, 0, bytes([0x55, 0x5E]), 16) + 14
    if bitpos + 38 * 2 > bits.bits_per_row[0]:
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
    serial_id = ((b[0] & 0x0F) << 20) | (b[1] << 12) | (b[2] << 4) \
        | (b[3] >> 4)
    pressure = ((b[3] & 0x0F) << 4) | (b[4] >> 4)
    return [Event.make(
        ("model", model),
        ("type", "TPMS"),
        ("id", "%06X" % serial_id, "ID"),
        ("flags", flags, "Flags"),
        ("learn", 1, "Learn") if flags == 0x0 else None,
        ("alarm", 1, "Alarm") if flags == 0x3 else None,
        ("wakeup", 1, "Wakeup") if flags == 0x5 else None,
        ("pressure_PSI", pressure * pressure_scale, "Pressure",
         "%.1f PSI"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("schrader_NIS315G3")
def schrader_nis315g3(bits, dev):
    """Schrader MRXNIS315G3 TPMS (ref src/devices/schraeder.c:340)."""
    return _schrader_smd3ma4_family(bits, "Schrader-NIS315G3", 0.25)


@decoder("schrader_MRXBC5A4")
def schrader_mrxbc5a4(bits, dev):
    """Schrader MRXBC5A4 (BMW) TPMS (ref src/devices/schraeder.c:388)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 61:
        return DECODE_ABORT_LENGTH
    if bits.search(0, 0, bytes([0x7F, 0xFF]), 16) != 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, 16, 46))
    serial_id = ((b[0] & 0x1F) << 19) | (b[1] << 11) | (b[2] << 3) \
        | (b[3] >> 5)
    if serial_id == 0 or serial_id == 0xFFFFFF:
        return DECODE_FAIL_SANITY
    even_ones = n = 0
    for i in range(3, 38):
        if (b[i // 8] >> (7 - (i % 8))) & 1:
            n += 1
            if (i - 3) % 2 == 0:
                even_ones += 1
    c1c2 = (even_ones + 2 * n - 1) & 0x3
    c1 = (b[4] >> 3) & 1
    c2 = (b[4] >> 2) & 1
    if c1c2 != ((c1 << 1) | c2):
        return DECODE_FAIL_MIC
    flags = (b[0] >> 5) & 0x7
    pressure = ((b[3] & 0x1F) << 4) | (b[4] >> 4)
    temperature = ((b[4] & 0x03) << 5) | (b[5] >> 3)
    if pressure > 450 or temperature - 50 < -40 or temperature - 50 > 85:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Schrader-MRXBC5A4"),
        ("type", "TPMS"),
        ("flags", "%01x" % flags, ""),
        ("id", "%06X" % serial_id, "ID"),
        ("pressure_kPa", pressure * 1.0, "Pressure", "%.1f kPa"),
        ("temperature_C", float(temperature) - 50, "Temperature",
         "%.1f C"),
        ("sleep", "True" if flags == 2 else "False", "Sleep"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("tpms_jeep")
def tpms_jeep(bits, dev):
    """Jeep (Continental) TPMS (ref src/devices/tpms_jeep.c)."""
    bits.invert()
    bitpos = 0
    ret = 0
    events = []
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xAA, 0xA9]), 16)
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
        if (b[1] ^ b[2] ^ b[3] ^ b[4] ^ b[5] ^ b[6] ^ b[7] ^ b[8]
                ^ b[9]) != 0:
            ret = DECODE_FAIL_MIC
            continue
        events.append(Event.make(
            ("model", "Jeep"),
            ("type", "TPMS"),
            ("id", "%08x" % ((b[1] << 24) | (b[2] << 16) | (b[3] << 8)
                             | b[4]), ""),
            ("state", "%02x" % b[0], ""),
            ("flags", b[5] >> 4, ""),
            ("repeat", b[5] & 0x0F, ""),
            ("pressure_kPa", b[6] * 2.728, "Pressure", "%.0f kPa"),
            ("temperature_C", b[7] - 50.0, "Temperature", "%.0f C"),
            ("maybe_battery", b[8], ""),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return events if events else ret


@decoder("tpms_honda")
def tpms_honda(bits, dev):
    """Honda (TRW PPA-GF33) TPMS (ref src/devices/tpms_honda.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.search(0, 0, bytes([0xDA, 0xE3, 0x54]), 23) != 0:
        return DECODE_ABORT_EARLY
    if 23 + 128 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    packet = BitBuffer()
    bits.manchester_decode(0, 23, packet, 64)
    if packet.bits_per_row[0] < 64:
        return DECODE_ABORT_LENGTH
    b = _ints(packet.bb[0])
    if util.crc8(bytes(b[:7]), 7, 0x07, 0x00) != b[7]:
        return DECODE_FAIL_MIC
    if 0 < b[0] < 50:
        return DECODE_ABORT_EARLY
    return [Event.make(
        ("model", "Honda-TRW"),
        ("type", "TPMS"),
        ("id", "%08x" % ((b[2] << 24) | (b[3] << 16) | (b[4] << 8)
                         | b[5]), ""),
        ("pressure_PSI", b[0] * 0.2, "Pressure", "%.1f PSI"),
        ("temperature_C", b[1] - 50, "Temperature", "%d C"),
        ("flags", b[6], "Flags", "%02x"),
        ("mic", "CRC", "Integrity"),
    )]


_SEFIS_PAGE = {7: 0, 4: 1, 5: 2, 2: 3}


@decoder("tpms_sefis_m3")
def tpms_sefis_m3(bits, dev):
    """Sefis M3 / Careud / Sykik SRTP300 TPMS
    (ref src/devices/tpms_sefis_m3.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x66, 0x99, 0x96, 0xA6]), 32)
    if pos == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if pos + 32 + 72 * 2 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    pos += 32
    packet = BitBuffer()
    bits.manchester_decode(0, pos, packet, 72)
    if packet.bits_per_row[0] < 72:
        return DECODE_ABORT_LENGTH
    b = [int(packet.bb[0][i]) ^ 0xFF for i in range(9)]
    if util.crc16(bytes(b[:7]), 7, 0x1021, 0x0000) != ((b[7] << 8) | b[8]):
        return DECODE_FAIL_MIC
    page = _SEFIS_PAGE.get(b[4] >> 5, -1)
    pressure_kpa = 0.0
    if page >= 0:
        code = (page << 13) | ((b[4] & 0x1F) << 8) | b[5]
        pressure_kpa = max((code - 0x0E00) / 102.4, 0.0)
    return [Event.make(
        ("model", "Sefis-M3"),
        ("type", "TPMS"),
        ("pressure_kPa", pressure_kpa, "Pressure", "%.0f kPa")
        if page >= 0 else None,
        ("temperature_C", float(14 + ((b[2] + b[5]) & 0x0F)), "Temperature",
         "%.0f C"),
        ("code", "".join("%02x" % x for x in b[:7]), "Undecoded data"),
        ("mic", "CRC", "Integrity"),
    )]

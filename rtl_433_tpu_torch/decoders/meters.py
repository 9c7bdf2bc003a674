"""Water/pool meter decoders (reference files cited per function):
Badger ORION, Orion Endpoint (2014/2020), SRSmith pool remote,
Neptune R900.
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

_3OF6 = {22: 0x0, 13: 0x1, 14: 0x2, 11: 0x3, 28: 0x4, 25: 0x5, 26: 0x6,
         19: 0x7, 44: 0x8, 37: 0x9, 38: 0xA, 35: 0xB, 52: 0xC, 49: 0xD,
         50: 0xE, 41: 0xF}


def _ints(b):
    return [int(x) for x in b]


def _get_byte(row, pos):
    out = 0
    for i in range(8):
        p = pos + i
        byte = int(row[p >> 3]) if (p >> 3) < len(row) else 0
        out = (out << 1) | ((byte >> (7 - (p & 7))) & 1)
    return out


@decoder("badger_orion")
def badger_orion(bits, dev):
    """Badger ORION water meter (ref src/devices/badger_water.c)."""
    if (bits.bits_per_row[0] < 16 + 120
            or bits.bits_per_row[0] > 128 + 16 + 120 + 96):
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, bytes([0x54, 0x3D]), 16)
    if bit_offset + 120 >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    bit_offset += 16
    row = bits.bb[0]
    data_in = []
    for n in range(10):
        nh = _3OF6.get(_get_byte(row, n * 12 + bit_offset) >> 2, 0xFF)
        nl = _3OF6.get(_get_byte(row, n * 12 + bit_offset + 6) >> 2, 0xFF)
        if (nh | nl) > 15:
            return DECODE_FAIL_MIC
        data_in.append((nh << 4) | nl)
    crc_read = (data_in[8] << 8) | data_in[9]
    crc_calc = ~util.crc16(bytes(data_in[:8]), 8, 0x3D65, 0) & 0xFFFF
    if crc_calc != crc_read:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Badger-ORION"),
        ("id", data_in[0] | (data_in[1] << 8) | (data_in[2] << 16), "ID"),
        ("flags_1", data_in[3], "Flags-1"),
        ("volume_gal", data_in[4] | (data_in[5] << 8)
         | (data_in[6] << 16), "Volume"),
        ("flags_2", data_in[7], "Flags-2"),
        ("mic", "CRC", "Integrity"),
    )]


_ORION_WHITEN = [0xFF, 0xE1, 0x1D, 0x9A, 0xED, 0x85, 0x33, 0x24, 0xEA,
                 0x7A, 0xD2, 0x39, 0x70, 0x97, 0x57, 0x0A, 0x54, 0x7D,
                 0x2D, 0xD8, 0x6D, 0x0D, 0xBA]


def _orion_endpoint_decode(bits, dev):
    """Orion Endpoint decode (ref src/devices/badger_orion_endpoint.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len < 232 or msg_len > 290:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0,
                         bytes([0xAA, 0xAA, 0xEC, 0x62, 0xEC, 0x62]), 48)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    offset += 48
    if msg_len - offset < 184:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 184))
    b = [b[i] ^ _ORION_WHITEN[i] for i in range(23)]
    if util.crc16(bytes(b), 23, 0x8005, 0xFFFF):
        return DECODE_FAIL_MIC
    oid = (b[8] << 24) | (b[7] << 16) | (b[6] << 8) | b[5]
    daily_raw = (b[19] << 24) | (b[18] << 16) | (b[17] << 8) | b[16]
    model_ranges = [
        (30000000, 59999999, "ME or SE"), (60000000, 69999999, "Mobile M"),
        (70000000, 89999999, "Classic (CE)"),
        (110000000, 119999999, "LTE"),
        (120000000, 129999999, "LTE-M or LTE-MS"),
        (130000000, 139999999, "C or CS"), (140000000, 148999999, "HLA"),
        (149000000, 149999999, "HLC"), (150000000, 159999999, "HLB"),
        (160000000, 169999999, "HLD"), (170000000, 179999999, "HLFX"),
        (180000000, 189999999, "HLG"),
    ]
    endpoint_model = "Unknown Model"
    for lo, hi, name in model_ranges:
        if lo <= oid <= hi:
            endpoint_model = name
            break
    reading = (b[15] << 24) | (b[14] << 16) | (b[13] << 8) | b[12]
    return [Event.make(
        ("model", "Orion-Endpoint"),
        ("id", (oid ^ 0x80000000) - 0x80000000, ""),
        ("endpoint_model", endpoint_model, "Endpoint Model"),
        ("leaking", (b[10] & 0x20) >> 5, "Leaking"),
        ("reading", (reading ^ 0x80000000) - 0x80000000, "Reading"),
        ("daily_reading", (daily_raw ^ 0x80000000) - 0x80000000,
         "Daily Reading") if daily_raw else None,
        ("flags_1", (b[9] << 16) | (b[10] << 8) | b[11], "Flags-1",
         "%06x"),
        ("flags_2", b[20], "Flags-2", "%02x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("orion_endpoint")
def orion_endpoint(bits, dev):
    """Orion Endpoint GIF2014W-OSE
    (ref src/devices/badger_orion_endpoint.c)."""
    return _orion_endpoint_decode(bits, dev)


@decoder("orion_endpoint_2020")
def orion_endpoint_2020(bits, dev):
    """Orion Endpoint GIF2020OCECNA
    (ref src/devices/badger_orion_endpoint.c)."""
    return _orion_endpoint_decode(bits, dev)


_SRSMITH_BUTTONS = {0x0D: "On/Off Channel 1", 0x1F: "On/Off Channel 2",
                    0x07: "Color Sync", 0x0B: "ON/OFF Control - M"}


@decoder("srsmith_pool_srs_2c_tx")
def srsmith_pool_srs_2c_tx(bits, dev):
    """SRSmith SRS-2C-TX pool light remote
    (ref src/devices/srsmith_pool_srs_2c_tx.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 120 or bits.bits_per_row[0] > 144:
        return DECODE_ABORT_LENGTH
    start = bits.search(0, 0, bytes([0xAA, 0xD3, 0x91, 0xD3, 0x91]),
                        40) + 40
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, start, 10 * 8))
    reversed_pin = util.reverse8((~b[5]) & 0xFF)
    if ((b[8] << 8) | b[9]) != util.crc16(bytes(b[:8]), 8, 0x8005, 0xFFFF):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "SRSmith-SRS2CTX"),
        ("id", reversed_pin, "Id"),
        ("button_press", b[6], "Pushed Button ID", "%02x"),
        ("button_press_name", _SRSMITH_BUTTONS.get(b[6], "Unknown"),
         "Pushed Button String"),
        ("unknown", (((b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4])
                     ^ 0x80000000) - 0x80000000, "Unknown", "%08x"),
        ("mic", "CRC", "Integrity"),
    )]


_R900_MAP16TO6 = [-1, -1, -1, 0, -1, 1, 2, -1, -1, 5, 4, -1, 3, -1, -1,
                  -1]


@decoder("neptune_r900")
def neptune_r900(bits, dev):
    """Neptune R900 flow meter (ref src/devices/neptune_r900.c)."""
    pre = bytes([0x55, 0x55, 0x55, 0xA9, 0x66, 0x69, 0x65])
    if bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    start = bits.search(0, 0, pre, 56)
    if start + 56 + 168 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    row = bits.bb[0]
    base6 = []
    for k in range(start + 56, start + 56 + 168, 8):
        byte = _get_byte(row, k)
        hi = _R900_MAP16TO6[(byte >> 4) & 0xF]
        lo = _R900_MAP16TO6[byte & 0xF]
        if hi < 0 or lo < 0:
            return DECODE_ABORT_EARLY
        base6.append(6 * hi + lo)
    outbits = []
    for d in base6:
        for s in range(4, -1, -1):
            outbits.append((d >> s) & 1)
    b = [0] * 14
    for i, bit in enumerate(outbits[:105]):
        if bit:
            b[i >> 3] |= 0x80 >> (i & 7)
    meter_id = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    consumption = ((b[9] >> 5) << 24) | (b[6] << 16) | (b[7] << 8) | b[8]
    return [Event.make(
        ("model", "Neptune-R900"),
        ("id", (meter_id ^ 0x80000000) - 0x80000000, ""),
        ("unkn1", b[4] >> 4, ""),
        ("metertype", b[4] & 0x0F, ""),
        ("unkn2", b[5] >> 5, ""),
        ("nouse", ((b[5] >> 1) & 0x0F) >> 1, ""),
        ("backflow", b[5] & 0x03, ""),
        ("consumption", consumption, ""),
        ("leak", ((b[9] >> 1) & 0x0F) >> 1, ""),
        ("leaknow", b[9] & 0x03, ""),
        ("extra", "%02x%02x%02x" % (b[10], b[11], b[12]), ""),
    )]

"""Misc decoders batch G (reference files cited per function):
Watts WFHT-LCD-RF, Eberle Instat 868r1, Hanwell ML4000,
Cotech FT0203 anemometer, Cotech 36-7900 rain gauge.
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("watts_wfht_rf")
def watts_wfht_rf(bits, dev):
    """Watts WFHT-LCD-RF underfloor thermostat
    (ref src/devices/watts_wfht_rf.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 32 + 128:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xD3, 0x91, 0xD3, 0x91]), 32) + 32
    if offset + 128 > bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, offset, 128))
    if b[0] != 0x0D:
        return DECODE_ABORT_EARLY
    if b[1] != 0xFF or b[2] != 0xFF or b[3] != 0xFE:
        return DECODE_ABORT_EARLY
    if b[4] & 0xFC:
        return DECODE_FAIL_SANITY
    if not b[5] and not b[6] and not b[7]:
        return DECODE_FAIL_SANITY
    crc8_calc = util.crc8(bytes(b[:12]), 12, 0xE6, 0x00) ^ 0xBE ^ b[12]
    if crc8_calc != b[13]:
        return DECODE_FAIL_MIC
    if util.crc16(bytes(b[:14]), 14, 0x8005, 0xFFFF) != (
            (b[14] << 8) | b[15]):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Watts-WFHTLCDRF"),
        ("id", "%02X:%02X:%02X" % (b[5], b[6], b[7]), "ID"),
        ("mode", "heat" if (b[4] & 0x02) else "cool", "Mode"),
        ("pairing", "true" if (b[4] & 0x01) else "false", "Pairing"),
        ("temperature_C", _s16((b[8] << 8) | b[9]) / 10.0, "Temperature",
         "%.1f C"),
        ("setpoint_C", _s16((b[10] << 8) | b[11]) / 10.0, "Setpoint",
         "%.1f C"),
        ("call_for_heat", 100 if b[12] == 0x64 else 0, "Call for heat",
         "%d %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("eberle_instat868r1")
def eberle_instat868r1(bits, dev):
    """Eberle Instat 868r1 thermostat remote
    (ref src/devices/eberle_instat868r1.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 80:
        return DECODE_ABORT_LENGTH
    row_len = bits.bits_per_row[0]
    search_start = 0
    decoded = None
    while search_start + 80 <= row_len:
        pos = bits.search(0, search_start,
                          bytes([0x00, 0x0F, 0xE0, 0x30]), 30)
        if pos + 80 > row_len:
            break
        dec = BitBuffer()
        bits.differential_manchester_decode(0, pos + 30, dec, 25)
        if dec.bits_per_row[0] < 25:
            search_start = pos + 31
            continue
        b = dec.bb[0]
        checksum = 0
        for n in range(6):
            val = 0
            for i in range(4):
                if util.bit_at(b, 1 + n * 4 + i):
                    val |= 1 << i
            checksum += val
        if (checksum & 0xF) != 0xB:
            search_start = pos + 31
            continue
        decoded = dec
        break
    if decoded is None:
        return DECODE_FAIL_MIC
    b = decoded.bb[0]
    gray_bits = [0] * 24
    prev = util.bit_at(b, 1)
    gray_bits[0] = int(not prev)
    for i in range(1, 24):
        prev ^= util.bit_at(b, 1 + i)
        gray_bits[i] = int(not prev)
    nibble = []
    for n in range(6):
        val = 0
        for i in range(4):
            val = (val << 1) | gray_bits[n * 4 + i]
        nibble.append(val)
    eid = (nibble[0] << 8) | (nibble[1] << 4) | nibble[2]
    action = nibble[3]
    id_odd = eid & 1
    if action == (0x3 if id_odd else 0xC):
        command = "Learn"
    elif action == (0xB if id_odd else 0x4):
        command = "Reset"
    elif action == (0xE if id_odd else 0x1):
        command = "On"
    elif action == (0x5 if id_odd else 0xA):
        command = "Off"
    else:
        command = "Unknown"
    return [Event.make(
        ("model", "Eberle-Instat868r1"),
        ("id", eid, "", "%03x"),
        ("command", command, "Command"),
        ("action_code", action, "Action Code", "%01x"),
        ("data", nibble[4], "Data", "%01x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("hanwell_ml4000")
def hanwell_ml4000(bits, dev):
    """Hanwell ML/RL4000 Radiologger (ref src/devices/hanwell_ml4000.c)."""
    bits.invert()
    if bits.num_rows < 1:
        return DECODE_ABORT_EARLY
    row = bits.num_rows - 1
    if bits.bits_per_row[row] != 40:
        return DECODE_ABORT_LENGTH
    b = [util.reverse8(x) for x in _ints(bits.extract_bytes(row, 0, 40))]
    if ((b[0] + b[1] + b[2] + b[3]) & 0xFF) != b[4]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Hanwell-ML4000"),
        ("id", b[0], ""),
        ("temperature_raw", (b[2] << 4) | (b[3] & 0x0F),
         "Temperature Raw"),
        ("humidity_raw", (b[1] << 4) | (b[3] >> 4), "Humidity Raw"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("cotech_ft0203")
def cotech_ft0203(bits, dev):
    """Cotech FT0203 anemometer (ref src/devices/cotech_ft0203.c)."""
    for row in range(bits.num_rows):
        row_bits = bits.bits_per_row[row]
        for pos in range(max(row_bits - 9 * 8 + 1, 0)):
            b = _ints(bits.extract_bytes(row, pos, 9 * 8))
            if b[0] != 0x14 or b[6] != 0xFF or b[7] != 0xFF:
                continue
            if util.crc8(bytes(b), 9, 0x31, 0xC0) != 0:
                continue
            return [Event.make(
                ("model", "Cotech-FT0203"),
                ("id", (b[1] << 3) | (b[2] >> 5), "ID"),
                ("battery_ok", (b[2] >> 4) & 0x1, "Battery"),
                ("wind_dir_deg", (((b[2] >> 2) & 0x1) << 8) | b[5],
                 "Wind direction"),
                ("wind_avg_m_s", (((b[2] & 0x1) << 8) | b[3]) * 0.1,
                 "Wind", "%.1f m/s"),
                ("wind_max_m_s", ((((b[2] >> 1) & 0x1) << 8) | b[4]) * 0.1,
                 "Gust", "%.1f m/s"),
                ("mic", "CRC", "Integrity"),
            )]
    return DECODE_FAIL_SANITY


@decoder("cotech_36_7900")
def cotech_36_7900(bits, dev):
    """Cotech 36-7900 rain gauge (ref src/devices/cotech_36_7900.c)."""
    row = bits.find_repeated_row(8, 60)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 60:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(row, 0, 60))
    if b[0] != 0xAB or (b[1] >> 4) != 0x8:
        return DECODE_ABORT_EARLY
    if b[3] != 0x00 or b[4] != 0x00 or b[5] != 0x00:
        return DECODE_FAIL_MIC
    temp_raw = ((b[1] & 0x0F) << 8) | b[2]
    if temp_raw & 0x800:
        temp_raw -= 0x1000
    return [Event.make(
        ("model", "Cotech-367900"),
        ("id", (b[0] << 8) | b[1], "ID", "%04x"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
        ("rain_raw", (b[6] << 4) | (b[7] >> 4), "Rain"),
    )]

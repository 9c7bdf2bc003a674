"""Fine Offset family, part 3 (reference files cited per function):
WH46 air quality, WH43 air quality, WS85 weather station, WH52 soil
probe, Rosenborg 66796 (WH5 variant).
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


def _ints(b):
    return [int(x) for x in b]


@decoder("fineoffset_wh46")
def fineoffset_wh46(bits, dev):
    """Fine Offset WH46 air quality (ref src/devices/fineoffset_wh46.c)."""
    offset = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if offset + 21 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 21 * 8))
    if b[0] != 0x46:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:19]), 19, 0x31, 0x00) != b[19]
            or (util.add_bytes(bytes(b[:20])) & 0xFF) != b[20]):
        return DECODE_FAIL_MIC
    battery_bars = ((b[7] & 0x40) >> 4) | ((b[9] & 0xC0) >> 6)
    batt_lvl = min(battery_bars * 0.2, 1.0)
    return [Event.make(
        ("model", "Fineoffset-WH46"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", int(battery_bars > 1), "Battery"),
        ("battery_pct", 100 * batt_lvl, "Battery level"),
        ("temperature_C", ((((b[4] & 0x7) << 8) | b[5]) - 400) * 0.1,
         "Temperature", "%.1f C"),
        ("humidity", b[6], "Humidity", "%u %%"),
        ("pm1_ug_m3", ((b[13] << 8) | b[14]) * 0.1, "1um Fine PM",
         "%.1f ug/m3"),
        ("pm2_5_ug_m3", (((b[7] & 0x3F) << 8) | b[8]) * 0.1,
         "2.5um Fine PM", "%.1f ug/m3"),
        ("pm4_ug_m3", ((b[15] << 8) | b[16]) * 0.1, "4um Coarse PM",
         "%.1f ug/m3"),
        ("pm10_ug_m3", (((b[9] & 0x3F) << 8) | b[10]) * 0.1,
         "10um Coarse PM", "%.1f ug/m3"),
        ("co2_ppm", (b[11] << 8) | b[12], "Carbon Dioxide", "%d ppm"),
        ("unknown", (b[17] << 8) | b[18], "Do not know", "%d ?"),
        ("ext_power", int(battery_bars == 6), "External Power"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wh43")
def fineoffset_wh43(bits, dev):
    """Fine Offset WH43 air quality (ref src/devices/fineoffset_wh43.c).

    Note: the reference decoder passes a float expression as DATA_INT
    (``battery_pct``), which is varargs UB and crashes the reference
    binary on a MIC-valid packet; we emit the intended integer percent.
    """
    offset = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if offset + 10 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 10 * 8))
    if b[0] != 0x43:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:8]), 8, 0x31, 0x00) != b[8]
            or (util.add_bytes(bytes(b[:9])) & 0xFF) != b[9]):
        return DECODE_FAIL_MIC
    batt_bars = ((b[4] & 0x40) >> 4) | ((b[6] & 0xC0) >> 6)
    batt_lvl = min(batt_bars * 0.2, 1.0)
    return [Event.make(
        ("model", "Fineoffset-WH43"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", int(batt_bars > 1), "Battery"),
        ("battery_pct", int(100 * batt_lvl), "Battery level"),
        ("ext_power", int(batt_bars == 6), "External Power"),
        ("pm2_5_ug_m3", (((b[4] & 0x3F) << 8) | b[5]) // 10,
         "2.5um Fine PM", "%d ug/m3"),
        ("estimated_pm10_0_ug_m3", (((b[6] & 0x3F) << 8) | b[7]) // 10,
         "Estimate of 10um Coarse PM", "%d ug/m3"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_ws85")
def fineoffset_ws85(bits, dev):
    """Fine Offset WS85 weather station
    (ref src/devices/fineoffset_ws85.c)."""
    if bits.bits_per_row[0] < 168 or bits.bits_per_row[0] > 500:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32) + 32
    if offset + 32 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 32 * 8))
    if b[0] != 0x85:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:26]), 26, 0x31, 0x00) != b[26]
            or (util.add_bytes(bytes(b[:27])) & 0xFF) != b[27]):
        return DECODE_FAIL_MIC
    battery_mv = b[4] * 20
    wind_avg = ((b[5] & 0x10) << 4) | b[7]
    wind_dir = ((b[5] & 0x20) << 3) | b[8]
    wind_max = ((b[5] & 0x40) << 2) | b[9]
    supercap_v = b[17] & 0x3F
    battery_lvl = 0 if battery_mv < 1400 else (battery_mv - 1400) // 16
    battery_lvl = min(battery_lvl, 100)
    extra = "%02x%02x---%02x%02x%02x%02x%02x%02x%02x---%02x" % (
        b[13], b[14], b[18], b[19], b[20], b[21], b[22], b[23], b[24],
        b[28])
    return [Event.make(
        ("model", "Fineoffset-WS85"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", int(battery_mv > 2400), "Battery"),
        ("battery_pct", battery_lvl, "Battery level"),
        ("battery_mV", battery_mv, "Battery Voltage", "%d mV"),
        ("wind_dir_deg", wind_dir, "Wind direction")
        if wind_dir != 0x1FF else None,
        ("wind_avg_m_s", wind_avg * 0.1, "Wind speed", "%.1f m/s")
        if wind_avg != 0x1FF else None,
        ("wind_max_m_s", wind_max * 0.1, "Gust speed", "%.1f m/s")
        if wind_max != 0x1FF else None,
        ("flags", b[5], "Flags", "%02x"),
        ("rain_mm", ((b[15] << 8) | b[16]) * 0.1, "Total Rain", "%.1f mm"),
        ("rain_start", (b[12] & 0x10) >> 4, "Rain Start"),
        ("supercap_V", supercap_v * 0.1, "Supercap Voltage", "%.1f V")
        if supercap_v != 0xFF else None,
        ("firmware", b[25], "Firmware Version"),
        ("data", extra, "Extra Data"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wh52")
def fineoffset_wh52(bits, dev):
    """Fine Offset / Ecowitt WH52 soil moisture/temp/EC probe
    (ref src/devices/fineoffset_wh52.c)."""
    if bits.bits_per_row[0] < 200:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if offset + 24 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 24 * 8))
    if b[0] != 0xA2:
        return DECODE_ABORT_EARLY
    if (util.add_bytes(bytes(b[:23])) & 0xFF) != b[23]:
        return DECODE_FAIL_MIC
    if util.crc8(bytes(b[:22]), 22, 0x31, 0) != b[22]:
        return DECODE_FAIL_MIC
    ec_raw = ((b[8] & 0x0F) << 16) | (b[9] << 8) | b[10]
    return [Event.make(
        ("model", "Fineoffset-WH52"),
        ("id", "%02x%02x%02x" % (b[1], b[2], b[3]), "ID"),
        ("temperature_C", (((b[4] & 0x1F) << 8) | b[5]) * 0.1 - 40.0,
         "Temperature", "%.1f C"),
        ("moisture", b[6], "Moisture", "%u %%"),
        ("conductivity", ec_raw / 25.6, "Conductivity", "%.0f uS/cm"),
        ("battery_V", b[15] * 0.02 - 0.06, "Battery Voltage", "%.2f V"),
        ("boost", (b[4] & 0xE0) >> 5, "Transmission boost"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wh5rb")
def fineoffset_wh5rb(bits, dev):
    """Agimex Rosenborg 66796 (WH5 collision)
    (ref src/devices/fineoffset.c:183)."""
    if bits.bits_per_row[0] != 47 or int(bits.bb[0][0]) != 0xFE:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, 7, 40))
    if b[4] != util.crc8(bytes(b[:4]), 4, 0x31, 0):
        return DECODE_FAIL_MIC
    if (b[0] >> 4) != 4:
        return DECODE_FAIL_SANITY
    temp_raw = ((b[1] & 0x0F) << 8) | b[2]
    if temp_raw & 0x800:
        temp_raw = -(temp_raw & 0x7FF)
    return [Event.make(
        ("model", "Rosenborg-66796"),
        ("id", ((b[0] & 0x0F) << 4) | ((b[1] & 0xF0) >> 4), "ID"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[3], "Humidity", "%u %%") if b[3] != 0xFF else None,
        ("mic", "CRC", "Integrity"),
    )]

"""Fine Offset / EcoWitt / Ambient Weather FSK family, part 2 (reference
files cited per function): WH31E/WH31B/WH40/WN20/WS68, TX-8300, WH45,
WN34, WH31L (WH57), WS80, WS90.
"""

from __future__ import annotations

from ..bits import util
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_OTHER,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("ambientweather_wh31e")
def ambientweather_wh31e(bits, dev):
    """Ambient Weather WH31E/WH31B, EcoWitt WH40/WN20/WS68 (ref
    src/devices/ambientweather_wh31e.c)."""
    preamble = bytes([0xAA, 0x2D, 0xD4])
    events = []
    for row in range(bits.num_rows):
        start = bits.search(row, 0, preamble, 24)
        if start == bits.bits_per_row[row]:
            continue
        b = _ints(bits.extract_bytes(row, start + 24, 18 * 8))
        msg_type = b[0]
        if msg_type in (0x30, 0x37):
            if util.crc8(bytes(b[:6]), 6, 0x31, 0x00):
                continue
            if (util.add_bytes(bytes(b[:6]), 6) - b[6]) & 0xFF:
                continue
            temp_raw = ((b[2] & 0x03) << 8) | b[3]
            events.append(Event.make(
                ("model", "AmbientWeather-WH31E" if msg_type == 0x30
                 else "AmbientWeather-WH31B"),
                ("id", b[1]),
                ("channel", ((b[2] & 0x70) >> 4) + 1, "Channel"),
                ("battery_ok", int(not ((b[2] & 0x04) >> 2)), "Battery"),
                ("temperature_C", (temp_raw - 400) * 0.1, "Temperature",
                 "%.1f C"),
                ("humidity", b[4], "Humidity", "%u %%"),
                ("data", "%02x%02x%02x%02x%02x" % tuple(b[6:11]),
                 "Extra Data"),
                ("mic", "CRC", "Integrity"),
            ))
        elif msg_type == 0x52:
            if util.crc8(bytes(b[:10]), 10, 0x31, 0x00):
                continue
            if (util.add_bytes(bytes(b[:10]), 10) - b[10]) & 0xFF:
                continue
            year = ((b[3] & 0xF0) >> 4) * 10 + (b[3] & 0x0F) + 2000
            month = ((b[4] & 0x10) >> 4) * 10 + (b[4] & 0x0F)
            day = ((b[5] & 0x30) >> 4) * 10 + (b[5] & 0x0F)
            hours = ((b[6] & 0x30) >> 4) * 10 + (b[6] & 0x0F)
            minutes = ((b[7] & 0x70) >> 4) * 10 + (b[7] & 0x0F)
            seconds = ((b[8] & 0x70) >> 4) * 10 + (b[8] & 0x0F)
            events.append(Event.make(
                ("model", "AmbientWeather-WH31E"),
                ("id", b[1], "Station ID"),
                ("data", b[2], "Unknown"),
                ("radio_clock", "%04d-%02d-%02dT%02d:%02d:%02dZ" % (
                    year, month, day, hours, minutes, seconds), "Radio Clock"),
                ("mic", "CRC", "Integrity"),
            ))
        elif msg_type == 0x40:
            if util.crc8(bytes(b[:8]), 8, 0x31, 0x00):
                continue
            if (util.add_bytes(bytes(b[:8]), 8) - b[8]) & 0xFF:
                continue
            battery_v = b[4] & 0x1F
            battery_lvl = 0 if battery_v <= 9 else 100 * (battery_v - 9) // 6
            battery_lvl = min(battery_lvl, 100)
            events.append(Event.make(
                ("model", "EcoWitt-WH40"),
                ("id", ((b[1] & 0x0F) << 16) | (b[2] << 8) | b[3], "", "%05x"),
                ("battery_V", battery_v * 0.1, "Battery Voltage", "%f V")
                if battery_v != 0 else None,
                ("battery_ok", battery_lvl * 0.01, "Battery level")
                if battery_v != 0 else None,
                ("rain_mm", ((b[5] << 8) | b[6]) * 0.1, "Total Rain",
                 "%.1f mm"),
                ("data", "%02x%02x%02x%02x%02x" % tuple(b[9:14]),
                 "Extra Data"),
                ("mic", "CRC", "Integrity"),
            ))
        elif msg_type == 0x20:
            if util.crc8(bytes(b[:9]), 9, 0x31, 0x00):
                continue
            if (util.add_bytes(bytes(b[:9]), 9) - b[9]) & 0xFF:
                continue
            battery_raw = b[4]
            battery_lvl = (0 if battery_raw <= 90
                           else 100 * (battery_raw - 90) // 60)
            battery_lvl = min(battery_lvl, 100)
            events.append(Event.make(
                ("model", "EcoWitt-WN20"),
                ("id", (b[2] << 8) | b[3]),
                ("battery_V", battery_raw * 0.02, "Battery Voltage", "%.2f V"),
                ("battery_ok", int(battery_lvl > 0), "Battery OK"),
                ("battery_pct", battery_lvl, "Battery level"),
                ("rain_mm", ((b[5] << 8) | b[6]) * 0.1, "Total Rain",
                 "%.1f mm"),
                ("data", "%02x%02x%02x%02x%02x" % tuple(b[10:15]),
                 "Extra Data"),
                ("mic", "CRC", "Integrity"),
            ))
        elif msg_type == 0x68:
            if util.crc8(bytes(b[:15]), 15, 0x31, 0x00):
                continue
            if (util.add_bytes(bytes(b[:15]), 15) - b[15]) & 0xFF:
                continue
            events.append(Event.make(
                ("model", "EcoWitt-WS68"),
                ("id", (b[2] << 8) | b[3]),
                ("battery_raw", b[6], "Battery Raw"),
                ("battery_ok", int(b[6] > 0x20), "Battery OK"),
                ("light_lux", ((b[4] << 8) | b[5]) * 10, "Lux", "%u lux"),
                ("wind_avg_m_s", (((b[7] & 0x10) << 4) | b[10]) * 0.1,
                 "Wind Speed", "%.1f m/s"),
                ("wind_max_m_s", (((b[7] & 0x40) << 2) | b[12]) * 0.1,
                 "Wind Gust", "%.1f m/s"),
                ("uvi", float(int(b[13] * 0.1)), "UV Index", "%.0f"),
                ("wind_dir_deg", ((b[7] & 0x20) << 3) | b[11], "Wind dir"),
                ("data", "%02x%01x" % (b[16], b[17] >> 4), "Extra Data"),
                ("mic", "CRC", "Integrity"),
            ))
    return events


def _tx8300_chk(b):
    x = y = 0
    for i in range(4):
        x += (b[i] & 0xF) + ((b[i] & 0xF0) >> 4)
        y += (b[i] & 0x5) + ((b[i] & 0x50) >> 4)
    c0 = (~x) & 0xF
    c1 = (~y) & 0xF
    return (c0 << 4) | c1


@decoder("ambientweather_tx8300")
def ambientweather_tx8300(bits, dev):
    """Ambient Weather TX-8300 / TFA 30.3211.02 (ref
    src/devices/ambientweather_tx8300.c)."""
    if bits.bits_per_row[0] != 74:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 2, 72))
    for i in range(4, 8):
        b[i] ^= 0xFF
    b[0] = (b[0] & 0x7F) | (b[4] & 0x80)
    if b[0] != b[4] or b[1] != b[5] or b[2] != b[6] or b[3] != b[7]:
        return DECODE_FAIL_MIC
    if _tx8300_chk(b) ^ b[8]:
        return DECODE_FAIL_MIC
    temp = (b[2] & 0x0F) * 10 + ((b[3] & 0xF0) >> 4) + (b[3] & 0x0F) * 0.1
    minus = (b[1] & 0x08) >> 3
    humidity = ((b[0] & 0xF0) >> 4) * 10 + (b[0] & 0x0F)
    if ((b[0] & 0xF0) >> 4) > 9 or (b[0] & 0x0F) > 9:
        humidity = -1
    return [Event.make(
        ("model", "AmbientWeather-TX8300"),
        ("id", ((b[1] & 0x07) << 4) | ((b[2] & 0xF0) >> 4)),
        ("channel", (b[1] & 0x30) >> 4),
        ("battery", (b[1] & 0xC0) >> 6, "Battery"),
        ("temperature_C", -temp if minus else temp, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%") if humidity >= 0 else None,
        ("mic", "CHECKSUM", "MIC"),
    )]


@decoder("fineoffset_wh45")
def fineoffset_wh45(bits, dev):
    """Fine Offset WH45 air quality sensor (ref
    src/devices/fineoffset_wh45.c)."""
    if bits.bits_per_row[0] < 170 or bits.bits_per_row[0] > 240:
        return DECODE_ABORT_LENGTH
    off = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if off + 15 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, off, 15 * 8))
    if b[0] != 0x45:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:13]), 13, 0x31, 0x00) != b[13]
            or util.add_bytes(bytes(b[:14]), 14) & 0xFF != b[14]):
        return DECODE_FAIL_MIC
    temp_raw = ((b[4] & 0x7) << 8) | b[5]
    battery_bars = ((b[7] & 0x40) >> 4) | ((b[9] & 0xC0) >> 6)
    return [Event.make(
        ("model", "Fineoffset-WH45"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", min(battery_bars * 0.2, 1.0), "Battery level", "%.1f"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[6], "Humidity", "%u %%"),
        ("pm2_5_ug_m3", (((b[7] & 0x3F) << 8) | b[8]) * 0.1,
         "2.5um Fine Particulate Matter", "%.1f ug/m3"),
        ("pm10_ug_m3", (((b[9] & 0x3F) << 8) | b[10]) * 0.1,
         "10um Coarse Particulate Matter", "%.1f ug/m3"),
        ("co2_ppm", (b[11] << 8) | b[12], "Carbon Dioxide", "%d ppm"),
        ("ext_power", int(battery_bars == 6), "External Power"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wn34")
def fineoffset_wn34(bits, dev):
    """Fine Offset WN34S/L/D, WN38 (ref src/devices/fineoffset_wn34.c)."""
    off = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if off + 9 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, off, 9 * 8))
    if b[0] != 0x34 and b[0] != 0x38:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:7]), 7, 0x31, 0x00) != b[7]
            or util.add_bytes(bytes(b[:8]), 8) & 0xFF != b[8]):
        return DECODE_FAIL_MIC
    temp_raw = _s16(((b[4] & 0x0F) << 12) | (b[5] << 4))
    sub_type = (b[4] & 0xF0) >> 4
    if sub_type == 4:
        temperature = (temp_raw >> 4) * 0.1
    else:
        temperature = (temp_raw >> 4) * 0.1 - 40
    battery_mv = (b[6] & 0x7F) * 20
    if battery_mv > 1440:
        battery_bars = 5
    elif battery_mv > 1380:
        battery_bars = 4
    elif battery_mv > 1300:
        battery_bars = 3
    elif battery_mv > 1200:
        battery_bars = 2
    else:
        battery_bars = 1
    if b[0] == 0x38:
        model = "Fineoffset-WN38"
    elif sub_type == 4:
        model = "Fineoffset-WN34D"
    else:
        model = "Fineoffset-WN34"
    return [Event.make(
        ("model", model),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%x"),
        ("battery_ok", (battery_bars - 1) * 0.25, "Battery level", "%.1f"),
        ("battery_mV", battery_mv, "Battery Voltage", "%d mV"),
        ("temperature_C", temperature, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wh31l")
def fineoffset_wh31l(bits, dev):
    """Fine Offset WH57 / Ambient WH31L lightning sensor (ref
    src/devices/fineoffset_wh31l.c)."""
    start = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, start + 24, 9 * 8))
    if b[0] != 0x57:
        return DECODE_ABORT_EARLY
    if util.crc8(bytes(b[:8]), 8, 0x31, 0x00):
        return DECODE_FAIL_MIC
    if (util.add_bytes(bytes(b[:8]), 8) - b[8]) & 0xFF:
        return DECODE_FAIL_MIC
    state = b[1] >> 4
    state_str = {0: "reset", 1: "interference", 4: "noise",
                 8: "strike"}.get(state, "unknown")
    s_dist = b[5] & 0x3F
    return [Event.make(
        ("model", "FineOffset-WH31L"),
        ("id", ((b[1] & 0xF) << 16) | (b[2] << 8) | b[3]),
        ("battery_ok", ((b[4] & 0x06) >> 1) * 0.5, "Battery level"),
        ("state", state_str, "State"),
        ("flags", (state << 12) | (b[4] << 4) | (b[5] >> 4), "Flags", "%04x"),
        ("storm_dist_km", s_dist, "Storm Distance", "%d km")
        if s_dist != 63 else None,
        ("strike_count", b[6], "Strike Count"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_ws80")
def fineoffset_ws80(bits, dev):
    """Fine Offset WS80 weather station (ref src/devices/fineoffset_ws80.c)."""
    if bits.bits_per_row[0] < 168 or bits.bits_per_row[0] > 240:
        return DECODE_ABORT_LENGTH
    off = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if off + 18 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, off, 18 * 8))
    if b[0] != 0x80:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:17]), 17, 0x31, 0x00) != 0
            or util.add_bytes(bytes(b[:17]), 17) & 0xFF != b[17]):
        return DECODE_FAIL_MIC
    light_raw = (b[4] << 8) | b[5]
    battery_mv = b[6] * 20
    battery_lvl = 0 if battery_mv < 1400 else (battery_mv - 1400) // 16
    temp_raw = ((b[7] & 0x03) << 8) | b[8]
    humidity = b[9]
    wind_avg = ((b[7] & 0x10) << 4) | b[10]
    wind_dir = ((b[7] & 0x20) << 3) | b[11]
    wind_max = ((b[7] & 0x40) << 2) | b[12]
    uv_index = b[13]
    unknown = (b[14] << 8) | b[15]
    return [Event.make(
        ("model", "Fineoffset-WS80"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", battery_lvl * 0.01, "Battery level"),
        ("battery_mV", battery_mv, "Battery Voltage", "%d mV"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C")
        if temp_raw != 0x3FF else None,
        ("humidity", humidity, "Humidity", "%u %%")
        if humidity != 0xFF else None,
        ("wind_dir_deg", wind_dir, "Wind direction")
        if wind_dir != 0x1FF else None,
        ("wind_avg_m_s", wind_avg * 0.1, "Wind speed", "%.1f m/s")
        if wind_avg != 0x1FF else None,
        ("wind_max_m_s", wind_max * 0.1, "Gust speed", "%.1f m/s")
        if wind_max != 0x1FF else None,
        ("uvi", uv_index * 0.1, "UV Index", "%.1f")
        if uv_index != 0xFF else None,
        ("light_lux", float(light_raw * 10), "Light", "%.1f lux")
        if light_raw != 0xFFFF else None,
        ("flags", b[7], "Flags", "%02x"),
        ("unknown", unknown, "Unknown") if unknown != 0x3FFF else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_ws90")
def fineoffset_ws90(bits, dev):
    """Fine Offset WS90 weather station (ref src/devices/fineoffset_ws90.c)."""
    if bits.bits_per_row[0] < 168 or bits.bits_per_row[0] > 500:
        return DECODE_ABORT_LENGTH
    off = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32) + 32
    if off + 32 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, off, 32 * 8))
    if b[0] != 0x90:
        return DECODE_ABORT_EARLY
    if (util.crc8(bytes(b[:31]), 31, 0x31, 0x00) != 0
            or util.add_bytes(bytes(b[:31]), 31) & 0xFF != b[31]):
        return DECODE_FAIL_MIC
    light_raw = (b[4] << 8) | b[5]
    battery_mv = b[6] * 20
    battery_lvl = 0 if battery_mv < 1400 else (battery_mv - 1400) // 16
    battery_lvl = min(battery_lvl, 100)
    temp_raw = ((b[7] & 0x03) << 8) | b[8]
    humidity = b[9]
    wind_avg = ((b[7] & 0x10) << 4) | b[10]
    wind_dir = ((b[7] & 0x20) << 3) | b[11]
    wind_max = ((b[7] & 0x40) << 2) | b[12]
    uv_index = b[13]
    pressure = (b[14] << 8) | b[15]
    supercap_v = b[21] & 0x3F
    extra = ("%02x%02x%02x%02x%02x------%02x%02x%02x%02x%02x%02x%02x"
             % (b[14], b[15], b[16], b[17], b[18],
                b[22], b[23], b[24], b[25], b[26], b[27], b[28]))
    return [Event.make(
        ("model", "Fineoffset-WS90"),
        ("id", (b[1] << 16) | (b[2] << 8) | b[3], "ID", "%06x"),
        ("battery_ok", battery_lvl * 0.01, "Battery level"),
        ("battery_mV", battery_mv, "Battery Voltage", "%d mV"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C")
        if temp_raw != 0x3FF else None,
        ("humidity", humidity, "Humidity", "%u %%")
        if humidity != 0xFF else None,
        ("pressure_hPa", float(pressure), "Pressure", "%.1f hPa")
        if pressure != 0x3FFF else None,
        ("wind_dir_deg", wind_dir, "Wind direction")
        if wind_dir != 0x1FF else None,
        ("wind_avg_m_s", wind_avg * 0.1, "Wind speed", "%.1f m/s")
        if wind_avg != 0x1FF else None,
        ("wind_max_m_s", wind_max * 0.1, "Gust speed", "%.1f m/s")
        if wind_max != 0x1FF else None,
        ("uvi", uv_index * 0.1, "UV Index", "%.1f")
        if uv_index != 0xFF else None,
        ("light_lux", float(light_raw * 10), "Light", "%.1f lux")
        if light_raw != 0xFFFF else None,
        ("flags", b[7], "Flags", "%02x"),
        ("rain_mm", ((b[19] << 8) | b[20]) * 0.1, "Total Rain", "%.1f mm"),
        ("rain_start", (b[16] & 0x10) >> 4, "Rain Start"),
        ("supercap_V", supercap_v * 0.1, "Supercap Voltage", "%.1f V")
        if supercap_v != 0xFF else None,
        ("firmware", b[29], "Firmware Version"),
        ("data", extra, "Extra Data"),
        ("mic", "CRC", "Integrity"),
    )]

"""Bresser weather sensor decoders (ref src/devices/bresser_3ch.c,
bresser_5in1.c, bresser_6in1.c, bresser_7in1.c)."""

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


def _s32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("bresser_3ch")
def bresser_3ch(bits, dev):
    """Bresser-3CH (ref src/devices/bresser_3ch.c:37-93): inverted 40-bit
    rows x3, additive checksum."""
    r = bits.find_repeated_row(3, 40)
    if r < 0 or bits.bits_per_row[r] > 42:
        return DECODE_ABORT_LENGTH
    b = [~x & 0xFF for x in _ints(bits.bb[r])[:5]]
    if ((b[0] + b[1] + b[2] + b[3] - b[4]) & 0xFF) != 0:
        return DECODE_FAIL_MIC
    battery_low = (b[1] & 0x80) >> 7
    channel = (b[1] & 0x30) >> 4
    temp_f = ((((b[1] & 0x0F) << 8) + b[2]) - 900) * 0.1
    humidity = b[3]
    if channel == 0 or humidity > 100 or temp_f < -20.0 or temp_f > 160.0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Bresser-3CH"),
        ("id", b[0], "Id"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(not battery_low), "Battery"),
        ("temperature_F", temp_f, "Temperature", "%.2f F"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("bresser_5in1")
def bresser_5in1(bits, dev):
    """Bresser-5in1 / ProRainGauge (ref src/devices/bresser_5in1.c:67-168):
    26-byte payload where the first 13 bytes are the inverse of the last."""
    preamble = bytes([0xAA, 0xAA, 0xAA, 0x2D, 0xD4])
    n = bits.bits_per_row[0]
    if bits.num_rows != 1 or n < 248 or n > 440:
        return DECODE_ABORT_EARLY
    start_pos = bits.search(0, 0, preamble, 40)
    if start_pos == n:
        return DECODE_ABORT_LENGTH
    start_pos += 40
    length = n - start_pos
    if (length + 7) // 8 < 26:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start_pos, min(length, 26 * 8)))
    msg = (msg + [0] * 26)[:26]
    for col in range(13):
        if (msg[col] ^ msg[col + 13]) != 0xFF:
            return DECODE_FAIL_MIC
    sensor_id = msg[14]
    temp_ok = (msg[20] & 0x0F) <= 9
    temp_raw = (msg[20] & 0x0F) + ((msg[20] & 0xF0) >> 4) * 10 \
        + (msg[21] & 0x0F) * 100
    if msg[25] & 0x0F:
        temp_raw = -temp_raw
    humidity_ok = (msg[22] & 0x0F) <= 9
    humidity = (msg[22] & 0x0F) + ((msg[22] & 0xF0) >> 4) * 10
    wind_dir = ((msg[17] & 0xF0) >> 4) * 22.5
    gust_raw = ((msg[17] & 0x0F) << 8) + msg[16]
    wind_raw = (msg[18] & 0x0F) + ((msg[18] & 0xF0) >> 4) * 10 \
        + (msg[19] & 0x0F) * 100
    rain_raw = (msg[23] & 0x0F) + ((msg[23] & 0xF0) >> 4) * 10 \
        + (msg[24] & 0x0F) * 100 + ((msg[24] & 0xF0) >> 4) * 1000
    rain = rain_raw * 0.1
    battery_low = msg[25] & 0x80
    sensor_type = msg[15] & 0x7F
    if 0x39 <= sensor_type <= 0x3B:
        return [Event.make(
            ("model", "Bresser-ProRainGauge"),
            ("id", sensor_id),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C")
            if temp_ok else None,
            ("rain_mm", rain * 2.5, "Rain", "%.1f mm"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return [Event.make(
        ("model", "Bresser-5in1"),
        ("id", sensor_id),
        ("battery_ok", int(not battery_low), "Battery"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C")
        if temp_ok else None,
        ("humidity", humidity, "Humidity") if humidity_ok else None,
        ("wind_max_m_s", gust_raw * 0.1, "Wind Gust", "%.1f m/s"),
        ("wind_avg_m_s", wind_raw * 0.1, "Wind Speed", "%.1f m/s"),
        ("wind_dir_deg", wind_dir, "Direction", "%.1f"),
        ("rain_mm", rain, "Rain", "%.1f mm"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_MOISTURE_MAP = [0, 7, 13, 20, 27, 33, 40, 47, 53, 60, 67, 73, 80, 87, 93, 99]


@decoder("bresser_6in1")
def bresser_6in1(bits, dev):
    """Bresser-6in1 (ref src/devices/bresser_6in1.c:96-262): LFSR-16
    digest gen 0x8810 key 0x5412 + add-to-0xff checksum."""
    preamble = bytes([0xAA, 0xAA, 0x2D, 0xD4])
    n = bits.bits_per_row[0]
    if bits.num_rows != 1 or n < 160 or n > 440:
        return DECODE_ABORT_EARLY
    start_pos = bits.search(0, 0, preamble, 32) + 32
    if start_pos >= n:
        return DECODE_ABORT_LENGTH
    if n - start_pos < 18 * 8:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start_pos, 18 * 8))
    chkdgst = (msg[0] << 8) | msg[1]
    if chkdgst != util.lfsr_digest16(bytes(msg[2:17]), 15, 0x8810, 0x5412):
        return DECODE_FAIL_MIC
    if (sum(msg[2:18]) & 0xFF) != 0xFF:
        return DECODE_FAIL_MIC
    id_ = _s32((msg[2] << 24) | (msg[3] << 16) | (msg[4] << 8) | msg[5])
    s_type = msg[6] >> 4
    startup = (msg[6] >> 3) & 1
    chan = msg[6] & 0x7
    battery = (msg[13] >> 1) & 1
    temp_ok = msg[12] <= 0x99 and (msg[13] & 0xF0) <= 0x90
    temp_raw = (msg[12] >> 4) * 100 + (msg[12] & 0x0F) * 10 + (msg[13] >> 4)
    temp_c = temp_raw * 0.1
    if (msg[13] >> 3) & 1:
        temp_c = (temp_raw - 1000) * 0.1
    if temp_c < -50.0:
        temp_c = -temp_raw * 0.1
    humidity = (msg[14] >> 4) * 10 + (msg[14] & 0x0F)
    uv_ok = (msg[16] & 0x0F) == 0 and (~msg[15] & 0xFF) <= 0x99 \
        and (~msg[16] & 0xF0) <= 0x90
    uv_raw = ((~msg[15] & 0xF0) >> 4) * 100 + (~msg[15] & 0x0F) * 10 \
        + ((~msg[16] & 0xF0) >> 4)
    flags = msg[16] & 0x0F
    w7, w8, w9 = msg[7] ^ 0xFF, msg[8] ^ 0xFF, msg[9] ^ 0xFF
    wind_ok = w7 <= 0x99 and w8 <= 0x99 and w9 <= 0x99
    gust_raw = (w7 >> 4) * 100 + (w7 & 0x0F) * 10 + (w8 >> 4)
    wavg_raw = (w9 >> 4) * 100 + (w9 & 0x0F) * 10 + (w8 & 0x0F)
    wind_dir = ((msg[10] & 0xF0) >> 4) * 100 + (msg[10] & 0x0F) * 10 \
        + ((msg[11] & 0xF0) >> 4)
    r12, r13, r14 = msg[12] ^ 0xFF, msg[13] ^ 0xFF, msg[14] ^ 0xFF
    rain_ok = msg[16] & 1
    rain_raw = (r12 >> 4) * 100000 + (r12 & 0x0F) * 10000 \
        + (r13 >> 4) * 1000 + (r13 & 0x0F) * 100 \
        + (r14 >> 4) * 10 + (r14 & 0x0F)
    if s_type in (2, 4):
        wind_ok = 0
        uv_ok = 0
    moisture = -1
    if s_type == 4 and temp_ok and 1 <= humidity <= 16:
        moisture = _MOISTURE_MAP[humidity - 1]
    return [Event.make(
        ("model", "Bresser-6in1"),
        ("id", id_, "", "%08x"),
        ("channel", chan),
        ("battery_ok", battery, "Battery") if not rain_ok else None,
        ("temperature_C", temp_c, "Temperature", "%.1f C")
        if temp_ok else None,
        ("humidity", humidity, "Humidity")
        if temp_ok and moisture < 0 else None,
        ("sensor_type", s_type, "Sensor type"),
        ("moisture", moisture, "Moisture", "%d %%")
        if moisture >= 0 else None,
        ("wind_max_m_s", gust_raw * 0.1, "Wind Gust", "%.1f m/s")
        if wind_ok else None,
        ("wind_avg_m_s", wavg_raw * 0.1, "Wind Speed", "%.1f m/s")
        if wind_ok else None,
        ("wind_dir_deg", wind_dir, "Direction") if wind_ok else None,
        ("rain_mm", rain_raw * 0.1, "Rain", "%.1f mm") if rain_ok else None,
        ("uvi", uv_raw * 0.1, "UV Index", "%.1f") if uv_ok else None,
        ("startup", startup, "Startup") if startup else None,
        ("flags", flags, "Flags"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("bresser_7in1")
def bresser_7in1(bits, dev):
    """Bresser-7in1 / Air-PM / CO2 / HCHO-VOC (ref src/devices/
    bresser_7in1.c:140-323): 0xaa-whitened, LFSR-16 digest xor 0x6df1."""
    preamble = bytes([0xAA, 0xAA, 0xAA, 0x2D, 0xD4])
    n = bits.bits_per_row[0]
    if bits.num_rows != 1 or n < 160:
        return DECODE_ABORT_LENGTH
    start_pos = bits.search(0, 0, preamble, 40) + 40
    if start_pos >= n:
        return DECODE_ABORT_EARLY
    if start_pos + 21 * 8 >= n:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start_pos, 25 * 8))
    msg = (msg + [0] * 25)[:25]
    if msg[21] == 0x00:
        return DECODE_FAIL_SANITY
    s_type = msg[6] >> 4
    nstartup = (msg[6] & 0x08) >> 3
    chan = msg[6] & 0x07
    msg = [x ^ 0xAA for x in msg]
    chk = (msg[0] << 8) | msg[1]
    digest = util.lfsr_digest16(bytes(msg[2:25]), 23, 0x8810, 0xBA95)
    if (chk ^ digest) != 0x6DF1:
        return DECODE_FAIL_MIC
    id_ = (msg[2] << 8) | msg[3]
    flags = msg[15] & 0x0F
    battery_low = (flags & 0x06) == 0x06
    if s_type in (1, 12, 13):
        wdir = (msg[4] >> 4) * 100 + (msg[4] & 0x0F) * 10 + (msg[5] >> 4)
        wgst_raw = (msg[7] >> 4) * 100 + (msg[7] & 0x0F) * 10 + (msg[8] >> 4)
        wavg_raw = (msg[8] & 0x0F) * 100 + (msg[9] >> 4) * 10 + (msg[9] & 0x0F)
        rain_raw = (msg[10] >> 4) * 100000 + (msg[10] & 0x0F) * 10000 \
            + (msg[11] >> 4) * 1000 + (msg[11] & 0x0F) * 100 \
            + (msg[12] >> 4) * 10 + (msg[12] & 0x0F)
        temp_raw = (msg[14] >> 4) * 100 + (msg[14] & 0x0F) * 10 \
            + (msg[15] >> 4)
        temp_c = temp_raw * 0.1
        if temp_raw > 600:
            temp_c = (temp_raw - 1000) * 0.1
        humidity = (msg[16] >> 4) * 10 + (msg[16] & 0x0F)
        lght_raw = (msg[17] >> 4) * 100000 + (msg[17] & 0x0F) * 10000 \
            + (msg[18] >> 4) * 1000 + (msg[18] & 0x0F) * 100 \
            + (msg[19] >> 4) * 10 + (msg[19] & 0x0F)
        uv_raw = (msg[20] >> 4) * 100 + (msg[20] & 0x0F) * 10 + (msg[21] >> 4)
        wind_light_ok = s_type != 12
        tglobe_ok = False
        tglobe_c = 0.0
        if s_type == 13 and (msg[23] >> 4) < 10:
            tglobe_ok = True
            tglobe_c = (msg[22] >> 4) * 10 + (msg[22] & 0x0F) \
                + (msg[23] >> 4) * 0.1
        return [Event.make(
            ("model", "Bresser-7in1"),
            ("id", id_),
            ("startup", int(not nstartup), "Startup")
            if not nstartup else None,
            ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ("humidity", humidity, "Humidity"),
            ("wind_max_m_s", wgst_raw * 0.1, "Wind Gust", "%.1f m/s")
            if wind_light_ok else None,
            ("wind_avg_m_s", wavg_raw * 0.1, "Wind Speed", "%.1f m/s")
            if wind_light_ok else None,
            ("wind_dir_deg", wdir, "Direction") if wind_light_ok else None,
            ("rain_mm", rain_raw * 0.1, "Rain", "%.1f mm"),
            ("light_klx", lght_raw * 0.001, "Light", "%.3f klx")
            if wind_light_ok else None,
            ("light_lux", float(lght_raw), "Light", "%.3f lux")
            if wind_light_ok else None,
            ("uvi", uv_raw * 0.1, "UV Index", "%.1f")
            if wind_light_ok else None,
            ("temperature_1_C", tglobe_c, "Globe Temp", "%.1f C")
            if tglobe_ok else None,
            ("battery_ok", int(not battery_low), "Battery"),
            ("mic", "CRC", "Integrity"),
        )]
    if s_type == 8:
        pm_2_5 = (msg[10] & 0x0F) * 1000 + (msg[11] >> 4) * 100 \
            + (msg[11] & 0x0F) * 10 + (msg[12] >> 4)
        pm_10 = (msg[12] & 0x0F) * 1000 + (msg[13] >> 4) * 100 \
            + (msg[13] & 0x0F) * 10 + (msg[14] >> 4)
        pm_2_5_init = (msg[10] & 0x0F) == 0x0F
        pm_10_init = (msg[12] & 0x0F) == 0x0F
        return [Event.make(
            ("model", "Bresser-7in1"),
            ("id", id_),
            ("channel", chan),
            ("startup", int(not nstartup), "Startup")
            if not nstartup else None,
            ("battery_ok", int(not battery_low), "Battery"),
            ("pm2_5_ug_m3", pm_2_5, "PM2.5 Mass Concentration")
            if not pm_2_5_init else None,
            ("pm10_0_ug_m3", pm_10, "PM10 Mass Concentraton")
            if not pm_10_init else None,
            ("mic", "CRC", "Integrity"),
        )]
    if s_type == 10:
        co2 = ((msg[4] & 0xF0) >> 4) * 1000 + (msg[4] & 0x0F) * 100 \
            + ((msg[5] & 0xF0) >> 4) * 10 + (msg[5] & 0x0F)
        co2_init = (msg[5] & 0x0F) == 0x0F
        return [Event.make(
            ("model", "Bresser-CO2"),
            ("id", id_),
            ("channel", chan),
            ("startup", int(not nstartup), "Startup")
            if not nstartup else None,
            ("battery_ok", int(not battery_low), "Battery"),
            ("co2_ppm", co2, "Carbon Dioxide", "%d ppm")
            if not co2_init else None,
            ("mic", "CRC", "Integrity"),
        )]
    if s_type == 11:
        hcho = ((msg[4] & 0xF0) >> 4) * 1000 + (msg[4] & 0x0F) * 100 \
            + ((msg[5] & 0xF0) >> 4) * 10 + (msg[5] & 0x0F)
        voc = msg[22] & 0x0F
        return [Event.make(
            ("model", "Bresser-HCHOVOC"),
            ("id", id_),
            ("channel", chan),
            ("startup", int(not nstartup), "Startup")
            if not nstartup else None,
            ("battery_ok", int(not battery_low), "Battery"),
            ("hcho_ppb", hcho, "Formaldehyde", "%d ppb")
            if (msg[5] & 0x0F) != 0x0F else None,
            ("voc_level", voc, "Volatile Organic Compounds", "%d")
            if voc != 0x0F else None,
            ("mic", "CRC", "Integrity"),
        )]
    return DECODE_FAIL_SANITY

"""Home sensors batch 3 (reference files cited per function):
Eurochron EFTH-800, Cotech 36-7959, Telldus FT0385R, EMOS E6016,
Inkbird ITH-20R, RainPoint, TFA 14.1504.V2.
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _s8(v):
    return ((int(v) & 0xFF) ^ 0x80) - 0x80


@decoder("eurochron_efth800")
def eurochron_efth800(bits, dev):
    """Eurochron EFTH-800 (ref src/devices/efth800.c)."""
    bits.invert()
    dcf77_str = ""
    row = bits.find_repeated_row(2, 65)
    if row > 0:
        b = _ints(bits.bb[row])
        if not util.crc8(bytes(b[:8]), 8, 0x31, 0x00):
            dcf77_str = "%4d-%02d-%02dT%02d:%02d:%02d" % (
                (b[5] >> 1) + 2000, b[6] & 0x0F,
                ((b[5] & 0x01) << 4) | ((b[6] & 0xF0) >> 4),
                b[2] & 0x1F, b[3] & 0x3F, b[4] & 0x3F)
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] > 49:
            bits.bits_per_row[row] = 0  # cancel row (reference quirk)
    row = bits.find_repeated_row(2, 48)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 49:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] == 0x00 and b[1] == 0x00 and b[2] == 0x00 and b[4] == 0x00:
        return DECODE_FAIL_SANITY
    if util.crc8(bytes(b[:6]), 6, 0x31, 0x00):
        return DECODE_FAIL_MIC
    temp_raw = _s16((b[2] & 0x3F) << 10) | ((b[3] & 0xF0) << 2)
    return [Event.make(
        ("model", "Eurochron-EFTH800"),
        ("id", ((b[0] & 0x0F) << 8) | b[1]),
        ("channel", ((b[0] & 0x70) >> 4) + 1),
        ("battery_ok", int(not (b[2] >> 7)), "Battery"),
        ("temperature_C", (temp_raw >> 6) * 0.1, "Temperature", "%.1f C"),
        ("humidity", (b[4] >> 4) * 10 + (b[4] & 0xF), "Humidity"),
        ("mic", "CRC", "Integrity"),
        ("radio_clock", dcf77_str, "Radio Clock") if dcf77_str else None,
    )]


@decoder("cotech_36_7959")
def cotech_36_7959(bits, dev):
    """Cotech 36-7959 / SwitchDoc FT020T (ref src/devices/cotech_36_7959.c)."""
    if bits.num_rows > 2:
        return DECODE_ABORT_EARLY
    if all(bits.bits_per_row[i] < 112 for i in range(bits.num_rows)):
        return DECODE_ABORT_EARLY
    b = None
    for i in range(bits.num_rows):
        pos = bits.search(i, 0, bytes([0x01, 0x40]), 12) + 12
        if pos + 112 > bits.bits_per_row[i]:
            continue
        b = _ints(bits.extract_bytes(i, pos, 112))
        break
    if b is None:
        return DECODE_FAIL_SANITY
    if util.crc8(bytes(b[:14]), 14, 0x31, 0xC0):
        return DECODE_FAIL_MIC
    wind = ((b[1] & 0x01) << 8) | b[2]
    gust = (((b[1] & 0x02) >> 1) << 8) | b[3]
    wind_dir = (((b[1] & 0x04) >> 2) << 8) | b[4]
    rain = ((b[5] & 0x0F) << 8) | b[6]
    temp_raw = ((b[7] & 0x0F) << 8) | b[8]
    light_lux = (b[10] << 8) | b[11] | ((b[7] & 0x80) << 9)
    uvi = b[12]
    light_is_valid = uvi <= 150
    return [Event.make(
        ("model", "Cotech-367959"),
        ("id", ((b[0] & 0x0F) << 4) | (b[1] >> 4), "ID"),
        ("battery_ok", int(not ((b[1] & 0x08) >> 3)), "Battery"),
        ("temperature_F", (temp_raw - 400) * 0.1, "Temperature", "%.1f F"),
        ("humidity", b[9], "Humidity", "%u %%"),
        ("rain_mm", rain * 0.1, "Rain", "%.1f mm"),
        ("wind_dir_deg", wind_dir, "Wind direction"),
        ("wind_avg_m_s", wind * 0.1, "Wind", "%.1f m/s"),
        ("wind_max_m_s", gust * 0.1, "Gust", "%.1f m/s"),
        ("light_lux", light_lux, "Light Intensity", "%u lux")
        if light_is_valid else None,
        ("uvi", uvi * 0.1, "UV Index", "%.1f") if light_is_valid else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("telldus_ft0385r")
def telldus_ft0385r(bits, dev):
    """Telldus FT0385R indoor unit (ref src/devices/telldus_ft0385r.c)."""
    if bits.num_rows > 2:
        return DECODE_ABORT_EARLY
    if all(bits.bits_per_row[i] < 296 for i in range(bits.num_rows)):
        return DECODE_ABORT_EARLY
    b = None
    for i in range(bits.num_rows):
        pos = bits.search(i, 0, bytes([0x14, 0xE0]), 9) + 8
        if pos + 296 > bits.bits_per_row[i]:
            continue
        b = _ints(bits.extract_bytes(i, pos, 296))
        break
    if b is None:
        return DECODE_FAIL_SANITY
    if util.crc8(bytes(b[:37]), 37, 0x31, 0xC0):
        return DECODE_FAIL_MIC
    wind = ((b[2] & 0x01) << 8) | b[3]
    gust = (((b[2] & 0x02) >> 1) << 8) | b[4]
    wind_dir = (((b[2] & 0x04) >> 2) << 8) | b[5]
    rain_tot = (b[20] << 8) | b[21]
    temp_raw = ((b[24] & 0x0F) << 8) | b[25]
    temp2_raw = (((b[24] & 0xF0) >> 4) << 8) | b[27]
    pressure = (b[29] << 8) | b[30]
    if temp_raw != 0x7FB:
        return [Event.make(
            ("model", "Telldus-FT0385R"),
            ("temperature_F", (temp_raw - 400) * 0.1, "Temperature", "%.1f F"),
            ("humidity", b[26], "Humidity", "%u %%"),
            ("temperature_2_F", (temp2_raw - 400) * 0.1, "Temperature in",
             "%.1f F"),
            ("humidity_2", b[28], "Humidity in", "%u %%"),
            ("pressure_hPa", pressure * 0.1, "Pressure", "%.1f hPa"),
            ("rain_mm", rain_tot * 0.1, "Rain", "%.1f mm"),
            ("wind_dir_deg", wind_dir, "Wind direction"),
            ("wind_avg_m_s", wind * 0.1, "Wind", "%.1f m/s"),
            ("wind_max_m_s", gust * 0.1, "Gust", "%.1f m/s"),
            ("mic", "CRC", "Integrity"),
        )]
    return [Event.make(
        ("model", "Telldus-FT0385R"),
        ("temperature_2_F", (temp2_raw - 400) * 0.1, "Temperature in",
         "%.1f F"),
        ("humidity_2", b[28], "Humidity in", "%u %%"),
        ("pressure_hPa", pressure * 0.1, "Pressure", "%.1f hPa"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("emos_e6016")
def emos_e6016(bits, dev):
    """EMOS E6016/E6018 (ref src/devices/emos_e6016.c)."""
    row = bits.find_repeated_prefix(3, 120 - 8)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 120:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] != 0x55 or b[1] != 0x5A or b[2] != 0x7C:
        return DECODE_ABORT_EARLY
    bits.invert()
    b = _ints(bits.bb[row])
    if (util.add_bytes(bytes(b[:13]), 13) & 0xFF) != b[13]:
        return DECODE_FAIL_MIC
    variant = (b[4] >> 6) & 0x3
    is_e6018 = variant != 2
    dcf77 = (((b[4] & 0x3F) << 26) | (b[5] << 18) | (b[6] << 10)
             | (b[7] << 2) | (b[8] >> 6))
    dcf77_str = "%4d-%02d-%02dT%02d:%02d:%02d" % (
        ((dcf77 >> 26) & 0x3F) + 2000, (dcf77 >> 22) & 0x0F,
        (dcf77 >> 17) & 0x1F, (dcf77 >> 12) & 0x1F,
        (dcf77 >> 6) & 0x3F, dcf77 & 0x3F)
    temp_raw = _s16(((b[8] & 0x0F) << 12) | (b[9] << 4))
    return [Event.make(
        ("model", "EMOS-E6018" if is_e6018 else "EMOS-E6016"),
        ("id", b[3], "House Code"),
        ("channel", ((b[8] >> 4) & 0x3) + 1, "Channel"),
        ("battery_ok", (b[12] >> 2) & 0x1, "Battery_OK"),
        ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature_C", "%.1f C"),
        ("humidity", b[10], "Humidity", "%u"),
        ("wind_avg_m_s", b[11] * 0.295, "WindSpeed m_s", "%.1f m/s")
        if not is_e6018 else None,
        ("wind_dir_deg", ((b[12] & 0xF0) >> 4) * 22.5, "Wind direction",
         "%.1f") if not is_e6018 else None,
        ("radio_clock", dcf77_str, "Radio Clock") if not is_e6018 else None,
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("inkbird_ith20r")
def inkbird_ith20r(bits, dev):
    """Inkbird ITH-20R (ref src/devices/inkbird_ith20r.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 187:
        return DECODE_ABORT_LENGTH
    preamble = bytes([0xAA, 0xAA, 0xAA, 0x2D, 0xD4])
    start = bits.search(0, 0, preamble, 40)
    if start == bits.bits_per_row[0]:
        return DECODE_FAIL_SANITY
    start += 40
    length = bits.bits_per_row[0] - start
    if (length + 7) // 8 < 19:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, min(length, 19 * 8)))
    msg += [0] * (19 - len(msg))
    crc_calc = util.crc16lsb(bytes(msg[:16]), 16, 0xA001, 0x86F4)
    if ((msg[17] << 8) | msg[16]) != crc_calc:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Inkbird-ITH20R"),
        ("id", (msg[9] << 8) | msg[8]),
        ("battery_ok", msg[7] * 0.01, "Battery level"),
        ("sensor_num", msg[4]),
        ("temperature_C", _s16((msg[11] << 8) | msg[10]) * 0.1,
         "Temperature", "%.1f C"),
        ("temperature_2_C", _s16((msg[13] << 8) | msg[12]) * 0.1,
         "Temperature2", "%.1f C"),
        ("humidity", ((msg[15] << 8) | msg[14]) * 0.1, "Humidity", "%.1f %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("rainpoint")
def rainpoint(bits, dev):
    """RainPoint soil sensor (ref src/devices/rainpoint.c)."""
    if (bits.num_rows != 1 or bits.bits_per_row[0] < 232
            or bits.bits_per_row[0] > 3000):
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0xA9]), 16)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    start += 16 - 2
    msg = BitBuffer()
    end = bits.manchester_decode(0, start, msg, 12 * 8)
    if end - start != 12 * 2 * 8:
        return DECODE_ABORT_LENGTH
    msg.invert()
    b = [util.reverse8(x) for x in _ints(msg.bb[0])]
    if (util.add_nibbles(bytes(b[:10]), 10) & 0xFF) != b[10]:
        return DECODE_FAIL_MIC
    flags = b[4]
    chan = {0x9F: 1, 0xB1: 2, 0xB7: 3}.get(flags, 0)
    return [Event.make(
        ("model", "RainPoint-Soil"),
        ("id", (b[2] << 8) | b[3], "", "%04x"),
        ("channel", chan),
        ("sync", (b[0] << 8) | b[1], "Sync?", "%04x"),
        ("flags", flags, "Flags?", "%02x"),
        ("status", (b[5] << 8) | b[6], "Status?", "%04x"),
        ("temperature_C", float(_s8(b[7])), "Temperature", "%.1f C"),
        ("moisture", b[8], "Moisture", "%d %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tfa_14_1504_v2")
def tfa_14_1504_v2(bits, dev):
    """TFA 14.1504.V2 grill thermometer (ref src/devices/tfa_14_1504_v2.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    available = bits.bits_per_row[0]
    if available < 64:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0x5C]), 24)
    available -= start
    if available < 24:
        return DECODE_ABORT_EARLY
    if available < 64 or available > 76:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, start + 24, 40))
    flags = b[0] >> 4
    if (flags & 0x5) == 0x5:
        return DECODE_FAIL_SANITY
    if b[2] != 0xFF:
        return DECODE_FAIL_SANITY
    calc_mic = util.lfsr_digest16(bytes(b[:3]), 3, 0x8810, 0x0D42) ^ 0x16EB
    if calc_mic != ((b[3] << 8) + b[4]):
        return DECODE_FAIL_MIC
    raw_temp = ((b[0] & 0xF) << 6) + (b[1] >> 2)
    is_connected = raw_temp != 0x1C0
    return [Event.make(
        ("model", "TFA-141504v2"),
        ("battery_ok", int((flags & 0x2) != 0), "Battery"),
        ("probe_fail", int(not is_connected), "Probe failure"),
        ("temperature_C", float(raw_temp - 532), "Temperature", "%.0f C")
        if is_connected else None,
        ("mic", "CRC", "Integrity"),
    )]

"""Fine Offset Electronics sensor family (ref src/devices/fineoffset.c)."""

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

_PREAMBLE = bytes([0xAA, 0x2D, 0xD4])


def _ints(b):
    return [int(x) for x in b]


@decoder("fineoffset_WH2")
def fineoffset_wh2(bits, dev):
    """Fineoffset WH2/WH2A/WH5/Telldus/TFA-303225 (ref src/devices/
    fineoffset.c:57-166): 48/55/47/49-bit PWM rows, CRC-8 poly 0x31."""
    n = bits.bits_per_row[0]
    b0 = int(bits.bb[0][0])
    b1 = int(bits.bb[0][1])
    if n == 48 and b0 == 0xFF:
        b = _ints(bits.extract_bytes(0, 8, 40)) + [0]
        model_num = 2
    elif n == 55 and b0 == 0xFE:
        b = _ints(bits.extract_bytes(0, 7, 48))
        model_num = 8 if b[3] == 0xFF else 3
    elif n == 47 and b0 == 0xFE:
        b = _ints(bits.extract_bytes(0, 7, 40)) + [0]
        model_num = 5
    elif n == 49 and b0 == 0xFF and (b1 & 0x80) == 0x80:
        b = _ints(bits.extract_bytes(0, 9, 40)) + [0]
        model_num = 7
    else:
        return DECODE_ABORT_LENGTH
    b = (b + [0] * 6)[:6]
    if b[4] != util.crc8(bytes(b[:4]), 4, 0x31, 0):
        return DECODE_FAIL_MIC
    if model_num == 8 and (sum(b[:5]) & 0xFF) != b[5]:
        return DECODE_FAIL_MIC
    if (b[0] >> 4) != 4:
        return DECODE_FAIL_SANITY
    id_ = ((b[0] & 0x0F) << 4) | ((b[1] & 0xF0) >> 4)
    temp = ((b[1] & 0x0F) << 8) | b[2]
    low_battery = 0
    if model_num == 8:
        low_battery = int((temp & 0x800) != 0)
        temp = (temp & 0x7FF) - 400
    elif model_num == 5:
        temp -= 400
    else:
        if temp & 0x800:
            temp = -(temp & 0x7FF)
    temperature = temp * 0.1
    if model_num == 5 and (temperature < -40.0 or temperature > 60.0):
        return DECODE_FAIL_SANITY
    humidity = b[3]
    model = {2: "Fineoffset-WH2", 3: "Fineoffset-WH2A", 5: "Fineoffset-WH5",
             7: "Fineoffset-TelldusProove", 8: "TFA-303225"}[model_num]
    return [Event.make(
        ("model", model),
        ("id", id_, "ID"),
        ("battery_ok", int(not low_battery), "Battery")
        if model_num == 8 else None,
        ("temperature_C", temperature, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%")
        if humidity != 0xFF else None,
        ("mic", "CRC", "Integrity"),
    )]


_UVI_UPPER = [432, 851, 1210, 1570, 2017, 2450, 2761, 3100, 3512, 3918,
              4277, 4650, 5029]


def _wh24_decode(bits):
    """Fineoffset WH24/WH65/WS69 (ref src/devices/fineoffset.c:309-449)."""
    n = bits.bits_per_row[0]
    if n < 190 or n > 268:
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, _PREAMBLE, 24) + 24
    if bit_offset + 17 * 8 > n:
        return DECODE_ABORT_LENGTH
    if n - bit_offset - 17 * 8 < 8:
        type_ = 24 if bit_offset < 61 else 65
    else:
        type_ = 65
    if n > 215:
        type_ = 69
    b = _ints(bits.extract_bytes(0, bit_offset, 25 * 8))
    if b[0] != 0x24:
        return DECODE_FAIL_SANITY
    if util.crc8(bytes(b[:16]), 16, 0x31, 0) != 0 or (sum(b[:16]) & 0xFF) != b[16]:
        return DECODE_FAIL_MIC
    pressure_hpa = -1.0
    if type_ == 69:
        pressure_raw = (b[17] << 16) | (b[18] << 8) | b[19]
        if util.crc8(bytes(b[:24]), 24, 0x31, 0) == 0 \
                and (sum(b[:24]) & 0xFF) == b[24] and pressure_raw < 0x01FFFF:
            pressure_hpa = pressure_raw * 0.01
    id_ = b[1]
    wind_dir = b[2] | ((b[3] & 0x80) << 1)
    low_battery = (b[3] & 0x08) >> 3
    temp_raw = ((b[3] & 0x07) << 8) | b[4]
    temperature = (temp_raw - 400) * 0.1
    humidity = b[5]
    wind_speed_raw = b[6] | ((b[3] & 0x10) << 4)
    wsf, rcc = (1.12, 0.3) if type_ == 24 else (0.51, 0.254)
    wind_speed_ms = wind_speed_raw * 0.125 * wsf
    gust_speed_raw = b[7]
    gust_speed_ms = gust_speed_raw * wsf
    rainfall_mm = ((b[8] << 8) | b[9]) * rcc
    uv_raw = (b[10] << 8) | b[11]
    light_raw = (b[12] << 16) | (b[13] << 8) | b[14]
    uv_index = 0
    while uv_index < 13 and _UVI_UPPER[uv_index] < uv_raw:
        uv_index += 1
    model = {24: "Fineoffset-WH24", 65: "Fineoffset-WH65B",
             69: "Fineoffset-WS69"}[type_]
    return [Event.make(
        ("model", model),
        ("id", id_, "ID"),
        ("battery_ok", int(not low_battery), "Battery"),
        ("temperature_C", temperature, "Temperature", "%.1f C")
        if temp_raw != 0x7FF else None,
        ("humidity", humidity, "Humidity", "%u %%")
        if humidity != 0xFF else None,
        ("pressure_hPa", pressure_hpa, "Pressure", "%.2f hPa")
        if pressure_hpa >= 0 else None,
        ("wind_dir_deg", wind_dir, "Wind direction")
        if wind_dir != 0x1FF else None,
        ("wind_avg_m_s", wind_speed_ms, "Wind speed", "%.1f m/s")
        if wind_speed_raw != 0x1FF else None,
        ("wind_max_m_s", gust_speed_ms, "Gust speed", "%.1f m/s")
        if gust_speed_raw != 0xFF else None,
        ("rain_mm", rainfall_mm, "Rainfall", "%.1f mm"),
        ("uv", uv_raw, "UV") if uv_raw != 0xFFFF else None,
        ("uvi", float(uv_index), "UV Index", "%.0f")
        if uv_raw != 0xFFFF else None,
        ("light_lux", light_raw * 0.1, "Light", "%.1f lux")
        if light_raw != 0xFFFFFF else None,
        ("mic", "CRC", "Integrity"),
    )]


def _wh0290_decode(bits):
    """Fineoffset WH0290 air quality (ref src/devices/fineoffset.c:524-573)."""
    bit_offset = bits.search(0, 0, _PREAMBLE, 24) + 24
    if bit_offset + 64 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bit_offset, 64))
    if util.crc8(bytes(b[:6]), 6, 0x31, 0) != b[6] \
            or (sum(b[:7]) & 0xFF) != b[7]:
        return DECODE_FAIL_MIC
    pm25 = ((b[2] & 0x3F) << 8) | b[3]
    pm100 = ((b[4] & 0x3F) << 8) | b[5]
    battery_bars = ((b[2] & 0x40) >> 4) | ((b[4] & 0xC0) >> 6)
    return [Event.make(
        ("model", "Fineoffset-WH0290"),
        ("id", b[1], "ID"),
        ("battery_ok", battery_bars * 0.2, "Battery level", "%.1f"),
        ("pm2_5_ug_m3", pm25 // 10, "2.5um Fine Particulate Matter",
         "%d ug/m3"),
        ("estimated_pm10_0_ug_m3", pm100 // 10,
         "Estimate of 10um Coarse Particulate Matter", "%d ug/m3"),
        ("family", b[0], "FAMILY"),
        ("unknown1", 1 if (b[2] & 0x80) else 0, "UNKNOWN1"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_WH25")
def fineoffset_wh25(bits, dev):
    """Fineoffset WH25/WH32/WH32B (ref src/devices/fineoffset.c:604-694),
    dispatching to WH24/WH65 and WH0290 by packet length."""
    n = bits.bits_per_row[0]
    type_ = 25
    if n < 160:
        return _wh0290_decode(bits)
    elif n < 190:
        type_ = 32
    elif n < 440:
        return _wh24_decode(bits)
    if n > 510:
        type_ = 32
    bit_offset = bits.search(0, 0, _PREAMBLE, 24) + 24
    if bit_offset + 64 > n:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bit_offset, 64))
    msg_type = b[0] & 0xF0
    if type_ == 32 and msg_type == 0xD0:
        type_ = 31
    elif msg_type != 0xE0:
        if b[0] == 0x41:
            return _wh0290_decode(bits)
        return DECODE_ABORT_EARLY
    if (sum(b[:6]) & 0xFF) != b[6]:
        return DECODE_FAIL_MIC
    bitsum = util.xor_bytes(bytes(b[:6]), 6)
    bitsum = ((bitsum & 0x0F) << 4) | (bitsum >> 4)
    if type_ == 25 and bitsum != b[7]:
        return DECODE_FAIL_MIC
    id_ = ((b[0] & 0x0F) << 4) | (b[1] >> 4)
    low_battery = (b[1] & 0x08) >> 3
    temp_raw = ((b[1] & 0x03) << 8) | b[2]
    pressure_raw = (b[4] << 8) | b[5]
    model = {31: "Fineoffset-WH32", 32: "Fineoffset-WH32B",
             25: "Fineoffset-WH25"}[type_]
    return [Event.make(
        ("model", model),
        ("id", id_, "ID"),
        ("battery_ok", int(not low_battery), "Battery"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[3], "Humidity", "%u %%"),
        ("pressure_hPa", pressure_raw * 0.1, "Pressure", "%.1f hPa")
        if pressure_raw != 0xFFFF else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_WH51")
def fineoffset_wh51(bits, dev):
    """Fineoffset/Ecowitt WH51 soil moisture (ref src/devices/
    fineoffset.c:736-839)."""
    if bits.bits_per_row[0] < 120:
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, _PREAMBLE, 24) + 24
    if bit_offset + 14 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bit_offset, 14 * 8))
    if b[0] != 0x51:
        return DECODE_ABORT_EARLY
    if (sum(b[:13]) & 0xFF) != b[13]:
        return DECODE_FAIL_MIC
    if util.crc8(bytes(b[:12]), 12, 0x31, 0) != b[12]:
        return DECODE_FAIL_MIC
    battery_mv_bits = b[4] & 0x1F
    if battery_mv_bits >= 16:
        battery_level = 1.0
    elif battery_mv_bits == 15:
        battery_level = 0.9
    elif battery_mv_bits == 14:
        battery_level = 0.5
    elif battery_mv_bits == 13:
        battery_level = 0.1
    else:
        battery_level = 0.0
    return [Event.make(
        ("model", "Fineoffset-WH51"),
        ("id", "%02x%02x%02x" % (b[1], b[2], b[3]), "ID"),
        ("battery_ok", battery_level, "Battery level"),
        ("battery_mV", battery_mv_bits * 100, "Battery", "%d mV"),
        ("moisture", b[6], "Moisture", "%u %%"),
        ("boost", (b[4] & 0xE0) >> 5, "Transmission boost"),
        ("ad_raw", ((b[7] & 0x01) << 8) | b[8], "AD raw"),
        ("mic", "CRC", "Integrity"),
    )]


def _alecto_ws1200v1(bits):
    """Alecto-WS1200v1 (ref src/devices/fineoffset.c:866-907)."""
    if bits.bits_per_row[0] != 63 or (int(bits.bb[0][0]) >> 1) != 0x7F \
            or (int(bits.bb[0][1]) >> 5) != 0x3:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 7, 56))
    if util.crc8(bytes(b[:7]), 7, 0x31, 0):
        return DECODE_FAIL_MIC
    return _ws1200_event("Alecto-WS1200v1", b)


def _ws1200_event(model, b):
    id_ = ((b[0] & 0x0F) << 4) | (b[1] >> 4)
    battery_low = (b[1] >> 3) & 0x1
    temp_raw = ((b[1] & 0x7) << 8) | b[2]
    rainfall = ((b[4] << 8) | b[3]) * 0.3
    return [Event.make(
        ("model", model),
        ("id", id_, "ID"),
        ("battery_ok", int(not battery_low), "Battery"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C"),
        ("rain_mm", rainfall, "Rain", "%.1f mm"),
        ("mic", "CRC", "Integrity"),
    )]


def _alecto_ws1200v2_dcf(bits):
    """Alecto-WS1200v2 DCF77 (ref src/devices/fineoffset.c:937-990)."""
    if bits.bits_per_row[0] != 95 or (int(bits.bb[0][0]) >> 1) != 0x7F \
            or (int(bits.bb[0][1]) >> 1) != 0x52:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 7, 88))
    if util.crc8(bytes(b[:10]), 10, 0x31, 0):
        return DECODE_FAIL_MIC
    if (sum(b[:10]) - b[10]) & 0xFF:
        return DECODE_FAIL_MIC
    clock_str = "%04x-%02x-%02xT%02x:%02x:%02x" % (
        b[4] + 0x2000, b[5], b[6], b[7], b[8], b[9])
    return [Event.make(
        ("model", "Alecto-WS1200v2"),
        ("id", b[1], "ID"),
        ("battery_ok", int(not ((b[2] >> 7) & 0x1)), "Battery"),
        ("radio_clock", clock_str, "Radio Clock"),
        ("mic", "CRC", "Integrity"),
    )]


def _alecto_ws1200v2(bits):
    """Alecto-WS1200v2 (ref src/devices/fineoffset.c:1018-1065)."""
    if bits.bits_per_row[0] != 95 or (int(bits.bb[0][0]) >> 1) != 0x7F \
            or (int(bits.bb[0][1]) >> 5) != 0x3:
        return _alecto_ws1200v2_dcf(bits)
    b = _ints(bits.extract_bytes(0, 7, 88))
    if util.crc8(bytes(b[:7]), 7, 0x31, 0):
        return DECODE_FAIL_MIC
    if (sum(b[:7]) - b[7]) & 0xFF:
        return DECODE_FAIL_MIC
    return _ws1200_event("Alecto-WS1200v2", b)


@decoder("fineoffset_WH0530")
def fineoffset_wh0530(bits, dev):
    """Fineoffset WH0530 temperature/rain (ref src/devices/
    fineoffset.c:1087-1138), with Alecto WS-1200 fallbacks."""
    n = bits.bits_per_row[0]
    if n == 63:
        return _alecto_ws1200v1(bits)
    if n == 95:
        return _alecto_ws1200v2(bits)
    if n != 71:
        return DECODE_ABORT_LENGTH
    if (int(bits.bb[0][0]) >> 1) != 0x7F or (int(bits.bb[0][1]) >> 5) != 0x3:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, 7, 64))
    if util.crc8(bytes(b[:7]), 7, 0x31, 0) or ((sum(b[:7]) & 0xFF) - b[7]):
        return DECODE_FAIL_MIC
    return _ws1200_event("Fineoffset-WH0530", b)

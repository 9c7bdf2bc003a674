"""LaCrosse family, part 2 (reference files cited per function):
TX31U-IT, TX22U-IT (FSK + OOK), WS6868 TX232TH / TX231RW.
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


@decoder("lacrosse_tx31u")
def lacrosse_tx31u(bits, dev):
    """LaCrosse TX31U-IT (ref src/devices/lacrosse_tx31u.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    msg_bytes = (bits.bits_per_row[0] - start) // 8
    if msg_bytes < 9 or msg_bytes > 20:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, msg_bytes * 8))
    sensor_id = ((msg[4] & 0xF) << 2) | ((msg[5] >> 6) & 3)
    no_ext_sensor = (msg[5] >> 4) & 1
    battery_low = (msg[5] >> 3) & 1
    measurements = msg[5] & 7
    expected = 6 + measurements * 2 + 1
    if msg_bytes < expected:
        return DECODE_ABORT_LENGTH
    if msg[expected - 1] != util.crc8(bytes(msg[4:6 + measurements * 2]),
                                      2 + measurements * 2, 0x31, 0x00):
        return DECODE_FAIL_MIC
    items = [
        ("model", "LaCrosse-TX31UIT"),
        ("id", sensor_id, ""),
        ("battery_ok", int(not battery_low), "Battery"),
    ]
    for m in range(measurements):
        mtype = (msg[6 + m * 2] >> 4) & 0xF
        nib1 = msg[6 + m * 2] & 0xF
        nib2 = (msg[7 + m * 2] >> 4) & 0xF
        nib3 = msg[7 + m * 2] & 0xF
        if mtype == 0:
            items.append(("temperature_C",
                          10 * nib1 + nib2 + 0.1 * nib3 - 40.0,
                          "Temperature", "%.1f C"))
        elif mtype == 1:
            items.append(("humidity", 100 * nib1 + 10 * nib2 + nib3,
                          "Humidity", "%u %%"))
        elif mtype == 2:
            raw_rain = (nib1 << 8) + (nib2 << 4) + nib3
            if not no_ext_sensor and raw_rain > 0:
                items.append(("rain", raw_rain, "raw_rain", "%03x"))
        elif mtype == 3:
            if not no_ext_sensor:
                items.append(("wind_dir_deg", nib1 * 22.5,
                              "Wind direction", "%.1f"))
                items.append(("wind_avg_km_h",
                              ((nib2 << 4) + nib3) * 0.1 * 3.6,
                              "Wind speed", "%.1f km/h"))
        elif mtype == 4:
            if not no_ext_sensor and not (nib1 & 1):
                items.append(("wind_max_km_h",
                              ((nib2 << 4) + nib3) * 0.1 * 3.6,
                              "Wind gust", "%.1f km/h"))
    items.append(("mic", "CRC", "Integrity"))
    return [Event.make(*items)]


def _tx22uit_decode(bits):
    """LaCrosse TX22U-IT (ref src/devices/lacrosse_tx22uit.c)."""
    offset = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32)
    if offset >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    offset += 32
    size = min(bits.bits_per_row[0] - offset, 64 * 8)
    b = _ints(bits.extract_bytes(0, offset, size))
    b += [0] * (64 - len(b))
    size //= 8
    quartets = 0
    for n in (5, 3, 2, 1):
        data_len = 2 + 2 * n
        if data_len + 2 <= size and util.crc8(bytes(b[:data_len]),
                                              data_len, 0x31,
                                              0x00) == b[data_len]:
            quartets = n
            break
    if not quartets:
        return DECODE_FAIL_MIC
    raw_temp = -1
    humidity = -1
    raw_speed = -1
    direction = -1
    rain_mm = -1.0
    wind_gust_kmh = -1.0
    recognized = 0
    for i in range(quartets):
        p = 2 + i * 2
        t = b[p] >> 4
        if t == 0:
            raw_temp = ((b[p] & 0xF) * 100 + (b[p + 1] >> 4) * 10
                        + (b[p + 1] & 0xF))
            recognized += 1
        elif t == 1:
            humidity = ((b[p] & 0xF) * 100 + (b[p + 1] >> 4) * 10
                        + (b[p + 1] & 0xF))
            recognized += 1
        elif t == 2:
            rain_mm = 0.5180 * (((b[p] & 0xF) << 8) | b[p + 1])
            recognized += 1
        elif t == 3:
            direction = int((b[p] & 0xF) * 22.5)
            raw_speed = b[p + 1]
            recognized += 1
        elif t == 4:
            wind_gust_kmh = (((b[p] & 0xF) << 8) | b[p + 1]) * 0.1
            recognized += 1
    if recognized == 0:
        return DECODE_FAIL_SANITY
    temp_c = (raw_temp - 400) * 0.1
    speed_kmh = raw_speed * 0.1
    return [Event.make(
        ("model", "LaCrosse-TX22UIT"),
        ("id", b[0], "Sensor ID", "%02x"),
        ("flags", b[1], "Flags", "%02x"),
        ("temperature_C", temp_c, "Temperature", "%.1f C")
        if -40.0 < temp_c <= 70.0 else None,
        ("humidity", humidity, "Humidity", "%u %%")
        if 0 < humidity <= 100 else None,
        ("rain_mm", rain_mm, "Rainfall", "%.2f mm")
        if 0.0 <= rain_mm <= 0xFFF * 0.5180 else None,
        ("wind_avg_km_h", speed_kmh, "Wind speed", "%.1f km/h")
        if 0.0 <= speed_kmh <= 200.0 else None,
        ("wind_gust_km_h", wind_gust_kmh, "Wind gust", "%.1f km/h")
        if 0.0 <= wind_gust_kmh <= 200.0 else None,
        ("wind_dir_deg", direction, "Wind direction")
        if 0 <= direction <= 360 else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_tx22uit")
def lacrosse_tx22uit(bits, dev):
    """LaCrosse TX22U-IT FSK (ref src/devices/lacrosse_tx22uit.c)."""
    return _tx22uit_decode(bits)


@decoder("lacrosse_tx22uit_ook")
def lacrosse_tx22uit_ook(bits, dev):
    """LaCrosse TX22U-IT OOK variant
    (ref src/devices/lacrosse_tx22uit.c)."""
    bits.invert()
    return _tx22uit_decode(bits)


_WS6868_PRE = bytes([0xD2, 0xAA, 0x2D, 0xD4])


@decoder("lacrosse_ws6868_tx232th")
def lacrosse_ws6868_tx232th(bits, dev):
    """LaCrosse WS6868 TX232TH-LCD (ref src/devices/lacrosse_ws6868.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, _WS6868_PRE, 32)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    pos += 32
    if bits.bits_per_row[0] - pos < 64:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 64))
    if util.crc8(bytes(b[:7]), 7, 0x31, 0x00) != b[7]:
        return DECODE_FAIL_MIC
    temp_raw = (b[4] << 4) | (b[5] >> 4)
    return [Event.make(
        ("model", "LaCrosse-TX232TH"),
        ("id", (b[0] << 16) | (b[1] << 8) | b[2], "", "%06x"),
        ("channel", ((b[3] >> 4) & 3) + 1, "Channel"),
        ("battery_ok", int(not ((b[3] >> 7) & 1)), "Battery"),
        ("test", (b[3] >> 6) & 1, "Test"),
        ("counter", (b[3] >> 1) & 7, "Counter"),
        ("temperature_C", (temp_raw - 500) * 0.1, "Temperature", "%.1f C"),
        ("humidity", ((b[5] & 0x0F) << 8) | b[6], "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_ws6868_tx231rw")
def lacrosse_ws6868_tx231rw(bits, dev):
    """LaCrosse WS6868 TX231RW (ref src/devices/lacrosse_ws6868.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, _WS6868_PRE, 32)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    pos += 32
    if bits.bits_per_row[0] - pos < 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 96))
    if (util.crc8(bytes(b[:10]), 10, 0x31, 0x00) != b[10]
            or (util.add_bytes(bytes(b[:11])) & 0xFF) != b[11]):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "LaCrosse-TX231RW"),
        ("id", (b[0] << 16) | (b[1] << 8) | b[2], "", "%06x"),
        ("channel", ((b[3] >> 4) & 3) + 1, "Channel"),
        ("battery_ok", int(not ((b[3] >> 7) & 1)), "Battery"),
        ("test", (b[3] >> 6) & 1, "Test"),
        ("counter", (b[3] >> 1) & 7, "Counter"),
        ("data_raw", "".join("%02x" % x for x in b[4:10]),
         "Undecoded data"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

"""Weather/utility batch 3 (reference files cited per function):
Klimalogg, WS2032, Missil ML0757, TFA Drop, Holman WS5029 (PCM/PWM),
Archos TBH, Norgo NGE101, LaCrosse WS7000.
"""

from __future__ import annotations

from ..bits import util
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


@decoder("klimalogg")
def klimalogg(bits, dev):
    """TFA Klimalogg Pro 30.3180/30.3181 (ref src/devices/klimalogg.c)."""
    if bits.bits_per_row[0] < 11 * 8:
        return DECODE_ABORT_LENGTH
    off = bits.search(0, 0, bytes([0xB4, 0x2B]), 16) + 16
    if off + 9 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, off, 9 * 8))
    if b[7] != 0x6A:  # 0x56 bit-reflected
        return DECODE_FAIL_SANITY
    b = [util.reverse8(x) for x in b]
    if util.crc8(bytes(b), 9, 0x31, 0):
        return DECODE_FAIL_MIC
    temp_raw = (b[2] & 0x0F) * 100 + (b[3] >> 4) * 10 + (b[3] & 0x0F)
    humidity = b[4] & 0x7F
    if humidity == 0x6A:
        humidity = 100
    return [Event.make(
        ("model", "Klimalogg-Pro"),
        ("id", ((b[0] & 0x7F) << 8) | b[1], "Id", "%04x"),
        ("battery_ok", int(not ((b[5] & 0x80) >> 7)), "Battery"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity"),
        ("sequence_nr", (b[6] & 0xF0) >> 4, "Sequence Number"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ws2032")
def ws2032(bits, dev):
    """WS2032 weather station (ref src/devices/ws2032.c)."""
    row = bits.find_repeated_row(2, 14 * 8)
    if row < 0:
        return DECODE_ABORT_EARLY
    offset = bits.search(row, 0, bytes([0x0A]), 8)
    if offset + 14 * 8 > bits.bits_per_row[row]:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.extract_bytes(row, offset, 14 * 8))
    total = util.add_bytes(bytes(b[:12]), 12)
    if total == 0:
        return DECODE_FAIL_SANITY
    if (total & 0xFF) != b[12]:
        return DECODE_FAIL_MIC
    if util.crc8(bytes(b[:14]), 14, 0x31, 0x00):
        return DECODE_FAIL_MIC
    temp_sign = -1 if (b[4] & 0x08) else 1
    temp_raw = ((b[4] & 0x07) << 8) | b[5]
    return [Event.make(
        ("model", "WS2032"),
        ("id", (b[1] << 8) | b[2], "Station ID", "%04X"),
        ("battery_ok", int(not (b[3] & 0x01)), "Battery"),
        ("temperature_C", temp_sign * temp_raw * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[6], "Humidity", "%u %%"),
        ("wind_dir_deg", (b[4] >> 4) * 22.5, "Wind Direction", "%.1f"),
        ("wind_avg_km_h", b[7] * 0.43 * 3.6, "Wind avg speed", "%.1f km/h"),
        ("wind_max_km_h", b[8] * 0.43 * 3.6, "Wind gust", "%.1f km/h"),
        ("rain", (b[9] << 16) | (b[10] << 8) | b[11], "Rain tips"),
        ("flags", b[3] & 0xFE, "Flags", "%02x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("missil_ml0757")
def missil_ml0757(bits, dev):
    """Missil ML0757 weather station (ref src/devices/missil_ml0757.c)."""
    r = bits.find_repeated_row(5, 40)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] > 0:
        return DECODE_ABORT_EARLY  # first row must be empty
    if bits.bits_per_row[r] > 40:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if (b[4] & 0x0F) != 0x0F:
        return DECODE_ABORT_EARLY
    f12bit = ((b[2] << 4) | (b[3] >> 4)) & 0xFFF
    f8bit = (((b[3] & 0x0F) << 4) | (b[4] >> 4)) & 0xFF
    flag_bat = b[1] & 0x80
    if b[1] & 0x04:  # rain + wind packet
        wind_kph = {0x00: 0.0, 0x80: 1.4, 0xC0: 2.8}.get(f8bit,
                                                         (f8bit + 2) * 1.4)
        return [Event.make(
            ("model", "Missil-ML0757"),
            ("id", b[0], "ID"),
            ("battery_ok", int(not flag_bat), "Battery"),
            ("rain_mm", f12bit * 0.45, "Total rain", "%.2f mm"),
            ("wind_avg_km_h", wind_kph, "Wind speed", "%.2f km/h"),
        )]
    if f12bit & 0x800:
        temp_c = (0x1000 - f12bit) * -0.1
    else:
        temp_c = f12bit * 0.1
    return [Event.make(
        ("model", "Missil-ML0757"),
        ("id", b[0], "ID"),
        ("battery_ok", int(not flag_bat), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
    )]


@decoder("tfa_drop_303233")
def tfa_drop_303233(bits, dev):
    """TFA Drop 30.3233.01 rain gauge (ref src/devices/tfa_drop_30.3233.c)."""
    bits.invert()
    row = bits.find_repeated_row(2, 66)
    if row < 0 or bits.bits_per_row[row] > 66 + 16:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if (b[0] & 0xF0) != 0x30:
        return DECODE_ABORT_EARLY
    if b[7] != util.lfsr_digest8_reflect(bytes(b[:7]), 7, 0x31, 0xF4):
        return DECODE_FAIL_MIC
    rain_counter = (((b[6] << 8) | b[4]) + 10) & 0xFFFF
    return [Event.make(
        ("model", "TFA-Drop"),
        ("id", ((b[0] & 0x0F) << 16) | (b[1] << 8) | b[2], "", "%5x"),
        ("battery_ok", int(not ((b[3] & 0x80) >> 7)), "Battery"),
        ("rain_mm", rain_counter * 0.254, "Rain total", "%.1f mm"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_HOLMAN_DIRS = [0, 23, 45, 68, 90, 113, 135, 158,
                180, 203, 225, 248, 270, 293, 315, 338]


@decoder("holman_ws5029pcm")
def holman_ws5029pcm(bits, dev):
    """AOK / Holman WS5029 weather station, PCM (ref
    src/devices/holman_ws5029.c:100-230)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    nbits = bits.bits_per_row[0]
    if nbits < 192:
        return DECODE_ABORT_LENGTH
    preamble = bytes([0xAA, 0xAA, 0xAA, 0x98, 0xF3, 0xA5])
    pos = bits.search(0, 0, preamble, 48)
    if pos >= nbits:
        return DECODE_ABORT_EARLY
    pos += 48
    b = _ints(bits.extract_bytes(0, pos, 18 * 8))
    chk_calc = util.xor_bytes(bytes(b[:12]), 12)
    if util.lfsr_digest8_reflect(bytes([chk_calc]), 1, 0x00, 0x31) != b[12]:
        return DECODE_FAIL_MIC
    device_id = (b[0] << 8) | b[1]
    temp_c = (_s16((b[2] << 8) | (b[3] & 0xF0)) >> 4) * 0.1
    humidity = ((b[3] & 0x0F) << 4) | ((b[4] & 0xF0) >> 4)
    rain_raw = ((b[4] & 0x0F) << 8) | b[5]
    direction_deg = _HOLMAN_DIRS[(b[7] & 0xF0) >> 4]
    light_lux = ((b[8] & 0x7F) << 10) | (b[9] << 2) | ((b[10] & 0xC0) >> 6)
    if nbits < 200 and light_lux == 0:
        return [Event.make(
            ("model", "Holman-WS5029"),
            ("id", device_id, "Station ID", "%04X"),
            ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("rain_mm", rain_raw * 0.79, "Total rainfall", "%.1f mm"),
            ("wind_avg_km_h", float(b[6]), "Wind avg speed", "%.1f km/h"),
            ("wind_dir_deg", direction_deg, "Wind Direction"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if nbits < 221:
        uv_index = ((b[7] & 0x07) << 1) | ((b[8] & 0x80) >> 7)
        battery_low = (b[10] & 0x30) >> 4
        return [Event.make(
            ("model", "AOK-5056"),
            ("id", device_id, "Station ID", "%04X"),
            ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("rain_mm", rain_raw * 1.0, "Total rainfall", "%.1f mm"),
            ("wind_avg_km_h", float(b[6]), "Wind avg speed", "%.1f km/h"),
            ("wind_dir_deg", direction_deg, "Wind Direction"),
            ("uvi", float(uv_index), "UV Index", "%.0f"),
            ("light_lux", light_lux, "Lux", "%u"),
            ("counter", ((b[10] & 0x0F) << 8) | b[11], "Counter", "%u"),
            ("battery_ok", int(not battery_low), "battery", "%u"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return DECODE_FAIL_OTHER


def _xor_shift_bytes(message, num_bytes, shift_up):
    """ref src/devices/holman_ws5029.c:255-271."""
    result0 = 0
    for i in range(0, num_bytes, 2):
        result0 ^= message[i]
    result1 = 0
    for i in range(1, num_bytes, 2):
        result1 ^= message[i]
    resultx = 0
    for j in range(7):
        if shift_up & (1 << j):
            resultx ^= (result0 << (j + 1)) & 0xFF
    return (result0 ^ result1 ^ resultx) & 0xFF


@decoder("holman_ws5029pwm", "holman_ws5029pwm_ook")
def holman_ws5029pwm(bits, dev):
    """Holman WS5029 weather station, PWM (ref
    src/devices/holman_ws5029.c:280-340)."""
    r = bits.find_repeated_row(3, 96)
    if r < 0 or bits.bits_per_row[r] != 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if b[0] != 0x55 or b[1] != 0x5A or b[2] != 0x67:
        return DECODE_FAIL_SANITY
    bits.invert()
    b = _ints(bits.bb[r])
    if _xor_shift_bytes(b, 10, 0x18) != b[10]:
        return DECODE_FAIL_MIC
    temp_c = (_s16(((b[4] & 0x0F) << 12) | (b[5] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Holman-WS5029"),
        ("id", b[3]),
        ("battery_ok", int(not (b[4] & 0x80)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", b[6], "Humidity", "%u %%"),
        ("rain_mm", ((b[7] << 4) + (b[8] >> 4)) * 0.79, "Total rainfall",
         "%.1f mm"),
        ("wind_avg_km_h", float(((b[8] & 0xF) << 4) + (b[9] >> 4)),
         "Wind avg speed", "%.1f km/h"),
        ("wind_dir_deg", int((b[9] & 0xF) * 22.5), "Wind Direction"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_ARCHOS_INFO = [0x19, 0xF8, 0x28, 0x30, 0x6D, 0x0C, 0x94, 0x54,
                0x22, 0xF2, 0x37, 0xC9, 0x66, 0xA3, 0x97, 0x57]


@decoder("archos_tbh")
def archos_tbh(bits, dev):
    """Archos TBH devices (ref src/devices/archos_tbh.c)."""
    preamble = bytes([0xAA, 0xAA, 0xD3, 0x91, 0xD3, 0x91])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, preamble, 48)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 12 * 8:
        return DECODE_ABORT_LENGTH
    length = int(bits.extract_bytes(0, start + 48, 8)[0])
    if length > 60:
        return DECODE_ABORT_LENGTH
    frame = [length] + _ints(bits.extract_bytes(0, start + 56,
                                                (length + 2) * 8))
    frame += [0] * (63 - len(frame))
    crc = util.crc16(bytes(frame[:length + 1]), length + 1, 0x8005, 0xFFFF)
    if ((frame[length + 1] << 8) | frame[length + 2]) != crc:
        return DECODE_FAIL_MIC
    payload = [frame[1] ^ _ARCHOS_INFO[0]]
    for i in range(1, length):
        payload.append(frame[i] ^ frame[i + 1] ^ _ARCHOS_INFO[i % 16])
    payload += [0] * (62 - len(payload))
    msg_type = payload[4]
    dev_id = (payload[0] | (payload[1] << 8) | (payload[2] << 16)
              | (payload[3] << 24))
    dev_id = ((dev_id & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    if msg_type == 1:
        payload[4] = length - 4
        if util.crc8(bytes(payload[4:4 + length - 5]), length - 5,
                     0x07, 0x00) != payload[length - 1]:
            return DECODE_FAIL_MIC
        return [Event.make(
            ("model", "Archos-TBH"),
            ("id", dev_id, "Station ID", "%08X"),
            ("power_idx", (payload[6] << 16) | (payload[7] << 8) | payload[8],
             "Power index", "%d"),
            ("power_max", (payload[12] << 8) | payload[13], "Power max", "%d"),
            ("timestamp", ((payload[9] << 16) | (payload[10] << 8)
                           | payload[11]) // 8, "Timestamp", "%d s"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 2:
        temp_raw = ((payload[6] << 8) | payload[5]) - 2732
        return [Event.make(
            ("model", "Archos-TBH"),
            ("id", dev_id, "Station ID", "%08X"),
            ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
            ("humidity", payload[7], "Humidity", "%d %%"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 3:
        return [Event.make(
            ("model", "Archos-TBH"),
            ("id", dev_id, "Station ID", "%08X"),
            ("battery_ok", payload[5] * 0.01, "Battery level", "%0.2f"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 4:
        return [Event.make(
            ("model", "Archos-TBH"),
            ("id", dev_id, "Station ID", "%08X"),
            ("battery_ok", 0, "Battery level"),
            ("mic", "CRC", "Integrity"),
        )]
    return DECODE_FAIL_SANITY


_NORGO_TAPS = [0x4880, 0, 0, 0, 0, 0, 0, 0,
               0x2080, 0x4000, 0x4000, 0x4000, 0x4000, 0x4000, 0x4000]


def _norgo_checksum(data, datalen):
    """ref src/devices/norgo.c:70-100."""
    mask = 0x0001
    chks = 0
    for i in range(datalen - 1, 7, -1):
        n_mask = mask >> 1
        for j in range(15):
            if mask & (1 << j):
                n_mask ^= _NORGO_TAPS[j]
        mask = n_mask
        if (data[i // 8] >> (i % 8)) & 1:
            chks ^= mask
    return (chks >> 8) & 0xFF


@decoder("norgo")
def norgo(bits, dev):
    """Norgo NGE101 energy meter (ref src/devices/norgo.c)."""
    nbits = bits.bits_per_row[0]
    if nbits not in (55, 56, 71, 72):
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if b[0] != (~0xFA & 0xFF):
        return DECODE_ABORT_EARLY
    nb = (nbits - 15) // 8
    if util.xor_bytes(bytes(b[1:1 + nb]), nb) != 0xFF:
        return DECODE_FAIL_MIC
    bits.invert()
    b = _ints(bits.bb[0])
    n = (nbits + 1) // 8
    b = [util.reverse8(x) for x in b[:n]] + b[n:] + [0, 0]
    device_id = ((b[1] & 0xF0) >> 4) | ((b[2] & 0x0F) << 4)
    channel = ((b[1] & 0x0E) >> 1) + 1
    if (b[1] & 0x1) == 0:
        if _norgo_checksum(b, 5 * 8) != b[6]:
            return DECODE_FAIL_MIC
        impulse_gap = (b[2] >> 4) | (b[3] << 4) | ((b[4] & 0x7F) << 12)
        return [Event.make(
            ("model", "Norgo-NGE101"),
            ("id", device_id, "Device ID"),
            ("channel", channel, "Channel"),
            ("gap", impulse_gap, "Impulse gap"),
            ("mic", "CRC", "Integrity"),
        )]
    if _norgo_checksum(b, 7 * 8) != b[8]:
        return DECODE_FAIL_MIC
    impulses = ((b[2] >> 4) | (b[3] << 4) | (b[4] << 12) | (b[5] << 20)
                | ((b[6] & 0x3F) << 28))
    impulses = ((impulses & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return [Event.make(
        ("model", "Norgo-NGE101"),
        ("id", device_id, "Id"),
        ("channel", channel, "Channel"),
        ("impulses", impulses, "Impulses"),
        ("battery_ok", int(not ((b[6] & 0x40) >> 6)), "Battery"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_ws7000")
def lacrosse_ws7000(bits, dev):
    """LaCrosse WS7000/WS2500 sensors (ref src/devices/lacrosse_ws7000.c)."""
    start = bits.search(0, 0, bytes([0x01]), 8) + 8
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    max_bits = min(14 * 5, bits.bits_per_row[0] - start)
    b = list(util.extract_nibbles_4b1s(bits.row_bytes(0).tobytes(), start,
                                       max_bits))
    length = len(b)
    if length < 7:
        return DECODE_ABORT_LENGTH
    b = [int(x) for x in util.reflect_nibbles(bytes(b))]
    mtype = b[0]
    addr = b[1] & 0x7
    dev_id = (mtype << 4) | addr
    if mtype > 5:
        return DECODE_ABORT_EARLY
    data_size = [3, 6, 3, 6, 10, 7]
    if length < data_size[mtype]:
        return DECODE_ABORT_LENGTH
    if util.xor_bytes(bytes(b[:length - 1]), length - 1):
        return DECODE_FAIL_MIC
    if ((util.add_bytes(bytes(b[:length - 1]), length - 1) + 5) & 0xF) != b[length - 1]:
        return DECODE_FAIL_MIC
    if mtype == 0:
        sign = -1 if (b[1] & 0x8) else 1
        return [Event.make(
            ("model", "LaCrosse-WS700027"),
            ("id", dev_id),
            ("channel", addr),
            ("temperature_C", (b[4] * 10 + b[3] + b[2] * 0.1) * sign,
             "Temperature", "%.1f C"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if mtype == 1:
        sign = -1 if (b[1] & 0x8) else 1
        return [Event.make(
            ("model", "LaCrosse-WS700022"),
            ("id", dev_id),
            ("channel", addr),
            ("temperature_C", (b[4] * 10 + b[3] + b[2] * 0.1) * sign,
             "Temperature", "%.1f C"),
            ("humidity", int(b[7] * 10 + b[6] + b[5] * 0.1), "Humidity"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if mtype == 2:
        rain = (b[4] << 8) | (b[3] << 4) | b[2]
        return [Event.make(
            ("model", "LaCrosse-WS700016"),
            ("id", dev_id),
            ("channel", addr),
            ("rain_mm", rain * 0.3, "Rain counter", "%.1f mm"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if mtype == 3:
        return [Event.make(
            ("model", "LaCrosse-WS700015"),
            ("id", dev_id),
            ("channel", addr),
            ("wind_avg_km_h", b[4] * 10 + b[3] + b[2] * 0.1,
             "Wind speed", "%.1f km/h"),
            ("wind_dir_deg", float((b[7] >> 2) * 100 + b[6] * 10 + b[5]),
             "Wind direction"),
            ("wind_dev_deg", (b[7] & 0x3) * 22.5, "Wind deviation"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if mtype == 4:
        sign = -1 if (b[1] & 0x8) else 1
        return [Event.make(
            ("model", "LaCrosse-WS700020"),
            ("id", dev_id),
            ("channel", addr),
            ("temperature_C", (b[4] * 10 + b[3] + b[2] * 0.1) * sign,
             "Temperature", "%.1f C"),
            ("humidity", int(b[7] * 10 + b[6] + b[5] * 0.1), "Humidity"),
            ("pressure_hPa", b[10] * 100 + b[9] * 10 + b[8] + 200, "Pressure"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    brightness = b[4] * 100 + b[3] * 10 + b[2]
    brightness *= 10 ** b[5]
    return [Event.make(
        ("model", "LaCrosse-WS250019"),
        ("id", dev_id),
        ("channel", addr),
        ("light_lux", brightness, "Brightness"),
        ("exposure_mins", b[8] * 100 + b[7] * 10 + b[6], "Exposition"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

"""LaCrosse Technology sensor decoders (beyond the TX29/TX35 in
protocols.py): TX nybble sensors, TX141x family, LTV FSK family."""

from __future__ import annotations

from ..bits import util
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_OTHER,
    DECODE_FAIL_SANITY,
    decoder,
)

_LTV_PREAMBLE = bytes([0xD2, 0xAA, 0x2D, 0xD4])


def _ints(b):
    return [int(x) for x in b]


@decoder("lacrossetx")
def lacrossetx(bits, dev):
    """LaCrosse-TX TX3/TX4/TX7 (ref src/devices/lacrosse.c:37-150):
    44-bit rows of 11 nybbles, nybble checksum + 3-digit parity."""
    events = []
    result = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 44:
            result = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        if b[0] != 0x0A:
            result = DECODE_ABORT_EARLY
            continue
        nyb = []
        parity = 0
        for i in range(44):
            bit = (b[i // 8] >> (7 - i % 8)) & 1
            if i % 4 == 0:
                nyb.append(0)
            nyb[-1] |= bit << (3 - i % 4)
            if 4 < i // 4 < 8:
                parity += bit
        parity += nyb[4] & 0x01
        checksum = sum(nyb[:10]) & 0x0F
        if checksum != nyb[10] or parity % 2 != 0:
            result = DECODE_FAIL_MIC
            continue
        msg_type = nyb[2]
        sensor_id = (nyb[3] << 3) + (nyb[4] >> 1)
        msg_value_raw = (nyb[5] << 8) | (nyb[6] << 4) | nyb[7]
        msg_value = nyb[5] * 10 + nyb[6] + nyb[7] * 0.1
        if nyb[5] != nyb[8] or nyb[6] != nyb[9]:
            result = DECODE_FAIL_SANITY
            continue
        if msg_type == 0x00:
            events.append(Event.make(
                ("model", "LaCrosse-TX"),
                ("id", sensor_id),
                ("temperature_C", msg_value - 50.0, "Temperature", "%.1f C"),
                ("mic", "PARITY", "Integrity"),
            ))
        elif msg_type == 0x0E:
            events.append(Event.make(
                ("model", "LaCrosse-TX"),
                ("id", sensor_id),
                ("humidity", msg_value, "Humidity", "%.1f %%")
                if msg_value_raw != 0xFF else None,
                ("mic", "PARITY", "Integrity"),
            ))
    return events if events else result


@decoder("lacrosse_tx141x")
def lacrosse_tx141x(bits, dev):
    """LaCrosse TX141-Bv2/TX141TH-Bv2/TX141-Bv3/TX141W (ref
    src/devices/lacrosse_tx141x.c:100-320): inverted PWM rows."""
    bits.invert()
    r = bits.find_repeated_row(5 if bits.num_rows > 5 else 3, 32)
    if r < 0:
        r = bits.find_repeated_row(2, 64)
    if r < 0 and bits.num_rows <= 4:
        for row in range(bits.num_rows):
            if bits.bits_per_row[row] in (40, 41) and \
                    util.lfsr_digest8_reflect(
                        bytes(_ints(bits.bb[row])[:4]), 4, 0x31, 0xF4) \
                    == int(bits.bb[row][4]):
                r = row
                break
    if r < 0:
        return DECODE_ABORT_LENGTH
    n = bits.bits_per_row[r]
    if n >= 64:
        device = 65
    elif n > 41:
        return DECODE_ABORT_LENGTH
    elif n >= 41:
        if bits.num_rows > 12:
            return DECODE_ABORT_LENGTH
        device = 40
    elif n >= 40:
        device = 40
    elif n >= 37:
        device = 37
    elif n == 32:
        device = 32
    else:
        device = 33
    b = _ints(bits.bb[r])
    if device == 65:
        if (b[0] >> 3) != 0x01:
            return DECODE_ABORT_EARLY
        if util.crc8(bytes(b[:8]), 8, 0x31, 0):
            return DECODE_FAIL_MIC
        id_ = ((b[0] & 0x07) << 16) | (b[1] << 8) | b[2]
        battery_low = b[3] >> 7
        test = (b[3] & 0x40) >> 6
        channel = (b[3] & 0x30) >> 4
        type_ = b[3] & 0x0F
        temp_raw = (b[4] << 4) | (b[5] >> 4)
        humidity = ((b[5] & 0x0F) << 8) | b[6]
        if type_ == 1:
            return [Event.make(
                ("model", "LaCrosse-TX141W"),
                ("id", id_, "Sensor ID", "%05x"),
                ("channel", channel, "Channel", "%01x"),
                ("battery_ok", int(not battery_low), "Battery"),
                ("temperature_C", (temp_raw - 500) * 0.1,
                 "Temperature", "%.2f C"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("test", test, "Test?"),
                ("mic", "CRC", "Integrity"),
            )]
        elif type_ == 2:
            return [Event.make(
                ("model", "LaCrosse-TX141W"),
                ("id", id_, "Sensor ID", "%05x"),
                ("channel", channel, "Channel", "%01x"),
                ("battery_ok", int(not battery_low), "Battery"),
                ("wind_avg_km_h", temp_raw * 0.1, "Wind speed", "%.1f km/h"),
                ("wind_dir_deg", humidity, "Wind direction"),
                ("test", test, "Test?"),
                ("mic", "CRC", "Integrity"),
            )]
        return DECODE_FAIL_OTHER
    id_ = b[0]
    if device == 40:
        battery_low = b[1] >> 7
    else:
        battery_low = int(not (b[1] >> 7))
    test = (b[1] & 0x40) >> 6
    channel = (b[1] & 0x30) >> 4
    temp_raw = ((b[1] & 0x0F) << 8) | b[2]
    temp_c = (temp_raw - 500) * 0.1
    humidity = b[3] if device == 40 else 0
    if id_ == 0 or (device == 40 and (humidity == 0 or humidity > 100)) \
            or temp_c < -40.0 or temp_c > 140.0:
        return DECODE_FAIL_SANITY
    if device == 32:
        return [Event.make(
            ("model", "LaCrosse-TX141B"),
            ("id", id_, "Sensor ID", "%02x"),
            ("temperature_C", temp_c, "Temperature", "%.2f C"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("test", "Yes" if test else "No", "Test?"),
        )]
    if device == 37:
        return [Event.make(
            ("model", "LaCrosse-TX141Bv2"),
            ("id", id_, "Sensor ID", "%02x"),
            ("channel", channel, "Channel"),
            ("temperature_C", temp_c, "Temperature", "%.2f C"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("test", "Yes" if test else "No", "Test?"),
        )]
    if device == 33:
        return [Event.make(
            ("model", "LaCrosse-TX141Bv3"),
            ("id", id_, "Sensor ID", "%02x"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temp_c, "Temperature", "%.2f C"),
            ("test", "Yes" if test else "No", "Test?"),
        )]
    if util.lfsr_digest8_reflect(bytes(b[:4]), 4, 0x31, 0xF4) != b[4]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "LaCrosse-TX141THBv2"),
        ("id", id_, "Sensor ID", "%02x"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(not battery_low), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("test", "Yes" if test else "No", "Test?"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_breezepro")
def lacrosse_breezepro(bits, dev):
    """LaCrosse-BreezePro LTV-WSDTH01 (ref src/devices/
    lacrosse_breezepro.c:72-131)."""
    if bits.bits_per_row[0] < 264:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, _LTV_PREAMBLE, 32)
    if offset >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    offset += 32
    b = _ints(bits.extract_bytes(0, offset, 88))
    if util.crc8(bytes(b[:11]), 11, 0x31, 0):
        return DECODE_FAIL_MIC
    id_ = (b[0] << 16) | (b[1] << 8) | b[2]
    flags = b[3] & 0xF1
    seq = (b[3] & 0x0E) >> 1
    raw_temp = (b[4] << 4) | ((b[5] & 0xF0) >> 4)
    humidity = ((b[5] & 0x0F) << 8) | b[6]
    raw_speed = (b[7] << 4) | ((b[8] & 0xF0) >> 4)
    direction = ((b[8] & 0x0F) << 8) | b[9]
    temp_c = (raw_temp - 400) * 0.1
    speed_kmh = raw_speed * 0.1
    if humidity > 100 or temp_c < -40 or temp_c > 70 \
            or direction > 360 or speed_kmh > 200:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "LaCrosse-BreezePro"),
        ("id", id_, "Sensor ID", "%06x"),
        ("seq", seq, "Sequence", "%01x"),
        ("flags", flags, "unknown"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("wind_avg_km_h", speed_kmh, "Wind speed", "%.1f km/h"),
        ("wind_dir_deg", direction, "Wind direction"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_r1")
def lacrosse_r1(bits, dev):
    """LaCrosse-R1/R3/W1 (ref src/devices/lacrosse_r1.c:94-186)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len < 170 or msg_len > 272:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, _LTV_PREAMBLE, 32)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    offset += 32
    b = _ints(bits.extract_bytes(0, offset, 160))
    rev = 1
    chk = util.crc8(bytes(b[:11]), 11, 0x31, 0)
    if chk == 0 and b[4] == 0xAA and b[5] == 0xAA and b[6] == 0xAA \
            and (b[8] & 0x0F) == 0x0A and b[9] == 0xAA:
        rev = 9
    elif chk == 0 and b[10] != 0:
        rev = 3
    else:
        chk = util.crc8(bytes(b[:8]), 8, 0x31, 0)
        if b[10] != 0 or chk != 0:
            return DECODE_FAIL_MIC
    id_ = (b[0] << 16) | (b[1] << 8) | b[2]
    flags = b[3] & 0x31
    batt_low = (b[3] & 0x80) >> 7
    startup = (b[3] & 0x40) >> 6
    seq = (b[3] & 0x0E) >> 1
    raw_rain1 = ((b[5] ^ 0xAA) << 16) | (b[4] << 8) | b[6]
    raw_rain2 = ((b[8] ^ 0xAA) << 16) | (b[7] << 8) | b[9]
    raw_wind = (b[7] << 4) | (b[8] >> 4)
    model = {1: "LaCrosse-R1", 3: "LaCrosse-R3", 9: "LaCrosse-W1"}[rev]
    return [Event.make(
        ("model", model),
        ("id", id_, "Sensor ID", "%06x"),
        ("battery_ok", int(not batt_low), "Battery"),
        ("startup", startup, "Startup") if startup else None,
        ("seq", seq, "Sequence"),
        ("flags", flags, "Unknown") if flags else None,
        ("rain_mm", raw_rain1 * 0.25, "Total Rain", "%.2f mm")
        if rev != 9 else None,
        ("rain2_mm", raw_rain2 * 0.25, "Total Rain2", "%.2f mm")
        if rev == 3 else None,
        ("wind_avg_km_h", raw_wind * 0.1, "Wind Speed", "%.1f km/h")
        if rev == 9 else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_th3")
def lacrosse_th3(bits, dev):
    """LaCrosse-TH3/TH2 (ref src/devices/lacrosse_th3.c:73-148)."""
    n = bits.bits_per_row[0]
    if n < 156 or n > 290:
        return DECODE_ABORT_LENGTH
    model_num = 3 if n < 280 else 2
    offset = bits.search(0, 0, _LTV_PREAMBLE, 32)
    if offset >= n:
        return DECODE_ABORT_EARLY
    offset += 32
    b = _ints(bits.extract_bytes(0, offset, 64))
    chk3 = util.crc8(bytes(b[:8]), 8, 0x31, 0x00)
    chk2 = util.crc8(bytes(b[:8]), 8, 0x31, 0xAC)
    chk2i = util.crc8(bytes(b[:8]), 8, 0x31, 0xB2)
    if chk3 != 0 and chk2 != 0 and chk2i != 0:
        return DECODE_FAIL_MIC
    id_ = (b[0] << 16) | (b[1] << 8) | b[2]
    flags = b[3] & 0x31
    batt_low = (b[3] & 0x80) >> 7
    retrans = (b[3] & 0x40) >> 6
    seq = (b[3] & 0x0E) >> 1
    raw_temp = (b[4] << 4) | ((b[5] & 0xF0) >> 4)
    humidity = ((b[5] & 0x0F) << 8) | b[6]
    temp_c = (raw_temp - 400) * 0.1
    if humidity > 100 or temp_c < -50 or temp_c > 70:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "LaCrosse-TH3" if model_num == 3 else "LaCrosse-TH2"),
        ("id", id_, "Sensor ID", "%06x"),
        ("battery_ok", int(not batt_low), "Battery"),
        ("retransmit", retrans, "Retransmit") if retrans else None,
        ("seq", seq, "Sequence"),
        ("flags", flags, "unknown") if flags else None,
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_wr1")
def lacrosse_wr1(bits, dev):
    """LaCrosse-WR1 multi sensor (ref src/devices/lacrosse_wr1.c:63-134)."""
    n = bits.bits_per_row[0]
    if n < 120 or n > 156:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, _LTV_PREAMBLE, 32)
    if offset >= n:
        return DECODE_ABORT_EARLY
    offset += 32
    b = _ints(bits.extract_bytes(0, offset, 88))
    if util.crc8(bytes(b[:11]), 11, 0x31, 0):
        return DECODE_FAIL_MIC
    id_ = (b[0] << 16) | (b[1] << 8) | b[2]
    flags = b[3] & 0xF1
    seq = (b[3] & 0x0E) >> 1
    raw_wind = (b[4] << 4) | ((b[5] & 0xF0) >> 4)
    direction = ((b[5] & 0x0F) << 8) | b[6]
    raw_rain1 = (b[7] << 4) | ((b[8] & 0xF0) >> 4)
    raw_rain2 = ((b[8] & 0x0F) << 8) | b[9]
    speed_kmh = raw_wind * 0.1
    if speed_kmh > 200 or direction > 360:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "LaCrosse-WR1"),
        ("id", id_, "Sensor ID", "%06x"),
        ("seq", seq, "Sequence"),
        ("flags", flags, "unknown"),
        ("wind_avg_km_h", speed_kmh, "Wind speed", "%.1f km/h"),
        ("wind_dir_deg", direction, "Wind direction"),
        ("rain1", raw_rain1, "raw_rain1", "%03x"),
        ("rain2", raw_rain2, "raw_rain2", "%03x"),
        ("mic", "CRC", "Integrity"),
    )]

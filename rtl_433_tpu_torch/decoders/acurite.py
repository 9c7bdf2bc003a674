"""Acurite sensor family decoders (ref src/devices/acurite.c).

Covers all registry slots backed by acurite.c: 896 rain gauge, 609TXC,
the txr family (Tower/1190/6045M/515/5n1/3n1/899/Atlas/Optimus), 986,
606TX, 590TX and 00275rm.
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _ints(b):
    return [int(x) for x in b]


# wind direction table (ref src/devices/acurite.c:116-133)
_5N1_WINDDIR = [14, 11, 13, 12, 15, 10, 0, 9, 3, 6, 4, 5, 2, 7, 1, 8]

# channel letters (ref :139-145)
_CHANNELS = ["C", "E", "B", "A"]


def _channel(byte0):
    return _CHANNELS[(byte0 & 0xC0) >> 6]


@decoder("acurite_rain_896")
def acurite_rain_896(bits, dev):
    """Acurite-Rain 896 (ref src/devices/acurite.c:151-185)."""
    if bits.bits_per_row[0] < 24:
        return DECODE_ABORT_LENGTH
    if bits.num_rows < 12:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[0])
    if b[0] == 0 or b[1] == 0 or b[2] == 0 or b[3] != 0 or b[4] != 0:
        return DECODE_ABORT_EARLY
    total_rain = (((b[1] & 0xF) << 8) | b[2]) * 0.5
    return [Event.make(
        ("model", "Acurite-Rain"),
        ("id", b[0]),
        ("rain_mm", total_rain, "Total Rain", "%.1f mm"),
    )]


@decoder("acurite_th")
def acurite_th(bits, dev):
    """Acurite-609TXC (ref src/devices/acurite.c:202-262): 40-bit rows,
    byte-sum checksum; every valid row emits an event."""
    out = []
    result = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 40:
            result = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        cksum = b[0] + b[1] + b[2] + b[3]
        if cksum == 0 or (cksum & 0xFF) != b[4]:
            result = DECODE_FAIL_MIC
            continue
        tempc = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
        status = (b[1] & 0xF0) >> 4
        humidity = b[3]
        if humidity > 100:
            return DECODE_FAIL_SANITY
        out.append(Event.make(
            ("model", "Acurite-609TXC"),
            ("id", b[0]),
            ("battery_ok", int(not (status & 0x8)), "Battery"),
            ("temperature_C", tempc, "Temperature", "%.1f C"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("status", status),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out if out else result


def _raw_str(b, n):
    return "".join("%02x" % x for x in b[:n])


def _txr_check(b, browlen, explen):
    """Length + checksum + parity + channel sanity (ref :1268-1313)."""
    if browlen < 6 or browlen < explen:
        return DECODE_ABORT_LENGTH
    if (sum(b[:explen - 1]) & 0xFF) != b[explen - 1]:
        return DECODE_FAIL_MIC
    parity = 0
    for x in b[2:explen - 1]:
        parity ^= x
    parity = util.parity8(parity)
    if parity:
        return DECODE_FAIL_MIC
    if _channel(b[0]) == "E":
        return DECODE_FAIL_SANITY
    return 0


def _tower_decode(b):
    """Acurite-Tower 592TXR (ref :953-1016)."""
    sensor_id = ((b[0] & 0x3F) << 8) | b[1]
    humidity = b[3] & 0x7F
    if humidity > 100 and humidity != 127:
        return DECODE_FAIL_SANITY
    temp_raw = ((b[4] & 0x7F) << 7) | (b[5] & 0x7F)
    tempc = (temp_raw - 1000) * 0.1
    if tempc < -40 or tempc > 70:
        return DECODE_FAIL_SANITY
    exception = int((temp_raw & 0x3800) != 0)
    ev = Event.make(
        ("model", "Acurite-Tower"),
        ("id", sensor_id),
        ("channel", _channel(b[0])),
        ("battery_ok", int((b[2] & 0x40) != 0), "Battery"),
        ("temperature_C", tempc, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%") if humidity != 127 else None,
        ("mic", "CHECKSUM", "Integrity"),
    )
    if exception:
        ev.append(("exception", exception, "Data Exception"),
                  ("raw_msg", _raw_str(b, 7), "Raw Message"))
    return [ev]


def _1190_decode(b):
    """Acurite-Leak 1190/1192 (ref :1026-1057)."""
    return [Event.make(
        ("model", "Acurite-Leak"),
        ("id", ((b[0] & 0x3F) << 8) | b[1]),
        ("channel", _channel(b[0])),
        ("battery_ok", int((b[2] & 0x40) != 0), "Battery"),
        ("leak_detected", (b[3] & 0x10) >> 4, "Leak"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _6045_decode(b, browlen):
    """Acurite-6045M lightning (ref :379-463)."""
    sensor_id = ((b[0] & 0x3F) << 8) | b[1]
    humidity = b[3] & 0x7F
    if humidity > 100:
        return DECODE_FAIL_SANITY
    temp_raw = ((b[4] & 0x1F) << 7) | (b[5] & 0x7F)
    tempf = (temp_raw - 1480) * 0.1
    if tempf < -40.0 or tempf > 158.0:
        return DECODE_FAIL_SANITY
    exception = int((temp_raw & 0x3000) != 0) + int((b[4] & 0x20) != 0)
    strike_count = ((b[6] & 0x7F) << 1) | ((b[7] & 0x40) >> 6)
    return [Event.make(
        ("model", "Acurite-6045M"),
        ("id", sensor_id),
        ("channel", _channel(b[0])),
        ("battery_ok", int((b[2] & 0x40) != 0), "Battery"),
        ("temperature_F", tempf, "Temperature", "%.1f F"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("strike_count", strike_count, "Strike Count"),
        ("storm_dist", b[7] & 0x1F, "Storm Distance"),
        ("active", int((b[4] & 0x40) == 0x40), "Active Mode"),
        ("rfi", int((b[7] & 0x20) == 0x20), "RFI Detect"),
        ("exception", exception, "Data Exception"),
        ("raw_msg", _raw_str(b, min(browlen, 15)), "Raw Message"),
    )]


def _515_decode(b):
    """Acurite-515 fridge/freezer (ref :1074-1150)."""
    message_type = b[2] & 0x3F
    ch = _channel(b[0])
    if message_type == 0x08:
        ch += "R"
    elif message_type == 0x09:
        ch += "F"
    else:
        return DECODE_FAIL_SANITY
    sensor_id = ((b[0] & 0x3F) << 8) | b[1]
    temp_raw = ((b[3] & 0x7F) << 7) | (b[4] & 0x7F)
    tempf = (temp_raw - 1480) * 0.1
    if tempf < -40.0 or tempf > 158.0:
        return DECODE_FAIL_SANITY
    exception = int((temp_raw & 0x3000) != 0)
    ev = Event.make(
        ("model", "Acurite-515"),
        ("id", sensor_id),
        ("channel", ch),
        ("battery_ok", int((b[2] & 0x40) != 0), "Battery"),
        ("temperature_F", tempf, "Temperature", "%.1f F"),
        ("mic", "CHECKSUM", "Integrity"),
    )
    if exception:
        ev.append(("exception", exception, "Data Exception"),
                  ("raw_msg", _raw_str(b, 6), "Raw Message"))
    return [ev]


def _5n1_decode(b):
    """Acurite-5n1 (ref :601-688)."""
    channel_str = _channel(b[0])
    sensor_id = ((b[0] & 0x0F) << 8) | b[1]
    sequence_num = (b[0] & 0x30) >> 4
    battery_low = (b[2] & 0x40) == 0
    message_type = b[2] & 0x3F
    wind_speed_raw = ((b[3] & 0x1F) << 3) | ((b[4] & 0x70) >> 4)
    wind_speed_kph = wind_speed_raw * 0.8278 + 1.0 if wind_speed_raw > 0 else 0.0
    if message_type == 0x31:
        wind_dir = _5N1_WINDDIR[b[4] & 0x0F] * 22.5
        raincounter = ((b[5] & 0x7F) << 7) | (b[6] & 0x7F)
        return [Event.make(
            ("model", "Acurite-5n1"),
            ("message_type", message_type),
            ("id", sensor_id),
            ("channel", channel_str),
            ("sequence_num", sequence_num),
            ("battery_ok", int(not battery_low), "Battery"),
            ("wind_avg_km_h", wind_speed_kph, "Wind Speed", "%.1f km/h"),
            ("wind_dir_deg", wind_dir, "", "%.1f"),
            ("rain_in", raincounter * 0.01, "Rainfall Accumulation", "%.2f in"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    elif message_type == 0x38:
        temp_raw = ((b[4] & 0x0F) << 7) | (b[5] & 0x7F)
        tempf = (temp_raw - 400) * 0.1
        if tempf < -40.0 or tempf > 158.0:
            return DECODE_FAIL_SANITY
        humidity = b[6] & 0x7F
        if humidity > 100:
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "Acurite-5n1"),
            ("message_type", message_type),
            ("id", sensor_id),
            ("channel", channel_str),
            ("sequence_num", sequence_num),
            ("battery_ok", int(not battery_low), "Battery"),
            ("wind_avg_km_h", wind_speed_kph, "wind_speed", "%.1f km/h"),
            ("temperature_F", tempf, "temperature", "%.1f F"),
            ("humidity", humidity, "", "%u %%"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return DECODE_FAIL_SANITY


def _3n1_decode(b):
    """Acurite-3n1 (ref :518-592)."""
    channel_str = _channel(b[0])
    sensor_id = ((b[0] & 0x3F) << 8) | b[1]
    message_type = b[2] & 0x3F
    if channel_str == "E":
        return DECODE_FAIL_SANITY
    sequence_num = (b[0] & 0x30) >> 4
    battery_low = (b[2] & 0x40) == 0
    humidity = b[3] & 0x7F
    if humidity > 100:
        return DECODE_FAIL_SANITY
    temp_raw = ((b[4] & 0x1F) << 7) | (b[5] & 0x7F)
    tempf = (temp_raw - 1480) * 0.1
    if tempf < -40.0 or tempf > 158.0:
        return DECODE_FAIL_SANITY
    wind_speed_mph = float(b[6] & 0x7F)
    return [Event.make(
        ("model", "Acurite-3n1"),
        ("message_type", message_type),
        ("id", sensor_id, "", "0x%02X"),
        ("channel", channel_str),
        ("sequence_num", sequence_num),
        ("battery_ok", int(not battery_low), "Battery"),
        ("wind_avg_mi_h", wind_speed_mph, "Wind Speed", "%.1f mi/h"),
        ("temperature_F", tempf, "Temperature", "%.1f F"),
        ("humidity", humidity, "", "%u %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _899_decode(b):
    """Acurite-Rain899 (ref :469-512)."""
    raincounter = ((b[5] & 0x7F) << 7) | (b[6] & 0x7F)
    return [Event.make(
        ("model", "Acurite-Rain899"),
        ("id", ((b[0] & 0x3F) << 8) | b[1]),
        ("channel", b[0] >> 6),
        ("battery_ok", int((b[2] & 0x40) != 0), "Battery"),
        ("rain_mm", raincounter * 0.254, "Rainfall Accumulation", "%.2f mm"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _atlas_decode(b, browlen):
    """Acurite-Atlas (ref :758-920)."""
    exception = 0
    message_type = b[2] & 0x3F
    sensor_id = ((b[0] & 0x03) << 8) | b[1]
    channel_str = _channel(b[0])
    sequence_num = (b[0] & 0x0C) >> 2
    battery_low = (b[2] & 0x40) == 0
    wind_speed_mph = float(((b[3] & 0x7F) << 1) | ((b[4] & 0x40) >> 6))
    if wind_speed_mph > 200:
        return DECODE_FAIL_SANITY
    ev = Event.make(
        ("model", "Acurite-Atlas"),
        ("id", sensor_id),
        ("channel", channel_str),
        ("sequence_num", sequence_num),
        ("battery_ok", int(not battery_low), "Battery"),
        ("message_type", message_type),
        ("wind_avg_mi_h", wind_speed_mph, "Wind Speed", "%.1f mi/h"),
    )
    if message_type in (0x05, 0x25):
        temp_raw = ((b[4] & 0x0F) << 7) | (b[5] & 0x7F)
        if (b[4] & 0x30) != 0:
            exception += 1
        tempf = (temp_raw - 400) * 0.1
        if tempf < -40.0 or tempf > 158.0:
            return DECODE_FAIL_SANITY
        humidity = b[6] & 0x7F
        if humidity > 100:
            return DECODE_FAIL_SANITY
        if humidity == 0:
            exception += 1
        ev.append(("temperature_F", tempf, "Temperature", "%.1f F"),
                  ("humidity", humidity, "", "%u %%"))
    if message_type in (0x06, 0x26):
        wind_dir = float(((b[4] & 0x1F) << 5) | ((b[5] & 0x7C) >> 2))
        if (b[4] & 0x30) != 0:
            exception += 1
        if wind_dir > 360:
            return DECODE_FAIL_SANITY
        raincounter = ((b[5] & 0x03) << 7) | (b[6] & 0x7F)
        ev.append(("wind_dir_deg", wind_dir, "", "%.1f"),
                  ("rain_in", raincounter * 0.01,
                   "Rainfall Accumulation", "%.2f in"))
    if message_type in (0x07, 0x27):
        uv = b[4] & 0x0F
        lux = ((b[5] & 0x7F) << 7) | (b[6] & 0x7F)
        if lux > 12000:
            return DECODE_FAIL_SANITY
        ev.append(("uvi", float(uv), "UV Index", "%.0f"),
                  ("lux", lux * 10, ""))
    if message_type in (0x25, 0x26, 0x27):
        strike_count = ((b[7] & 0x7F) << 2) | ((b[8] & 0x60) >> 5)
        ev.append(("strike_count", strike_count, ""),
                  ("strike_distance", b[8] & 0x1F, ""))
    ev.append(("exception", exception, "Data Exception"),
              ("raw_msg", _raw_str(b, min(browlen, 15)), "Raw Message"))
    return [ev]


def _optimus_decode(b):
    """Acurite-Optimus 6-in-1 (ref :1192-1265)."""
    channel_str = _channel(b[0])
    sensor_id = ((b[0] & 0x0F) << 8) | b[1]
    sequence_num = (b[0] & 0x30) >> 4
    battery_low = (b[2] & 0x40) == 0
    message_type = b[2] & 0x3F
    wind_speed_mph = float(((b[3] & 0x7F) << 1) | ((b[4] & 0x40) >> 6))
    if wind_speed_mph > 200:
        return DECODE_FAIL_SANITY
    ev = Event.make(
        ("model", "Acurite-Optimus"),
        ("id", sensor_id),
        ("channel", channel_str),
        ("sequence_num", sequence_num),
        ("battery_ok", int(not battery_low), "Battery"),
        ("wind_avg_mi_h", wind_speed_mph, "Wind Speed", "%.1f mi/h"),
        ("wind_avg_km_h", wind_speed_mph * 1.609344, "Wind Speed", "%.1f km/h"),
    )
    if message_type == 0x3B:
        temp_raw = ((b[4] & 0x0F) << 7) | (b[5] & 0x7F)
        tempf = (temp_raw - 400) * 0.1
        if tempf < -40.0 or tempf > 158.0:
            return DECODE_FAIL_SANITY
        humidity = b[6] & 0x7F
        if humidity > 100:
            return DECODE_FAIL_SANITY
        ev.append(("temperature_F", tempf, "Temperature", "%.1f F"),
                  ("humidity", humidity, "", "%u %%"))
    elif message_type == 0x3A:
        wind_dir = _5N1_WINDDIR[b[4] & 0x0F] * 22.5
        raincounter = ((b[5] & 0x03) << 7) | (b[6] & 0x7F)
        ev.append(("wind_dir_deg", wind_dir, "", "%.1f"),
                  ("rain_in", raincounter * 0.01,
                   "Rainfall Accumulation", "%.2f in"))
    ev.append(("raw_msg", _raw_str(b, 10), "Raw Message"))
    return [ev]


_TXR_TYPES = {
    0x01: ("1190", 7), 0x04: ("tower", 7), 0x2F: ("6045", 9),
    0x08: ("515", 6), 0x09: ("515", 6),
    0x31: ("5n1", 8), 0x38: ("5n1", 8),
    0x3A: ("optimus", 10), 0x3B: ("optimus", 10),
    0x20: ("3n1", 8), 0x30: ("899", 8),
    0x05: ("atlas", 8), 0x06: ("atlas", 8), 0x07: ("atlas", 8),
    0x25: ("atlas", 10), 0x26: ("atlas", 10), 0x27: ("atlas", 10),
}


@decoder("acurite_txr")
def acurite_txr(bits, dev):
    """Acurite txr-family dispatcher (ref src/devices/acurite.c:1341-1584):
    inverted PWM rows with a message type in byte 2, checksum + parity."""
    bits.invert()
    out = []
    error_ret = 0
    for row in range(bits.num_rows):
        browlen = bits.bits_per_row[row] // 8
        if browlen < 6:
            continue
        if browlen > 10:
            error_ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        if b[0] == 0 and b[1] == 0 and b[2] == 0 and b[browlen - 1] == 0:
            continue
        message_type = b[2] & 0x3F
        kind = _TXR_TYPES.get(message_type)
        if kind is None:
            error_ret = DECODE_FAIL_SANITY
            continue
        name, explen = kind
        if name == "3n1":
            # the 3n1 skips the parity check (ref :1495-1513)
            if browlen < explen:
                error_ret = DECODE_ABORT_LENGTH
                continue
            if (sum(b[:explen - 1]) & 0xFF) != b[explen - 1]:
                error_ret = DECODE_FAIL_MIC
                continue
            ret = _3n1_decode(b)
        else:
            chk = _txr_check(b, browlen, explen)
            if chk != 0:
                error_ret = chk
                continue
            if name == "tower":
                ret = _tower_decode(b)
            elif name == "1190":
                ret = _1190_decode(b)
            elif name == "6045":
                ret = _6045_decode(b, browlen)
            elif name == "515":
                ret = _515_decode(b)
            elif name == "5n1":
                ret = _5n1_decode(b)
            elif name == "optimus":
                ret = _optimus_decode(b)
            elif name == "899":
                ret = _899_decode(b)
            else:
                ret = _atlas_decode(b, browlen)
        if isinstance(ret, list):
            out.extend(ret)
        elif ret < 0:
            error_ret = ret
    return out if out else error_ret


@decoder("acurite_986")
def acurite_986(bits, dev):
    """Acurite-986 fridge/freezer (ref src/devices/acurite.c:1623-1717):
    LSB-first 40-bit rows, CRC-8 LE poly 0x07 with missing-last-bit hack."""
    out = []
    result = 0
    for row in range(bits.num_rows):
        n = bits.bits_per_row[row]
        if n < 39 or n > 43:
            result = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        if (b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF) or \
                (b[0] == 0 and b[1] == 0 and b[2] == 0):
            result = DECODE_ABORT_EARLY
            continue
        br = [util.reverse8(x) for x in b[:5]]
        crcc = util.crc8le(bytes(br), 4, 0x07, 0)
        if crcc != br[4] and crcc != (br[4] | 0x80):
            continue
        tempf = br[0]
        if tempf & 0x80:
            tempf = -(tempf & 0x7F)
        status = br[3]
        sensor_num = (status & 0x01) + 1
        status >>= 1
        battery_low = (status & 1) == 1
        out.append(Event.make(
            ("model", "Acurite-986"),
            ("id", (br[1] << 8) + br[2]),
            ("channel", "2F" if sensor_num == 2 else "1R"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_F", float(tempf), "temperature", "%f F"),
            ("status", status, "Status"),
            ("mic", "CRC", "Integrity"),
        ))
    return out if out else result


@decoder("acurite_606")
def acurite_606(bits, dev):
    """Acurite-606TX (ref src/devices/acurite.c:1904-1958): 32/33-bit rows
    x3, LFSR-8 digest gen 0x98 key 0xf1."""
    row = bits.find_repeated_row(3, 32)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 33:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] == 0 and b[1] == 0 and b[2] == 0 and b[3] == 0:
        return DECODE_FAIL_SANITY
    if util.lfsr_digest8(bytes(b[:3]), 3, 0x98, 0xF1) != b[3]:
        return DECODE_FAIL_MIC
    temp_c = (_s16((b[1] << 12) | (b[2] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Acurite-606TX"),
        ("id", b[0]),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", (b[1] & 0x80) >> 7, "Battery"),
        ("button", (b[1] & 0x40) >> 6, "Button"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("acurite_590tx")
def acurite_590tx(bits, dev):
    """Acurite-590TX (ref src/devices/acurite.c:1971-2032): 25-bit rows x3,
    odd parity over the first 10 bits."""
    row = bits.find_repeated_row(3, 25)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 25:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[4] != 0:
        return DECODE_FAIL_SANITY
    if b[0] == 0 and b[1] == 0 and b[2] == 0 and b[3] == 0:
        return DECODE_FAIL_SANITY
    parity = b[0]
    parity = (parity >> 4) ^ (parity & 0xF)
    parity = (parity >> 2) ^ (parity & 0x3)
    parity ^= b[1] >> 6
    parity = (parity >> 1) ^ (parity & 0x1)
    if not parity:
        return DECODE_FAIL_MIC
    temp_raw = _s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4
    temp_c = (temp_raw - 500) * 0.1
    humidity = temp_raw if 0 <= temp_raw <= 100 else -1
    return [Event.make(
        ("model", "Acurite-590TX"),
        ("id", b[0] & 0xFE),
        ("channel", (b[1] >> 4) & 0x03, "Channel"),
        ("battery_ok", b[0] & 0x01, "Battery"),
        ("humidity", humidity, "Humidity") if humidity != -1 else None,
        ("temperature_C", temp_c, "Temperature", "%.1f C")
        if humidity == -1 else None,
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("acurite_00275rm")
def acurite_00275rm(bits, dev):
    """Acurite-00275rm room monitor (ref src/devices/acurite.c:2038-2121):
    inverted 88-bit rows, 3-row majority vote fallback, CRC-16 LSB."""
    result = 0
    bits.invert()
    rows = [r for r in range(bits.num_rows) if bits.bits_per_row[r] == 88][:3]
    if len(rows) == 3:
        bits.add_row()
        new_row = bits.num_rows - 1
        for i in range(11):
            r0, r1, r2 = (int(bits.bb[rows[k]][i]) for k in range(3))
            bits.bb[new_row][i] = (r0 & r1) | (r1 & r2) | (r2 & r0)
        bits.bits_per_row[new_row] = 88
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 88:
            result = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        if util.crc16lsb(bytes(b[:11]), 11, 0x00B2, 0x00D0) != 0:
            result = DECODE_FAIL_MIC
            continue
        id_ = (b[0] << 16) | (b[1] << 8) | b[3]
        battery_low = (b[2] & 0x40) == 0
        model_flag = b[2] & 1
        tempc = (((b[4] << 4) | (b[5] >> 4)) - 1000) * 0.1
        probe = b[5] & 3
        humidity = ((b[6] & 0x1F) << 2) | (b[7] >> 6)
        water = int((b[7] & 0x0F) == 15)
        ptempc = ((((b[7] & 0x0F) << 8) | b[8]) - 1000) * 0.1
        phumidity = b[9] & 0x7F
        return [Event.make(
            ("model", "Acurite-00275rm" if model_flag else "Acurite-00276rm"),
            ("subtype", probe, "Probe"),
            ("id", id_),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", tempc, "Celsius", "%.1f C"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("water", water) if probe == 1 else None,
            ("temperature_1_C", ptempc, "Celsius", "%.1f C")
            if probe in (2, 3) else None,
            ("humidity_1", phumidity, "Humidity", "%u %%")
            if probe == 3 else None,
            ("mic", "CRC", "Integrity"),
        )]
    return result

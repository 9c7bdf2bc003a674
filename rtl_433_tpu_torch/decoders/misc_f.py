"""Misc decoders batch F (reference files cited per function):
Marlec Solar iBoost+, Emax weather station family, Kingspan Watchman
Plus oil monitor, GEO minim+ energy monitor.
"""

from __future__ import annotations

import datetime

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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("marlec_solar")
def marlec_solar(bits, dev):
    """Marlec Solar iBoost+ (ref src/devices/marlec_solar.c)."""
    pre = bytes([0xAA, 0xAA, 0xD3, 0x91, 0xD3, 0x91])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, pre, 48)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 96:
        return DECODE_ABORT_LENGTH
    length = int(bits.extract_bytes(0, start + 48, 8)[0])
    if length > 105:
        return DECODE_ABORT_LENGTH
    frame = [length] + _ints(
        bits.extract_bytes(0, start + 56, (length + 2) * 8))
    frame += [0] * (108 - len(frame))
    crc = util.crc16(bytes(frame[:length + 1]), length + 1, 0x8005, 0xFFFF)
    if ((frame[length + 1] << 8) | frame[length + 2]) != crc:
        return DECODE_FAIL_MIC
    def _s32(v):
        return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000

    is_data = frame[3] == 0x22
    saved_type = frame[25]
    # import_val/saved_val are C signed ints (ref marlec_solar.c:102-104)
    saved_val = _s32(frame[26] | (frame[27] << 8) | (frame[28] << 16)
                     | (frame[29] << 24))
    return [Event.make(
        ("model", "Marlec-Solar"),
        ("boost_time", frame[6], "") if is_data else None,
        ("solar_off", frame[7], "") if is_data else None,
        ("tank_hot", frame[8], "") if is_data else None,
        ("battery_low", frame[13], "") if is_data else None,
        ("heating", _s16(frame[17] | (frame[18] << 8)), "")
        if is_data else None,
        ("import_val", _s32(frame[19] | (frame[20] << 8) | (frame[21] << 16)
                            | (frame[22] << 24)), "") if is_data else None,
        ("saved_today", saved_val, "")
        if is_data and saved_type == 0xCA else None,
        ("saved_yesterday", saved_val, "")
        if is_data and saved_type == 0xCB else None,
        ("saved_last_7", saved_val, "")
        if is_data and saved_type == 0xCC else None,
        ("saved_last_28", saved_val, "")
        if is_data and saved_type == 0xCD else None,
        ("saved_total", saved_val, "")
        if is_data and saved_type == 0xCE else None,
        ("raw", "".join("%02x" % x for x in frame[1:length + 1]),
         "Raw data"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("emax")
def emax(bits, dev):
    """Emax / Altronics / Optex weather family (ref src/devices/emax.c)."""
    pre = bytes([0xAA, 0xAA, 0xCA, 0xCA, 0x54])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    ret = 0
    pos = 0
    while True:
        pos = bits.search(0, pos, pre, 40)
        if pos + 264 > bits.bits_per_row[0]:
            break
        pos += 40
        if pos + 32 * 8 > bits.bits_per_row[0]:
            ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.extract_bytes(0, pos, 32 * 8))
        kind = (b[1] & 0xF0) >> 4
        subtype = b[3] & 0x03
        checksum = util.add_bytes(bytes(b[:31]))
        if kind != 0 and subtype == 0x3:
            checksum -= 0x9A
        if (checksum & 0xFF) != b[31]:
            ret = DECODE_FAIL_MIC
            pos += 264
            continue
        channel = b[1] & 0x0F
        eid = (b[2] << 4) | (b[3] >> 4)
        battery_low = b[3] & 0x08
        pairing = b[3] & 0x04
        if kind != 0:
            temp_raw = ((b[4] & 0x0F) << 8) | (b[5] & 0xF0) | (b[6] & 0x0F)
            return [Event.make(
                ("model", "Altronics-X7064" if subtype == 0x1
                 else ("Altronics-X7064A" if subtype == 0x3 else None), "")
                if subtype in (1, 3) else None,
                ("id", eid, "", "%03x"),
                ("channel", channel, "Channel"),
                ("battery_ok", int(not battery_low), "Battery_OK"),
                ("temperature_F", (temp_raw - 900) * 0.1, "Temperature",
                 "%.1f F") if subtype == 0x1 else None,
                ("temperature_C", (temp_raw - 500) * 0.1, "Temperature",
                 "%.1f C") if subtype == 0x3 else None,
                ("humidity", b[7], "Humidity", "%u %%"),
                ("pairing", 1, "Pairing") if pairing else None,
                ("mic", "CHECKSUM", "Integrity"),
            )]
        temp_raw = ((b[4] & 0x0F) << 8) | b[5]
        temp_f = (temp_raw - 900) * 0.1
        humidity = b[6]
        wind_raw = (((b[7] - 1) & 0xFF) << 8) | ((b[8] - 1) & 0xFF)
        speed_kmh = wind_raw * 0.2
        direction_deg = (((b[9] - 1) & 0x0F) << 8) | ((b[10] - 1) & 0xFF)
        rain_mm = ((((b[11] - 1) & 0xFF) << 8) | ((b[12] - 1) & 0xFF)) * 0.2
        common = [
            ("id", eid, "", "%03x"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(not battery_low), "Battery_OK"),
        ]
        if b[29] == 0x17:
            uv_index = (b[13] - 1) & 0x1F
            lux_14 = (b[14] - 1) & 0xFF
            lux_15 = (b[15] - 1) & 0xFF
            light_lux = ((lux_14 & 0x7F) << 8) | lux_15
            if (lux_14 & 0x80) >> 7 == 1:
                light_lux *= 10
            tag = ((b[13] - 1) & 0xC0) >> 6
            return [Event.make(
                ("model", "Emax-W6" if tag != 3 else "IMETEO-X6", ""),
                *common,
                ("temperature_F", temp_f, "Temperature", "%.1f F"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("wind_avg_km_h", speed_kmh, "Wind avg speed",
                 "%.1f km/h"),
                ("wind_dir_deg", direction_deg, "Wind Direction"),
                ("rain_mm", rain_mm, "Total rainfall", "%.1f mm"),
                ("uvi", float(uv_index), "UV Index", "%.0f")
                if tag != 3 else None,
                ("light_lux", light_lux, "Lux", "%u") if tag != 3 else None,
                ("pairing", 1, "Pairing?") if pairing else None,
                ("mic", "CHECKSUM", "Integrity"),
            )]
        if b[29] == 0x16 and b[14] == 0x01 and b[15] == 0x01:
            return [Event.make(
                ("model", "Emax-EM3551H"),
                *common,
                ("temperature_F", temp_f, "Temperature", "%.1f F"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("wind_avg_km_h", speed_kmh, "Wind avg speed",
                 "%.1f km/h"),
                ("wind_max_km_h", b[16] / 1.5, "Wind max speed",
                 "%.1f km/h"),
                ("wind_dir_deg", direction_deg, "Wind Direction"),
                ("rain_mm", rain_mm, "Total rainfall", "%.1f mm"),
                ("pairing", 1, "Pairing?") if pairing else None,
                ("mic", "CHECKSUM", "Integrity"),
            )]
        if b[29] == 0x16:
            temp_c = (temp_raw - 500) * 0.1
            uv_index = (b[13] - 1) & 0x1F
            lux_14 = (b[14] - 1) & 0xFF
            lux_15 = (b[15] - 1) & 0xFF
            light_lux = ((lux_14 & 0x7F) << 8) | lux_15
            if (lux_14 & 0x80) >> 7 == 1:
                light_lux *= 10
            return [Event.make(
                ("model", "Lacrosse-WS6262"),
                *common,
                ("temperature_C", temp_c, "Temperature", "%.1f C"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("wind_avg_km_h", speed_kmh, "Wind avg speed",
                 "%.1f km/h"),
                ("wind_max_km_h", b[16] / 1.5, "Wind max speed",
                 "%.1f km/h"),
                ("wind_dir_deg", direction_deg, "Wind Direction"),
                ("rain_mm", rain_mm, "Total rainfall", "%.1f mm"),
                ("uvi", float(uv_index), "UV Index", "%.0f"),
                ("light_lux", light_lux, "Lux", "%u"),
                ("pairing", 1, "Pairing?") if pairing else None,
                ("mic", "CHECKSUM", "Integrity"),
            )]
        pos += 264
    return ret


@decoder("watchman_plus")
def watchman_plus(bits, dev):
    """Kingspan Watchman Plus oil monitor
    (ref src/devices/watchman_plus.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 53:
        return DECODE_ABORT_LENGTH
    b = bits.bb[0]
    row_len = bits.bits_per_row[0]
    found = False
    wid = level = battery_low = 0
    search_start = 0
    while search_start + 53 <= row_len:
        match = bits.search(0, search_start, bytes([0xFF, 0xF0]), 13)
        if match + 53 > row_len:
            break
        pos = match + 13
        search_start = match + 1
        stuff_ok = True
        id_raw = 0
        for i in range(3):
            for _ in range(8):
                id_raw = (id_raw << 1) | int(util.bit_at(b, pos))
                pos += 1
            if i < 2:
                s0 = util.bit_at(b, pos)
                s1 = util.bit_at(b, pos + 1)
                pos += 2
                stuff_ok &= s0 == 1 and s1 == 0
        s0 = util.bit_at(b, pos)
        s1 = util.bit_at(b, pos + 1)
        pos += 2
        stuff_ok &= s0 == 1 and s1 == 0
        lvl = 0
        for j in range(4):
            lvl |= util.bit_at(b, pos) << j
            pos += 1
        pos += 3
        batt_low = util.bit_at(b, pos)
        pos += 1
        s2 = util.bit_at(b, pos)
        s3 = util.bit_at(b, pos + 1)
        stuff_ok &= s2 == 1 and s3 == 0
        if not stuff_ok or lvl > 10:
            continue
        id_rev = util.reverse32((id_raw << 8) & 0xFFFFFFFF) & 0xFFFFFF
        id_val = 0
        for n in range(7, -1, -1):
            id_val = id_val * 10 + ((id_rev >> (n * 3)) & 0x7)
        wid, level, battery_low = id_val, lvl, batt_low
        found = True
        break
    if not found:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Watchman-Plus"),
        ("id", "%08d" % wid, ""),
        ("level", str(level) if level <= 9 else "F", "Level"),
        ("battery_ok", int(not battery_low), "Battery"),
    )]


@decoder("geo_minim")
def geo_minim(bits, dev):
    """GEO minim+ energy monitor (ref src/devices/geo_minim.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    pre1 = bytes([0xAA, 0xAA, 0x7B, 0xB9])
    pre2 = bytes([0x55, 0x55, 0x7B, 0xB9])
    bitpos = bits.search(0, 0, pre1, 32) + 32
    if bitpos >= bits.bits_per_row[0]:
        bitpos = bits.search(0, 0, pre2, 32) + 32
    if bitpos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    nbits = bits.bits_per_row[0]
    if bitpos + 32 >= nbits:
        return DECODE_ABORT_LENGTH
    nbits -= bitpos
    buf = _ints(bits.extract_bytes(0, bitpos, 32))
    data_length = buf[3]
    if data_length not in (0x2A, 0x05):
        return DECODE_ABORT_EARLY
    nbytes = min(nbits // 8, 128)
    crc_len = 4 + data_length
    if crc_len + 2 > nbytes:
        return DECODE_FAIL_SANITY
    buf += _ints(bits.extract_bytes(0, bitpos + 32, (nbytes - 4) * 8))
    crc = util.crc16(bytes(buf[:crc_len]), crc_len, 0x8005, 0)
    if crc != ((buf[crc_len] << 8) | buf[crc_len + 1]):
        return DECODE_FAIL_MIC
    if data_length == 0x05:
        if nbytes != 11:
            return DECODE_ABORT_LENGTH
        va = 10 * (buf[5] + ((buf[4] & 0x0F) << 8))
        if buf[4] & 0x40:
            va += 5
        flags4 = buf[4] & ~0x4F & 0xFF
        return [Event.make(
            ("model", "GEO-minimCT"),
            ("id", "%02X%02X%02X" % (buf[0], buf[1], buf[2]), ""),
            ("power_VA", va, "Power", "%u VA"),
            ("flags4", flags4, "Flags", "%#x") if flags4 != 0x30 else None,
            ("uptime_s",
             8 * ((buf[6] << 16) + (buf[7] << 8) + buf[8]), "Uptime"),
            ("mic", "CRC", "Integrity"),
        )]
    if nbytes != 48:
        return DECODE_ABORT_LENGTH
    watts = 5 * (buf[4] + ((buf[5] & 0x7F) << 8))
    flags5 = buf[5] & ~0x7F & 0xFF
    wh = buf[14] + ((buf[15] & 0x7) << 8)
    flags15 = buf[15] & ~0x7 & 0xFF
    days = buf[30] + (buf[31] << 8)
    clock = (datetime.datetime(2007, 1, 1, buf[32] & 0x1F, buf[33] & 0x3F)
             + datetime.timedelta(days=days))
    return [Event.make(
        ("model", "GEO-minimDP"),
        ("id", "%02X%02X%02X" % (buf[0], buf[1], buf[2]), ""),
        ("power_W", watts, "Power", "%u W"),
        ("energy_kWh", wh * 0.001, "Energy", "%.3f kWh"),
        ("clock", clock.strftime("%Y-%m-%d %H:%M"), "Clock"),
        ("flags5", flags5, "Flags5", "%#x") if flags5 != 0 else None,
        ("flags15", flags15, "Flags15", "%#x") if flags15 != 0x40
        else None,
        ("mic", "CRC", "Integrity"),
    )]

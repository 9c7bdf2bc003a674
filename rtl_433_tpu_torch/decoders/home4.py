"""Home sensors batch 4 (reference files cited per function):
Bresser leakage/lightning/ST1005H, Geevon TX16/TX19, Schou 72543 rain,
Baldr rain, Thermor DG950, Celsia CZC1.
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


@decoder("bresser_leakage")
def bresser_leakage(bits, dev):
    """Bresser water leakage sensor (ref src/devices/bresser_leakage.c)."""
    if (bits.num_rows != 1 or bits.bits_per_row[0] < 160
            or bits.bits_per_row[0] > 440):
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    start += 32
    if bits.bits_per_row[0] - start < 18 * 8:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, 18 * 8))
    if ((msg[0] << 8) | msg[1]) != util.crc16(bytes(msg[2:7]), 5, 0x1021,
                                              0x0000):
        return DECODE_FAIL_MIC
    s_type = msg[6] >> 4
    chan = msg[6] & 0x7
    alarm = (msg[7] & 0x80) >> 7
    no_alarm = (msg[7] & 0x40) >> 6
    nstartup = (msg[6] & 0x08) >> 3
    if s_type != 5 or alarm == no_alarm or chan == 0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Bresser-Leakage"),
        # DATA_INT is a C int: the 32-bit id wraps to signed
        ("id", ((((msg[2] << 24) | (msg[3] << 16) | (msg[4] << 8) | msg[5])
                 ^ 0x80000000) - 0x80000000), "", "%08x"),
        ("channel", chan, ""),
        ("battery_ok", int((msg[7] & 0x30) != 0x00), "Battery"),
        ("alarm", alarm, "Alarm"),
        ("startup", int(not nstartup), "Startup") if not nstartup else None,
    )]


@decoder("bresser_lightning")
def bresser_lightning(bits, dev):
    """Bresser lightning sensor (ref src/devices/bresser_lightning.c)."""
    if (bits.num_rows != 1 or bits.bits_per_row[0] < 112
            or bits.bits_per_row[0] > 440):
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    start += 32
    if bits.bits_per_row[0] - start < 10 * 8:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, 10 * 8))
    s_type = msg[6] >> 4
    chan = msg[6] & 0x07
    battery_low = (msg[5] & 0x08) >> 3
    nstartup = (msg[6] & 0x08) >> 3
    msg = [x ^ 0xAA for x in msg]
    chk = (msg[0] << 8) | msg[1]
    digest = util.lfsr_digest16(bytes(msg[2:10]), 8, 0x8810, 0xABF9)
    if (chk ^ digest) != 0x899E:
        return DECODE_FAIL_MIC
    if s_type != 9 or chan != 0:
        return DECODE_FAIL_SANITY
    count = (msg[4] >> 4) * 100 + (msg[4] & 0xF) * 10 + (msg[5] >> 4)
    return [Event.make(
        ("model", "Bresser-Lightning"),
        ("id", (msg[2] << 8) | msg[3], "", "%08x"),
        ("startup", int(not nstartup), "Startup") if not nstartup else None,
        ("battery_ok", int(not battery_low), "Battery"),
        ("storm_dist_km", msg[7], "Storm Distance", "%d km"),
        ("strike_count", count, "Strike Count"),
        ("unknown1", ((msg[5] & 0x0F) << 8) | msg[6], "Unknown1", "%03x"),
        ("unknown2", (msg[8] << 8) | msg[9], "Unknown2", "%04x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("bresser_st1005h")
def bresser_st1005h(bits, dev):
    """Bresser / Explore Scientific ST1005H
    (ref src/devices/bresser_st1005h.c)."""
    r = bits.find_repeated_row(3, 38)
    if r < 0 or bits.bits_per_row[r] > 38:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if (b[0] >> 7) != 0:
        return DECODE_FAIL_SANITY
    msg = _ints(bits.extract_bytes(r, 1, 4 * 8))
    msg[3] &= 0xFE
    chk = b[4] >> 2
    s = util.add_nibbles(bytes(msg), 4)
    if s == 0:
        return DECODE_ABORT_EARLY
    if chk != (s & 0x3F):
        return DECODE_FAIL_MIC
    temp_raw = _s16(((msg[1] & 0xF) << 12) | (msg[2] << 4))
    temp_c = (temp_raw >> 4) * 0.1
    channel = ((msg[1] >> 4) & 0x3) + 1
    humidity = msg[3] >> 1
    if channel >= 4 or humidity > 110 or temp_c < -30.0 or temp_c > 160.0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Bresser-ST1005H"),
        ("id", msg[0], "Id"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(not (msg[1] >> 7)), "Battery"),
        ("button", (msg[1] >> 6) & 0x1, "Button"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _geevon_decode(bits, model, check):
    """Common Geevon TX16/TX19 frame (ref src/devices/geevon.c,
    src/devices/geevon_tx19.c) — differ only in the checksum."""
    bits.invert()
    r = bits.find_repeated_prefix(5 if bits.num_rows > 5 else 3, 72)
    if r < 0:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if bits.bits_per_row[r] != 73:
        return DECODE_ABORT_LENGTH
    if b[5] != 0xAA or b[6] != 0x55 or b[7] != 0xAA:
        return DECODE_FAIL_MIC
    if not check(b):
        return DECODE_FAIL_MIC
    temp_raw = (b[2] << 4) | (b[3] >> 4)
    return [Event.make(
        ("model", model),
        ("id", b[0], ""),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("temperature_C", (temp_raw - 500) * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[4], "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("geevon_tx16")
def geevon_tx16(bits, dev):
    """Geevon TX16-3 outdoor sensor (ref src/devices/geevon.c)."""
    return _geevon_decode(
        bits, "Geevon-TX163",
        lambda b: util.crc8(bytes(b[:9]), 9, 0x31, 0x7B) == 0)


@decoder("geevon_tx19")
def geevon_tx19(bits, dev):
    """Geevon TX19-1 outdoor sensor (ref src/devices/geevon_tx19.c)."""
    return _geevon_decode(
        bits, "Geevon-TX191",
        lambda b: util.lfsr_digest8_reverse(bytes(b[:8]), 8, 0x98, 0x25)
        == b[8])


@decoder("schou_72543_rain")
def schou_72543_rain(bits, dev):
    """Schou 72543 Day rain gauge (ref src/devices/schou_72543_rain.c)."""
    if bits.num_rows < 2:
        return DECODE_ABORT_LENGTH
    row = bits.find_repeated_prefix(2, 64)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    s = util.add_bytes(bytes(b[:7]))
    if s == 0:
        return DECODE_ABORT_EARLY
    if b[7] != (s & 0xFF):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Schou-72543"),
        ("id", (b[0] << 8) | b[1], "ID"),
        ("temperature_F", (((b[6] << 8) | b[5]) - 900) * 0.1,
         "Temperature", "%.1f F"),
        ("rain_mm", ((b[4] << 8) | b[3]) * 0.1, "Rain", "%.1f mm"),
        ("battery_ok", int(not (b[2] & 0x80)), "Battery_ok"),
        ("msg_counter", (b[2] & 0x0E) >> 1, "Counter"),
        ("msg_repeat", int((b[2] & 0x40) > 0), "Msg_repeat"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("baldr_rain")
def baldr_rain(bits, dev):
    """Baldr / RainPoint rain gauge (ref src/devices/baldr_rain.c)."""
    r = bits.find_repeated_row(3, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[r])
    if bits.bits_per_row[r] > 37:
        return DECODE_ABORT_LENGTH
    if ((b[0] == 0 and b[2] == 0 and b[3] == 0)
            or (b[0] == 0xFF and b[2] == 0xFF and b[3] == 0xFF)):
        return DECODE_ABORT_EARLY
    rain_in = (b[2] << 12) | (b[3] << 4) | (b[4] >> 4)
    return [Event.make(
        ("model", "Baldr-Rain"),
        ("id", (b[0] << 4) | (b[1] >> 4), "", "%03x"),
        ("flags", b[1] & 0x0F, "Flags", "%x"),
        ("rain_in", rain_in * 0.001, "Rain", "%.3f in"),
    )]


_THERMOR_WDIR = [157, 45, 135, 67, 180, 22, 112, 90, 225, 337, 247, 315,
                 202, 0, 270, 292]


@decoder("thermor")
def thermor(bits, dev):
    """Thermor DG950 weather station (ref src/devices/thermor.c)."""
    if bits.num_rows != 13:
        return DECODE_ABORT_EARLY
    b = []
    for row in range(13):
        if bits.bits_per_row[row] != 9:
            return DECODE_ABORT_EARLY
        if (int(bits.bb[row][0]) & 0x80) != 0:
            return DECODE_ABORT_EARLY
        b.append(int(bits.extract_bytes(row, 1, 8)[0]))
    b = [util.reverse8(x) for x in b]
    if (b[0] == 0xFF and b[1] == b[2] and b[1] == b[4] and b[1] == b[5]
            and b[1] == b[6] and b[1] == b[7] and b[1] == b[8]
            and b[1] == b[10]):
        return [Event.make(
            ("model", "Thermor-DG950"),
            ("id", ~b[1] & 0xFF, "", "%d"),
            ("pairing", 1, "Pairing?"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if ((b[1] + b[10]) & 0xFF) + 1 != (b[3] & 0xFF):
        return DECODE_ABORT_EARLY
    temp_c = (b[1] - 195) + (b[10] - 245) * 0.1
    rain_rate1 = ~b[2] & 0xFF
    if rain_rate1 != ((~b[12] & 0xFF) - 7):
        return DECODE_ABORT_EARLY
    have_wdir = wind_dir_d = 0
    if b[4] != 0xFF and b[5] != 0xFF:
        if b[4] != b[5]:
            return DECODE_ABORT_EARLY
        wind_dir_d = _THERMOR_WDIR[b[4] & 0x0F]
        have_wdir = 1
    # ~x on uint8 in C promotes to int; (~a + ~b + ~c) & 0xff
    if ((~b[6] + ~b[7] + ~b[8]) & 0xFF) != (~b[9] & 0xFF):
        return DECODE_ABORT_EARLY
    have_wspd = 0
    wind_speed_kmh = 0.0
    if b[8] != 0xFF:
        wind_speed_raw = (~b[6] & 0xFF) | ((~b[7] & 0xFF) << 8)
        wind_coef = ~b[8] & 0xFF
        if wind_speed_raw < 256:
            wind_ratio = wind_speed_raw * -0.0001746 + 0.155
        else:
            wind_ratio = 0.11
        wind_speed_kmh = max(
            wind_ratio * (wind_speed_raw - wind_coef + 45), 0.0)
        have_wspd = 1
    return [Event.make(
        ("model", "Thermor-DG950"),
        ("id", ~b[0] & 0xFF, "", "%d"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("rain_rate_mm_h", rain_rate1 * 0.1, "Rain Rate", "%.1f mm/h"),
        ("wind_dir_deg", wind_dir_d, "Wind Direction") if have_wdir
        else None,
        ("wind_avg_km_h", wind_speed_kmh, "Wind avg speed", "%.1f km/h")
        if have_wspd else None,
        ("pairing", 0, "Pairing?"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("celsia_czc1")
def celsia_czc1(bits, dev):
    """Celsia CZC1 thermostat (ref src/devices/celsia_czc1.c)."""
    if bits.num_rows > 1 or bits.bits_per_row[0] < 144:
        return DECODE_ABORT_EARLY
    pre_end = bits.search(
        0, 0, bytes([0xCC, 0xCC, 0xCC, 0xCC, 0x55, 0x55, 0x55, 0x55]),
        64) + 64
    if pre_end >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if pre_end + 132 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    raw = _ints(bits.bb[0])
    n_bytes = bits.bits_per_row[0] >> 3
    out_bits = []
    sym = {0x55: (0, 0), 0x5A: (0, 1), 0xA5: (1, 0), 0xAA: (1, 1)}
    for ipos in range(pre_end >> 3, n_bytes):
        if raw[ipos] == 0xF0:
            break
        if raw[ipos] in sym:
            out_bits.extend(sym[raw[ipos]])
    b = [0] * 16
    for i, bit in enumerate(out_bits[:128]):
        if bit:
            b[i >> 3] |= 0x80 >> (i & 7)
    if util.crc8(bytes(b[:8]), 8, 0x31, 0xD7) != 0:
        return DECODE_FAIL_MIC
    if b[2] != 0x00 and b[2] != 0xF0:
        return DECODE_FAIL_OTHER
    heat_ok = b[2] == 0xF0
    return [Event.make(
        ("model", "Celsia-CZC1"),
        ("id", (b[0] << 8) | b[1], "", "%x"),
        ("heat", util.reverse8(b[3]), "Heat") if heat_ok else None,
        ("mic", "CRC", "Integrity"),
    )]

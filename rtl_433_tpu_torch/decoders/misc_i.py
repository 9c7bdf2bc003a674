"""Misc decoders batch I (reference files cited per function):
BM5 battery monitor, Oria WA150KM, Arexx Multilogger, Chamberlain
CWPIRC, Revolt ZX-7717.
"""

from __future__ import annotations

import math

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


@decoder("bm5")
def bm5(bits, dev):
    """BM5-v2 12V battery monitor (ref src/devices/bm5.c)."""
    bits.invert()
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 88:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 0, 88))
    if b[0] == 0 and b[1] == 0 and b[2] == 0 and b[10] == 0:
        return DECODE_FAIL_MIC
    if (util.add_bytes(bytes(b[:10])) & 0xFF) != b[10]:
        return DECODE_FAIL_MIC
    soh = b[3] >> 1
    soc = b[4] >> 1
    temp = b[5] >> 1
    if b[5] & 0x01:
        temp = -temp
    battery_volt = ((b[7] << 8) | b[6]) * 0.000625
    starting_volt = ((b[9] << 8) | b[8]) * 0.000625
    if (soh > 100 or soc > 100 or battery_volt > 20.0
            or starting_volt > 20.0):
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "BM5-v2"),
        ("id", (b[0] << 16) | (b[1] << 8) | b[2], "Device_ID", "%X"),
        ("health_pct", soh, "State of Health", "%d %%"),
        ("cranking_error", b[4] & 0x01, "Cranking System Error"),
        ("charge_pct", soc, "State of Charge", "%d %%"),
        ("charging_error", b[3] & 0x01, "Charging System Error"),
        ("temperature_C", float(temp), "Temperature", "%.1f C"),
        ("battery_V", battery_volt, "Current Battery Voltage", "%.2f V"),
        ("starting_V", starting_volt, "Starting Voltage", "%.2f V"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _oria_reflect4(n):
    return (((n & 0x1) << 3) | ((n & 0x2) << 1) | ((n & 0x4) >> 1)
            | ((n & 0x8) >> 3))


@decoder("oria_wa150km")
def oria_wa150km(bits, dev):
    """Oria WA150KM fridge thermometer (ref src/devices/oria_wa150km.c)."""
    r = -1
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] == 227:
            r = i
            break
    if r < 0:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if b[0] != 0xAA or b[1] != 0xAA or b[2] != 0xAA:
        return DECODE_ABORT_EARLY
    if b[227 // 8 - 1] != 0x69:
        return DECODE_ABORT_EARLY
    bits.invert()
    mbuf = BitBuffer()
    bits.manchester_decode(r, 0, mbuf, 227)
    m = _ints(mbuf.bb[0])

    def nib(k):
        return (m[k // 2] >> 4) & 0x0F if k % 2 == 0 else m[k // 2] & 0x0F

    s = sum(_oria_reflect4(nib(7 + i)) for i in range(15))
    chk_recv = _oria_reflect4(nib(22)) | (_oria_reflect4(nib(23)) << 4)
    if (s & 0xFF) != chk_recv:
        return DECODE_FAIL_MIC
    b = [util.reverse8(x) for x in m]
    temperature = (((b[8] >> 4) & 0x0F) * 10 + (b[8] & 0x0F)) \
        + ((b[7] >> 4) & 0x0F) * 0.1
    if b[9] & 0x08:
        temperature = -temperature
    return [Event.make(
        ("model", "Oria-WA150KM"),
        ("id", b[6], ""),
        ("channel", ((b[5] >> 4) & 0x0F) + 1, ""),
        ("temperature", temperature, "", "%.1f C"),
        ("mic", "CHECKSUM", ""),
    )]


@decoder("arexx_ml")
def arexx_ml(bits, dev):
    """Arexx Multilogger (ref src/devices/arexx_ml.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 64 or bits.bits_per_row[0] > 140:
        return DECODE_ABORT_EARLY
    bits.invert()
    msg_len = -1
    b = [0] * 9
    for i in range(bits.num_rows):
        pos = bits.search(i, 0, bytes([0xAA, 0xAA, 0x55]), 24) + 24
        if pos + 64 > bits.bits_per_row[i]:
            continue
        b = _ints(bits.extract_bytes(i, pos, 9 * 8))
        msg_len = b[0]
        break
    if msg_len <= 0:
        return DECODE_FAIL_SANITY
    if msg_len > 7:
        return DECODE_FAIL_SANITY
    if util.crc8le(bytes(b[:msg_len]), msg_len, 0x31, 0x00) != b[msg_len]:
        return DECODE_FAIL_MIC
    aid = (b[2] << 8) | b[1]
    sens_val = (b[3] << 8) | b[4]
    temp_c = 0.0
    humidity = 0.0
    is_humi = is_temp = is_alert = 0
    temp_alert = 0
    if msg_len == 5 and (aid & 0xF000) == 0x2000:
        is_temp = 1
        temp_c = _s16(sens_val) * 0.0078125
    elif msg_len == 5 and (aid & 0xF001) == 0x4000:
        is_temp = 1
        temp_c = sens_val * 0.01 - 40.0
    elif msg_len == 5 and (aid & 0xF001) == 0x4001:
        is_humi = 1
        sens_val = _s16(sens_val)
        humidity = -2.0468 + 0.0367 * sens_val \
            - 1.5955E-6 * sens_val * sens_val
    elif msg_len == 6:
        is_temp = is_alert = 1
        temp_alert = (sens_val >> 13) & 7
        temp_raw = _s16((sens_val << 3) & 0xFFFF)
        temp_c = float(math.trunc(temp_raw / 128))
    elif msg_len == 7:
        aid = (b[3] << 16) | (b[2] << 8) | b[1]
        sens_val = (b[5] << 8) | b[6]
        if aid & 1:
            is_humi = 1
            sens_val = _s16(sens_val)
            humidity = -2.0468 + 0.0367 * sens_val \
                - 1.5955E-6 * sens_val * sens_val
        else:
            is_temp = 1
            temp_c = sens_val * 0.01 - 40.0
    return [Event.make(
        ("model", "Arexx-ML"),
        ("id", aid, "ID", "%06x"),
        ("temperature_C", temp_c, "Temperature", "%.2f C")
        if is_temp else None,
        ("temperature_alert", temp_alert, "Alert", "%x")
        if is_alert else None,
        ("humidity", humidity, "Humidity", "%.1f %%") if is_humi else None,
        ("sensor_raw", sens_val, "Sensor Raw", "%04x"),
        ("mic", "CRC", "Integrity"),
    )]


_CWPIRC_INVERT = {0x00: (1, 1, 0), 0x01: (0, 1, 0), 0x02: (0, 0, 1),
                  0x04: (1, 1, 1), 0x05: (1, 0, 1), 0x0A: (1, 0, 1),
                  0x06: (0, 1, 1), 0x08: (1, 0, 0), 0x09: (0, 0, 0)}
_CWPIRC_ORDER = {0x06: (2, 1, 0), 0x09: (2, 1, 0), 0x08: (1, 2, 0),
                 0x04: (1, 2, 0), 0x01: (2, 0, 1), 0x00: (0, 2, 1),
                 0x05: (1, 0, 2), 0x02: (0, 1, 2), 0x0A: (0, 1, 2)}


def _cwpirc_half_decode(h):
    """Security+ 2.0 half-message permutation
    (ref src/devices/chamberlain_cwpirc.c:70)."""
    h40 = ((h[0] << 32) | (h[1] << 24) | (h[2] << 16) | (h[3] << 8) | h[4])
    order_invert = (h40 >> 30) & 0xFF
    order = order_invert >> 4
    invert = order_invert & 0x0F
    x = h40 & 0x3FFFFFFF
    p = [0, 0, 0]
    for i in range(10):
        p[2] ^= (x & 1) << i
        x >>= 1
        p[1] ^= (x & 1) << i
        x >>= 1
        p[0] ^= (x & 1) << i
        x >>= 1
    if invert not in _CWPIRC_INVERT:
        return None
    inv = _CWPIRC_INVERT[invert]
    for k in range(3):
        if inv[k]:
            p[k] = (~p[k]) & 0x3FF
    if order not in _CWPIRC_ORDER:
        return None
    o = _CWPIRC_ORDER[order]
    vals = list(p)
    p = [vals[o[0]], vals[o[1]], vals[o[2]]]
    roll = [0] * 9
    for i in range(4):
        roll[i] = (order_invert >> (6 - 2 * i)) & 0x03
        if roll[i] == 3:
            return None
    for i in range(5):
        roll[4 + i] = (p[2] >> (8 - 2 * i)) & 0x03
        if roll[4 + i] == 3:
            return None
    return roll, (p[0] << 10) | p[1]


@decoder("chamberlain_cwpirc")
def chamberlain_cwpirc(bits, dev):
    """Chamberlain CWPIRC PIR sensor
    (ref src/devices/chamberlain_cwpirc.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    nbits = bits.bits_per_row[0]
    if nbits < 136:
        return DECODE_ABORT_LENGTH
    search_pos = bits.search(0, 0, bytes([0x55, 0x2D, 0xD4]), 24)
    if search_pos >= nbits:
        return DECODE_ABORT_EARLY
    b = None
    for shift in range(5):
        pos = search_pos + 24 + shift
        if pos + 14 * 8 > nbits:
            break
        cand = _ints(bits.extract_bytes(0, pos, 14 * 8))
        if cand[0] != 0 or cand[6] != 1:
            continue
        if util.crc16(bytes(cand), 14, 0x1021, 0x0000) != 0:
            continue
        b = cand
        break
    if b is None:
        return DECODE_FAIL_MIC
    half0 = _cwpirc_half_decode(b[1:6])
    half1 = _cwpirc_half_decode(b[7:12])
    if half0 is None or half1 is None:
        return DECODE_FAIL_SANITY
    roll0, fixed0 = half0
    roll1, fixed1 = half1
    fixed = (fixed0 << 20) | fixed1
    battery_low = (fixed & 0x20) != 0
    canonical_id = fixed & ~0x20
    rolling_digits = ([roll1[8], roll0[8]] + roll1[4:8] + roll0[4:8]
                      + roll1[0:4] + roll0[0:4])
    rolling_temp = 0
    for d in rolling_digits:
        rolling_temp = (rolling_temp * 3 + d) & 0xFFFFFFFF
    rolling = util.reverse32(rolling_temp) >> 4
    return [Event.make(
        ("model", "Chamberlain-CWPIRC", "Model"),
        ("id", "%010x" % canonical_id, ""),
        ("battery_ok", int(not battery_low), "Battery"),
        ("rolling", (rolling ^ 0x80000000) - 0x80000000 if rolling
         & 0x80000000 else rolling, "Rolling"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("revolt_zx7717")
def revolt_zx7717(bits, dev):
    """Revolt ZX-7717 power meter (ref src/devices/revolt_zx7717.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    row_len = bits.bits_per_row[0]
    if row_len < 15 * 8 or row_len > 22 * 8:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x2A]), 8) + 8
    if pos > 16:
        return DECODE_ABORT_LENGTH
    length = row_len - pos
    b = _ints(util.reflect_bytes(bytes(
        _ints(bits.extract_bytes(0, pos, length)))))
    b += [0] * (32 - len(b))
    msg_len = b[0]
    if msg_len < 1:
        return DECODE_FAIL_SANITY
    if length < (msg_len + 1) * 8:
        return DECODE_ABORT_LENGTH
    if b[msg_len] != (util.add_bytes(bytes(b[:msg_len])) & 0xFF):
        return DECODE_FAIL_MIC
    is_power = is_energy = 0
    current = voltage = power = energy_kwh = 0
    if msg_len == 13:
        is_power = 1
        current = (b[8] << 8) | b[7]
        voltage = (b[10] << 8) | b[9]
        power = (b[12] << 8) | b[11]
    elif msg_len == 14:
        is_energy = 1
        energy_kwh = (b[8] << 16) | (b[7] << 8) | b[6]
    elif msg_len == 17:
        is_power = 1
        current = (b[12] << 8) | b[11]
        voltage = (b[14] << 8) | b[13]
        power = (b[16] << 8) | b[15]
    elif msg_len == 18:
        is_energy = 1
        energy_kwh = (b[12] << 16) | (b[11] << 8) | b[10]
    else:
        return DECODE_FAIL_OTHER
    return [Event.make(
        ("model", "Revolt-ZX7717"),
        ("id", (b[2] << 8) | b[1], "Device ID"),
        ("version", b[3], "Version"),
        ("current_A", current * 0.001, "Current", "%.3f A")
        if is_power else None,
        ("voltage_V", voltage * 0.1, "Voltage", "%.1f V")
        if is_power else None,
        ("power_W", power * 0.1, "Power", "%.1f W") if is_power else None,
        ("energy_kWh", energy_kwh * 0.01, "energy_kWh", "%.2f kWh")
        if is_energy else None,
        ("mic", "CHECKSUM", "Integrity"),
    )]

"""Misc decoders batch H (reference files cited per function):
Dickert MAHS garage remote, FSL scoreboard, Oregon WMR500,
NetAtmo TH/wind, Omni multisensor.
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
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("dickert_pwm")
def dickert_pwm(bits, dev):
    """Dickert MAHS433-01 garage remote (ref src/devices/dickert_mahs.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 37:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 1, 36))
    trinary = "-0?+"
    dip_s = ""
    fac_s = ""
    for field in range(18):
        val = (b[field // 4] >> (2 * (3 - (field % 4)))) & 0x3
        if field < 10:
            dip_s += trinary[val]
        else:
            fac_s += trinary[val]
    return [Event.make(
        ("model", "Dickert-MAHS433"),
        ("id", (b[0] << 12) | (b[1] << 4) | (b[2] >> 4), ""),
        ("dipswitch", dip_s, "DIP switches"),
        ("facswitch", fac_s, "Factory code"),
    )]


@decoder("fsl_scoreboard")
def fsl_scoreboard(bits, dev):
    """FSL cricket scoreboard (ref src/devices/fsl_scoreboard.c)."""
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 700:
            continue
        preamble_pos = bits.search(row, 0, bytes([0xAA] * 4), 32)
        if preamble_pos + 38 + 72 >= bits.bits_per_row[row]:
            continue
        block_pos = preamble_pos + 38
        while block_pos + 72 < bits.bits_per_row[row]:
            if bits.search(row, block_pos, bytes([0xE0]), 3) != block_pos:
                block_pos += 72
                continue
            decoded = BitBuffer()
            bits.manchester_decode(row, block_pos + 3, decoded, 32)
            if decoded.bits_per_row[0] < 32:
                block_pos += 72
                continue
            b = _ints(decoded.extract_bytes(0, 0, 32))
            if ((b[0] >> 4) != 0x3 or (b[1] >> 4) != 0x2
                    or (b[2] >> 4) != 0x1 or (b[3] >> 4) != 0x0):
                block_pos += 72
                continue
            value = 0
            if (b[1] & 0xF) != 0xF:
                value += (b[1] & 0xF) * 100
            if (b[2] & 0xF) != 0xF:
                value += (b[2] & 0xF) * 10
            if (b[3] & 0xF) != 0xF:
                value += b[3] & 0xF
            return [Event.make(
                ("model", "FSL-Scoreboard"),
                ("id", b[0] & 0xF, "Field"),
                ("value", value, "Value"),
            )]
    return DECODE_ABORT_EARLY


@decoder("oregon_scientific_wmr500")
def oregon_scientific_wmr500(bits, dev):
    """Oregon Scientific WMR500
    (ref src/devices/oregon_scientific_wmr500.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bits.invert()
    row_len = bits.bits_per_row[0]
    pos = bits.search(0, 0, bytes([0x55, 0x2C, 0x6E, 0x2C, 0x6E]), 40)
    if pos >= row_len:
        return DECODE_ABORT_EARLY
    pos += 40
    if pos + 8 > row_len:
        return DECODE_ABORT_LENGTH
    avail = min((row_len - pos) // 8, 28)
    b = _ints(bits.extract_bytes(0, pos, avail * 8)) + [0] * (28 - avail)
    length = b[0]
    if length == 14:
        total_bytes, crc_init = 17, 0x4ED0
    elif length == 25:
        total_bytes, crc_init = 28, 0x1A4C
    else:
        return DECODE_ABORT_EARLY
    if avail < total_bytes:
        return DECODE_ABORT_LENGTH
    crc_calc = util.crc16(bytes(b[:total_bytes - 2]), total_bytes - 2,
                          0x8005, crc_init)
    if crc_calc != ((b[total_bytes - 2] << 8) | b[total_bytes - 1]):
        return DECODE_FAIL_MIC
    if length == 14:
        return DECODE_ABORT_EARLY  # short message not reported
    humidity = 208 - b[16]
    if humidity < 0 or humidity > 100:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Oregon-WMR500"),
        ("id", (b[8] << 8) | b[9], "", "%04x"),
        ("temperature_C", (b[14] - 169.0) * 0.7, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("netatmo_thw")
def netatmo_thw(bits, dev):
    """NetAtmo TH / wind sensors (ref src/devices/netatmo_thw.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0xE7, 0x12]), 32)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    length = int(bits.extract_bytes(0, start + 32, 8)[0])
    frame = [length] + _ints(
        bits.extract_bytes(0, start + 40, (length + 2) * 8))
    frame += [0] * (259 - len(frame))
    crc = util.crc16(bytes(frame[:length + 1]), length + 1, 0x8005, 0xFFFF)
    if ((frame[length + 1] << 8) | frame[length + 2]) != crc:
        return DECODE_FAIL_MIC
    b = frame
    nid = ((((b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4])
            ^ 0x80000000) - 0x80000000)
    signal = ((b[6] & 0xFF) ^ 0x80) - 0x80
    if length == 6:
        return [Event.make(
            ("model", "NetAtmo-TH"),
            ("id", nid, "ID Code", "%08x"),
            ("signal_dB", signal, "Signal", "%d dB"),
            ("mic", "CRC", "Integrity"),
        )]
    if length == 0x19:
        return [Event.make(
            ("model", "NetAtmo-TH"),
            ("id", nid, "House Code", "%08x"),
            ("battery_mV", (b[8] * 256 + b[7]) * 2, "Battery U", "%d mV"),
            ("signal_dB", signal, "Signal", "%d dB"),
            ("temperature_C", _s16((b[23] << 8) | b[22]) * 0.1,
             "Temperature", "%.01f C"),
            ("humidity", b[25], "Humidity", "%u %%"),
            ("mic", "CRC", "Integrity"),
        )]
    if length == 0x31:
        raw_a = _s16((b[26] << 8) | b[25])
        raw_b = _s16((b[28] << 8) | b[27])
        raw_c = _s16((b[30] << 8) | b[29])
        raw_d = _s16((b[32] << 8) | b[31])
        ws315 = raw_a + raw_b
        ws45 = raw_c + raw_d
        wind_speed = math.sqrt(ws45 * ws45 + ws315 * ws315) * 0.05
        wind_dir = int(math.atan2(ws45, ws315) / math.pi * 180 + 315) % 360
        return [Event.make(
            ("model", "NetAtmo-Wind"),
            ("id", nid, "ID Code", "%08x"),
            ("battery_mV", b[8] * 256 + b[7], "Battery U", "%d mV"),
            ("signal_dB", signal, "Signal", "%d dB"),
            ("raw_a_315", raw_a, "raw_a 315°", "%d"),
            ("raw_b_315", raw_b, "raw_b 315°", "%d"),
            ("raw_c_045", raw_c, "raw_c 045°", "%d"),
            ("raw_d_045", raw_d, "raw_d 045°", "%d"),
            ("wind_spd_km_h", wind_speed, "Wind Speed", "%.01f km/h"),
            ("wind_dir_deg", wind_dir, "Wind Dir", "%u °"),
            ("mic", "CRC", "Integrity"),
        )]
    return [Event.make(
        ("model", "NetAtmo-THW"),
        ("id", nid, "ID Code", "%08x"),
        ("signal_dB", signal, "Signal", "%d dB"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("omni")
def omni(bits, dev):
    """Omni multisensor (ref src/devices/omni.c)."""
    r = bits.find_repeated_row(2, 80)
    if r < 0 or bits.bits_per_row[r] > 82:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if util.crc8(bytes(b[:9]), 9, 0x97, 0xAA) != b[9]:
        return DECODE_FAIL_MIC
    message_fmt = b[0] >> 4
    oid = b[0] & 0x0F
    volts = b[8] * 0.01 + 3.00
    itemp_c = (_s16((b[1] << 8) | b[2]) >> 4) * 0.10
    if message_fmt == 0x00:
        return [Event.make(
            ("model", "Omni-Multisensor"),
            ("id", oid, "Id"),
            ("channel", message_fmt, "Format"),
            ("temperature_C", itemp_c, "Core Temperature", "%.2f ˚C"),
            ("voltage_V", volts, "VCC voltage", "%.2f V"),
            ("payload", "".join("%02x" % x for x in b[1:9]), "Payload"),
            ("mic", "CRC", "Integrity"),
        )]
    if message_fmt == 0x01:
        otemp_c = (_s16((b[2] << 12) | (b[3] << 4)) >> 4) * 0.10
        return [Event.make(
            ("model", "Omni-Multisensor"),
            ("id", oid, "Id"),
            ("channel", message_fmt, "Format"),
            ("temperature_C", itemp_c, "Indoor Temperature",
             "%.2f ˚C"),
            ("temperature_2_C", otemp_c, "Outdoor Temperature",
             "%.2f ˚C"),
            ("humidity", float(b[4]), "Indoor Humidity", "%.0f %%"),
            ("light_pct", float(b[5]), "Light", "%.0f %%"),
            ("pressure_hPa", ((b[6] << 8) | b[7]) * 0.10,
             "BarometricPressure", "%.1f hPa"),
            ("voltage_V", volts, "VCC voltage", "%.2f V"),
            ("mic", "CRC", "Integrity"),
        )]
    return [Event.make(
        ("model", "Omni-Multisensor"),
        ("id", oid, "Id"),
        ("channel", message_fmt, "Format"),
        ("payload", "".join("%02x" % x for x in b[1:9]), "Payload"),
        ("mic", "CRC", "Integrity"),
    )]

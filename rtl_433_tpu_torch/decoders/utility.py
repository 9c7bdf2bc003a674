"""Utility metering / monitoring decoders (reference files cited per
function): Watts WFHT-RF thermostat, Watchman Sonic Advanced, Apollo
Ultrasonic Smart oil monitor, Flowis water meter, Eco-Eye PV monitor.
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
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _i32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("watts_thermostat")
def watts_thermostat(bits, dev):
    """Watts WFHT-RF thermostat (ref src/devices/watts_thermostat.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bits.invert()
    if bits.bits_per_row[0] != 54:
        return DECODE_ABORT_LENGTH
    if int(bits.extract_bytes(0, 0, 8)[0]) != 0xA5:
        return DECODE_ABORT_EARLY
    id_raw = [util.reverse8(x) for x in _ints(bits.extract_bytes(0, 8, 16))]
    flags = util.reverse8(int(bits.extract_bytes(0, 24, 4)[0]))
    temp_raw = [util.reverse8(x)
                for x in _ints(bits.extract_bytes(0, 28, 9))]
    setp_raw = [util.reverse8(x)
                for x in _ints(bits.extract_bytes(0, 37, 9))]
    chk = util.reverse8(int(bits.extract_bytes(0, 46, 8)[0]))
    chksum = (sum(id_raw) + flags + sum(temp_raw) + sum(setp_raw)) & 0xFF
    if chk != chksum:
        return DECODE_FAIL_MIC
    sensor_id = (id_raw[1] << 8) | id_raw[0]
    temp = (temp_raw[1] << 8) | temp_raw[0]
    setp = (setp_raw[1] << 8) | setp_raw[0]
    if sensor_id == 0 and flags == 0 and temp == 0 and setp == 0 and chk == 0:
        return DECODE_ABORT_EARLY
    return [Event.make(
        ("model", "Watts-WFHTRF", "Model"),
        ("id", sensor_id, "ID"),
        ("pairing", flags & 1, "Pairing"),
        ("temperature_C", temp * 0.1, "Temperature", "%.1f C"),
        ("setpoint_C", setp * 0.1, "Setpoint", "%.1f C"),
        ("flags", flags, "Flags"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("oil_watchman_advanced")
def oil_watchman_advanced(bits, dev):
    """Watchman Sonic Advanced/Plus, Tekelek oil monitor
    (ref src/devices/oil_watchman_advanced.c)."""
    pre = bytes([0xAA, 0xAA, 0xAA, 0x2D, 0xD4, 0x0E])
    bitpos = 0
    events = []
    while True:
        bitpos = bits.search(0, bitpos, pre, 48)
        if bitpos + 128 + 1 > bits.bits_per_row[0]:
            break
        bitpos += 40
        b = _ints(bits.extract_bytes(0, bitpos, 128 + 8 + 1))
        bitpos += 128 + 8
        crc_msg = (b[15] << 8) | b[16]
        crc_calc = util.crc16(bytes(b[:15]), 15, 0x8005, 0)
        if crc_calc != crc_msg:
            # shifted-CRC fallback (ref upstream rtl_433 #3525)
            crc_msg2 = ((b[15] << 9) | (b[16] << 1) | (b[17] >> 7)) & 0xFFFF
            if crc_calc != crc_msg2:
                return DECODE_FAIL_MIC
        mcode = (b[1] << 8) | b[2]
        if mcode != 0x0401 and mcode != 0x0106:
            return DECODE_FAIL_SANITY
        events.append(Event.make(
            ("model", "Oil-SonicAdv", "Model"),
            ("id", (b[3] << 16) | (b[4] << 8) | b[5], "ID", "%08d"),
            ("version", "%u.%u.%u.%u" % (b[11] & 0x0F, b[12] & 0x0F,
                                         b[13] & 0x0F, b[14] & 0x0F),
             "Version"),
            # C: (b[7] - 0x48) / 2 is integer division truncating toward 0
            ("temperature_C", float(int((b[7] - 0x48) / 2)), "Temperature",
             "%.1f C"),
            ("depth_cm", ((b[9] & 0x0F) << 8) | b[10], "Depth"),
            ("status", b[6], "Status", "%02x"),
            ("mic", "CRC", "Integrity"),
        ))
    return events if events else 0


@decoder("oil_smart")
def oil_smart(bits, dev):
    """Apollo Ultrasonic Smart oil monitor (ref src/devices/oil_smart.c)."""
    events = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0x55, 0x58]), 16)
        if bitpos + 128 > bits.bits_per_row[0]:
            break
        out = BitBuffer()
        bits.manchester_decode(0, bitpos + 16, out, 64)
        bitpos += 2
        if out.bits_per_row[0] < 64:
            continue
        b = _ints(out.bb[0])
        if util.crc8le(bytes(b[:8]), 8, 0x31, 0x00):
            continue
        events.append(Event.make(
            ("model", "Oil-Ultrasonic"),
            ("id", _i32((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]),
             "", "%08x"),
            ("depth_cm", ((b[5] & 0x01) << 8) + b[6], "Depth"),
            ("txstatus", "Rapid" if (b[4] & 0x40) else "Normal",
             "TxStatus"),
            ("temp_ok", int((b[4] & 0x10) != (b[4] & 0x20)), "temp_ok"),
            ("battery_ok", (b[4] & 0x04) >> 2, "Battery"),
            ("sensor", b[4] & 0x03, "Sensor?"),
            ("counter", (b[5] & 0xF0) >> 4, "Counter"),
            ("unknown", (b[5] & 0x0D) >> 1, "unknown"),
            ("mic", "CRC", "Integrity"),
        ))
    return events if events else 0


@decoder("flowis")
def flowis(bits, dev):
    """Flowis water meter (ref src/devices/flowis.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pre = bytes([0xAA, 0xAA, 0xD3, 0x91, 0xD3, 0x91])
    start = bits.search(0, 0, pre, 48)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    length = int(bits.extract_bytes(0, start + 48, 8)[0])
    frame = [length] + _ints(
        bits.extract_bytes(0, start + 56, (length + 2) * 8))
    crc = util.crc16(bytes(frame[:length + 1]), length + 1, 0x8005, 0xFFFF)
    if ((frame[length + 1] << 8) | frame[length + 2]) != crc:
        return DECODE_FAIL_MIC
    b = frame
    if b[1] != 1:
        return DECODE_ABORT_EARLY
    fts = "%4d-%02d-%02dT%02d:%02d:%02d" % (
        (b[10] >> 2) + 2000, (b[9] >> 6) | ((b[10] & 3) << 2),
        (b[9] & 0x3E) >> 1, (b[8] >> 4) | ((b[9] & 1) << 4),
        ((b[8] & 0xF) << 2) | ((b[7] & 0xC0) >> 6), b[7] & 0x3F)
    return [Event.make(
        ("model", "Flowis"),
        ("id", _i32((b[5] << 24) | (b[4] << 16) | (b[3] << 8) | b[2]),
         "Meter id"),
        ("msg_type", b[1], "Message Type"),
        ("volume_m3", ((b[13] << 16) | (b[12] << 8) | b[11]) / 1000.0,
         "Volume", "%.3f m3"),
        ("device_time", fts, "Device time"),
        ("alarm", b[15], "Alarm"),
        ("backflow", b[14], "Backflow"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ecoeye")
def ecoeye(bits, dev):
    """Eco-Eye solar PV / grid current monitor
    (ref src/devices/ecoeye.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if start + 40 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, 40))
    if (util.add_bytes(bytes(msg[:4])) & 0xFF) != msg[4]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "EcoEye"),
        ("current_used_A", ((msg[2] << 8) | msg[3]) * 0.01, "Used",
         "%.2f A"),
        ("current_pv_A", ((msg[0] << 8) | msg[1]) * 0.01, "PV", "%.2f A"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

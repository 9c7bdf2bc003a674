"""Govee FSK gateway family (reference files cited per function):
H5059 water leak detector, H5310 pool/spa thermometer, H5112 dual-probe
thermometer. Shared framing: sync 2c4c4a, 128-byte XOR key stream,
CRC-16/AUG-CCITT.
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

_GOVEE_KEY = (b"s6amyEvO8UslCY0eZjgc2S6APCVLgLxzFvL2Z5GWPW7fKVjy2oAU6uiK"
              b"U3lZCHm62VYQQuCtgxzPgGd8UDRPVZpDRAsh5EdYq1E4j4morJ3vd6tW"
              b"x8BiWOLDc2I8wKUK")


def _ints(b):
    return [int(x) for x in b]


def _govee_frame(bits):
    """Find sync, check CRC, decrypt (ref src/devices/govee_h5059.c:160).
    Returns (frame, bytes_after_sync) or an error code."""
    row = -1
    sync_pos = 0
    for r in range(bits.num_rows):
        if bits.bits_per_row[r] < 8 * 7:
            continue
        pos = bits.search(r, 0, bytes([0x2C, 0x4C, 0x4A]), 24)
        if pos < bits.bits_per_row[r]:
            row, sync_pos = r, pos
            break
        skew = bits.search(r, 0, bytes([0x16, 0x26, 0x25]), 24)
        if skew < bits.bits_per_row[r]:
            row, sync_pos = r, skew + 1
            break
    if row < 0:
        return DECODE_ABORT_EARLY, None
    sync_pos += 24
    bits_after = bits.bits_per_row[row] - sync_pos
    if bits_after < 32:
        return DECODE_ABORT_LENGTH, None
    nbytes = min(bits_after // 8, 128)
    frame = _ints(bits.extract_bytes(row, sync_pos, nbytes * 8))
    return frame, nbytes


def _govee_decrypt(frame, nbytes, min_dec, max_dec):
    """Envelope validation + XOR decrypt. Returns (dec, enc_len) or err."""
    outer_len = frame[0]
    if outer_len < 4 or outer_len > 127:
        return DECODE_FAIL_SANITY, 0
    if nbytes < 1 + outer_len:
        return DECODE_ABORT_LENGTH, 0
    seed = frame[1]
    enc_len = outer_len - 3
    if enc_len < min_dec or enc_len > max_dec:
        return DECODE_FAIL_SANITY, 0
    crc_offs = 2 + enc_len
    crc_calc = util.crc16(bytes(frame[2:2 + enc_len]), enc_len, 0x1021,
                          0x1D0F)
    if crc_calc != ((frame[crc_offs] << 8) | frame[crc_offs + 1]):
        return DECODE_FAIL_MIC, 0
    dec = [frame[2 + i] ^ _GOVEE_KEY[(i + seed) % 128]
           for i in range(enc_len)]
    return dec, enc_len


@decoder("govee_h5059")
def govee_h5059(bits, dev):
    """Govee H5059 water leak detector (ref src/devices/govee_h5059.c)."""
    frame, nbytes = _govee_frame(bits)
    if isinstance(frame, int):
        return frame
    dec, enc_len = _govee_decrypt(frame, nbytes, 8, 64)
    if isinstance(dec, int):
        return dec
    if enc_len < 19:
        return DECODE_FAIL_SANITY
    msg_class = dec[0]
    id_wire = (dec[1] << 24) | (dec[2] << 16) | (dec[3] << 8) | dec[4]
    gid = ((id_wire & 0xFFFF) << 16) | ((id_wire >> 16) & 0xFFFF)
    subtype = dec[13] if enc_len > 13 else -1
    leak_top = dec[14] if enc_len > 14 else -1
    leak_bottom = dec[15] if enc_len > 15 else -1
    leak_alarm = dec[17] if enc_len > 17 else -1
    leak_status = -1
    if msg_class == 0x11:
        event = "Telemetry"
        if subtype == 0x05:
            event = "Button Press"
            leak_status = 0
        elif (subtype == 0x06 and leak_alarm != 0
              and (leak_top == 0x01 or leak_bottom == 0x01)):
            event = "Water Leak"
            leak_status = 1
        elif subtype == 0x07:
            event = "Post Alarm"
    elif msg_class == 0x01:
        event = "Pairing"
    elif msg_class == 0x02:
        event = "Class 0x02"
    else:
        return DECODE_ABORT_EARLY
    return [Event.make(
        ("model", "Govee-H5059"),
        ("id", "%08x" % gid, ""),
        ("id_wire", "%08x" % id_wire, ""),
        ("event", event, ""),
        ("msg_class", msg_class, "", "0x%02x"),
        ("subtype", subtype, "", "0x%02x") if subtype >= 0 else None,
        ("detect_wet", leak_status, "") if leak_status >= 0 else None,
        ("leak_top", int(leak_top == 0x01), "") if leak_status == 1
        else None,
        ("leak_bottom", int(leak_bottom == 0x01), "") if leak_status == 1
        else None,
        ("mic", "CRC", "Integrity"),
    )]


@decoder("govee_h5310")
def govee_h5310(bits, dev):
    """Govee H5310 pool/spa thermometer (ref src/devices/govee_h5310.c)."""
    frame, nbytes = _govee_frame(bits)
    if isinstance(frame, int):
        return frame
    outer_len = frame[0]
    is_temp = outer_len == 0x10
    is_periodic = outer_len == 0x3D
    is_status = outer_len == 0x1F
    if not (is_temp or is_periodic or is_status):
        return DECODE_ABORT_EARLY
    dec, enc_len = _govee_decrypt(frame, nbytes, 0, 128)
    if isinstance(dec, int):
        return dec
    expected_marker = 0x11 if is_temp else (0x1B if is_periodic else 0x71)
    if dec[0] != expected_marker:
        return DECODE_ABORT_EARLY
    id_wire = (dec[1] << 24) | (dec[2] << 16) | (dec[3] << 8) | dec[4]
    gid = ((id_wire & 0xFFFF) << 16) | ((id_wire >> 16) & 0xFFFF)
    if is_temp:
        battery_pct = dec[6]
        raw = dec[7] | (dec[8] << 8)
        event = "Temperature Update"
    elif is_periodic:
        battery_pct = dec[5]
        raw = dec[6] | (dec[7] << 8)
        event = "Periodic Update"
    else:
        if dec[8] != 0xCC or dec[9] != 0xFF:
            return DECODE_ABORT_EARLY
        battery_pct = dec[5]
        raw = dec[6] | (dec[7] << 8)
        event = "Status"
    temperature_c = (raw - 33168) / 10.0
    if temperature_c < -20.0 or temperature_c > 60.0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Govee-H5310"),
        ("id", "%08x" % gid, ""),
        ("id_wire", "%08x" % id_wire, ""),
        ("event", event, ""),
        ("battery_ok", int(battery_pct > 0), "Battery"),
        ("battery_pct", battery_pct, "Battery"),
        ("temperature_C", temperature_c, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("govee_h5112")
def govee_h5112(bits, dev):
    """Govee H5112 dual-probe thermometer
    (ref src/devices/govee_h5112.c)."""
    frame, nbytes = _govee_frame(bits)
    if isinstance(frame, int):
        return frame
    dec, enc_len = _govee_decrypt(frame, nbytes, 10, 128)
    if isinstance(dec, int):
        return dec
    msg_class = dec[0]
    if msg_class not in (0x13, 0x71):
        return DECODE_ABORT_EARLY
    if ((msg_class == 0x13 and enc_len != 57)
            or (msg_class == 0x71 and enc_len != 28)):
        return DECODE_ABORT_EARLY
    id_wire = (dec[1] << 24) | (dec[2] << 16) | (dec[3] << 8) | dec[4]
    gid = ((id_wire & 0xFFFF) << 16) | ((id_wire >> 16) & 0xFFFF)
    battery_pct = dec[5]
    packed = dec[6] | (dec[7] << 8) | (dec[8] << 16) | (dec[9] << 24)
    probe2_c = (packed & 0x7FF) / 10.0 - 40.0
    probe1_c = ((packed >> 11) & 0x7FF) / 10.0 - 40.0
    humidity = ((packed >> 22) & 0x3FF) / 10.0
    if humidity > 100.0:
        return DECODE_FAIL_SANITY
    has_history = msg_class == 0x13 and enc_len >= 17 + 10 * 4
    hist_t1 = []
    hist_t2 = []
    hist_hum = []
    if has_history:
        for i in range(10):
            base = 17 + i * 4
            hp = (dec[base] | (dec[base + 1] << 8) | (dec[base + 2] << 16)
                  | (dec[base + 3] << 24))
            hist_t2.append((hp & 0x7FF) / 10.0 - 40.0)
            hist_t1.append(((hp >> 11) & 0x7FF) / 10.0 - 40.0)
            hist_hum.append(((hp >> 22) & 0x3FF) / 10.0)
    return [Event.make(
        ("model", "Govee-H5112"),
        ("id", "%08x" % gid, ""),
        ("id_wire", "%08x" % id_wire, ""),
        ("battery_ok", int(battery_pct > 0), "Battery"),
        ("battery_pct", battery_pct, "Battery"),
        ("temperature_C", probe1_c, "Temperature", "%.1f C"),
        ("temperature_2_C", probe2_c, "Temperature2", "%.1f C"),
        ("humidity", humidity, "Humidity", "%.1f %%"),
        ("temperature_C_history", hist_t1, "Temperature history")
        if has_history else None,
        ("temperature_2_C_history", hist_t2, "Temperature2 history")
        if has_history else None,
        ("humidity_history", hist_hum, "Humidity history")
        if has_history else None,
        ("mic", "CRC", "Integrity"),
    )]

"""Misc decoders batch N (reference files cited per function):
Elster/Honeywell R2S/REXU power meters (type-1 and type-2),
Apator Metra E-RM 30 / E-ITN 30.
"""

from __future__ import annotations

from ..bits import util
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    decoder,
)


import numpy as np


def _ints(b):
    return [int(x) for x in b]


def _vals_at_offsets(bits) -> np.ndarray:
    """Byte value starting at every bit offset of row 0 (zero-padded tail),
    vectorized — replaces the reference's per-position bit peeling."""
    row = bits.row_bytes(0)
    ba = np.unpackbits(row)
    ba = np.concatenate([ba, np.zeros(16, np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(ba, 8)
    w = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.uint8)
    return (win * w).sum(axis=1, dtype=np.int64)


_CRC16LSB_8408 = None


def _crc16lsb_8408_table():
    global _CRC16LSB_8408
    if _CRC16LSB_8408 is None:
        t = np.zeros(256, np.int64)
        for x in range(256):
            r = x
            for _ in range(8):
                r = (r >> 1) ^ 0x8408 if r & 1 else r >> 1
            t[x] = r
        _CRC16LSB_8408 = t
    return _CRC16LSB_8408


def _elster_scan(bits, xor, two_byte_len, min_len, max_len):
    """Sliding length+CRC16-LSB frame scan shared by both Elster formats
    (ref src/devices/elster_power_meter.c:125, :282): first bit position
    whose whitened length byte(s) and trailing CRC validate wins.

    All candidate positions are checked in one vectorized pass: the
    byte-at-every-offset table feeds a column-wise table-driven CRC over
    the candidate set.
    """
    row_bits = bits.bits_per_row[0]
    head = 2 if two_byte_len else 1
    n_pos = row_bits - (min_len + 2) * 8 + 1
    if n_pos <= 0:
        return None, 0
    vals = _vals_at_offsets(bits)
    pos = np.arange(n_pos)
    if two_byte_len:
        cl = ((vals[:n_pos] ^ xor) << 8) | (vals[8:n_pos + 8] ^ xor)
    else:
        cl = vals[:n_pos] ^ xor
    ok = (cl >= min_len) & (cl <= max_len) & (pos + (cl + 2) * 8 <= row_bits)
    cand = np.flatnonzero(ok)
    if cand.size == 0:
        return None, 0
    cl_c = cl[cand]
    expected = ((vals[cand + cl_c * 8] ^ xor)
                | ((vals[cand + (cl_c + 1) * 8] ^ xor) << 8))
    table = _crc16lsb_8408_table()
    crc = np.full(cand.size, 0xFFFF, np.int64)
    passing = np.zeros(cand.size, bool)
    for j in range(int(cl_c.max())):
        feed = cl_c > j
        # finished lanes may index past the table; clamp (value unused)
        bj = vals[np.minimum(cand + j * 8, vals.size - 1)] ^ xor
        nxt = (crc >> 8) ^ table[(crc ^ bj) & 0xFF]
        crc = np.where(feed, nxt, crc)
        done = cl_c == j + 1
        if done.any():
            passing |= done & ((crc ^ 0xFFFF) == expected)
    hits = np.flatnonzero(passing)
    if hits.size == 0:
        return None, 0
    p = int(cand[hits[0]])
    length = int(cl_c[hits[0]])
    buf = [int(v) ^ xor for v in vals[p + np.arange(length + 2) * 8]]
    return buf, length


@decoder("elster_power_meter")
def elster_power_meter(bits, dev):
    """Elster/Honeywell R2S/REXU type-1
    (ref src/devices/elster_power_meter.c:125)."""
    min_len, max_len = 9, 200
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    row_bits = bits.bits_per_row[0]
    if row_bits < (min_len + 2) * 8:
        return DECODE_ABORT_LENGTH
    buf, length = _elster_scan(bits, 0x55, False, min_len, max_len)
    if buf is None:
        return DECODE_FAIL_MIC
    flags = buf[1]
    src = (buf[2] << 24) | (buf[3] << 16) | (buf[4] << 8) | buf[5]
    dst = (buf[6] << 24) | (buf[7] << 16) | (buf[8] << 8) | buf[9]
    is_beacon = length == 40 and flags == 0x08 and dst == 0
    data_raw = "".join("%02x" % buf[10 + i] for i in range(length - 10))
    has_reading = has_hourly = False
    meter_kwh = 0.0
    ctr = cur_hour = last_hour = 0
    hourly_str = ""
    if not (src & 0x80000000) and length - 1 > 15:
        cmd_start = 15
        cmd_len = buf[1 + cmd_start]
        if cmd_len == 0x33 and length - 1 >= cmd_start + 1 + cmd_len:
            cmd = buf[1 + cmd_start + 1:]
            cmd_id = cmd[1]
            if cmd_id == 0xCE and cmd_len >= 10:
                ctr = cmd[2]
                cur_hour = (cmd[5] << 8) | cmd[6]
                last_hour = (cmd[7] << 8) | cmd[8]
                n_hours = min(cmd[9], 17)
                has_hourly = True
                parts = []
                h = 0
                while h < n_hours and cmd_len >= 10 + 2 * (h + 1):
                    raw = (cmd[10 + 2 * h] << 8) | cmd[10 + 2 * h + 1]
                    parts.append("%.2f" % (raw * 0.01))
                    h += 1
                hourly_str = ",".join(parts)
            if cmd_id == 0xCE and cmd_len >= 47:
                meter_kwh = float((cmd[44] << 16) | (cmd[45] << 8)
                                  | cmd[46])
                has_reading = True
    return [Event.make(
        ("model", "Elster-PowerMeter"),
        ("id", "%u" % src, "Meter ID"),
        ("dst", "%u" % dst, "Collector ID (LAN ID)"),
        ("flags", flags, "Flags", "%02x"),
        ("frame_type", "beacon", "Frame Type") if is_beacon else None,
        ("ctr", ctr, "Counter") if has_hourly else None,
        ("cur_hour", cur_hour, "Current Hour") if has_hourly else None,
        ("last_hour", last_hour, "Last Hour") if has_hourly else None,
        ("hourly_kWh", hourly_str, "Hourly") if has_hourly else None,
        ("reading_kWh", meter_kwh, "Reading", "%.0f kWh")
        if has_reading else None,
        ("data_raw", data_raw, "Undecoded data"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("elster_power_meter2")
def elster_power_meter2(bits, dev):
    """Elster/Honeywell R2S/REXU type-2
    (ref src/devices/elster_power_meter.c:282)."""
    min_len, max_len, nbr_max = 12, 200, 8
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    row_bits = bits.bits_per_row[0]
    if row_bits < (min_len + 2) * 8:
        return DECODE_ABORT_LENGTH
    buf, length = _elster_scan(bits, 0xAA, True, min_len, max_len)
    if buf is None:
        return DECODE_FAIL_MIC
    src = (buf[3] << 24) | (buf[4] << 16) | (buf[5] << 8) | buf[6]
    dst = (buf[7] << 24) | (buf[8] << 16) | (buf[9] << 8) | buf[10]
    is_mesh = int((src & 0x80000000) != 0)
    msg = -1
    if not is_mesh and length > 16:
        msg = buf[16]
    nbr_ids = ""
    if msg in (0x57, 0x7F) and length > 30:
        n = buf[28]
        rec_start = 30 if msg == 0x57 else 29
        if 0 < n <= nbr_max and rec_start + n * 20 <= length:
            nbr_ids = ",".join(
                "%02x%02x%02x%02x" % tuple(buf[rec_start + i * 20:
                                              rec_start + i * 20 + 4])
                for i in range(n))
    data_raw = "".join("%02x" % buf[12 + i] for i in range(length - 12))
    return [Event.make(
        ("model", "Elster-PowerMeter2"),
        ("id", "%u" % src, "Meter ID"),
        ("dst", "%u" % dst, "Collector ID (LAN ID)"),
        ("mesh", is_mesh, "Mesh Frame"),
        ("msg", "%02x" % msg, "Message Class") if msg >= 0 else None,
        ("nbr_ids", nbr_ids, "Neighbour IDs") if nbr_ids else None,
        ("data_raw", data_raw, "Undecoded data"),
        ("mic", "CRC", "Integrity"),
    )]


_APATOR_WHITEN = [0xFF, 0xE1, 0x1D, 0x9A, 0xED, 0x85, 0x33, 0x24, 0xEA,
                  0x7A, 0xD2, 0x39, 0x70, 0x97, 0x57, 0x0A, 0x54, 0x7D,
                  0x2D, 0xD8, 0x6D, 0x0D]
_APATOR_NIBBLE = [0x0, 0x7, 0xF, 0x9, 0xE, 0xD, 0x3, 0x4, 0x2, 0x6, 0xC,
                  0xB, 0x1, 0x8, 0xA, 0x5]


def _apator_metra_frame(bits, want_len, max_len):
    """Shared sync scan + unwhiten + CRC + nibble substitution
    (ref src/devices/apator_metra_erm30.c:94)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pre = bytes([0xAA, 0xAA, 0x69, 0x9A])
    start = bits.search(0, 0, pre, 32)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    start += 32
    length = int(bits.extract_bytes(0, start, 8)[0]) ^ 0xFF
    if length != want_len:
        return DECODE_ABORT_EARLY
    frame = _ints(bits.extract_bytes(0, start, 8 * max_len))
    frame += [0] * (max_len - len(frame))
    for i in range(length + 3):
        frame[i] ^= _APATOR_WHITEN[i]
    frame_crc = (frame[length + 1] << 8) | frame[length + 2]
    if frame_crc != util.crc16(bytes(frame[:length + 1]), length + 1,
                               0x8005, 0xFFFF):
        return DECODE_FAIL_MIC
    p = [0] * max_len
    for i in range(2 * length):
        shift = 0 if (i % 2) else 4
        p[i // 2] |= _APATOR_NIBBLE[(frame[1 + i // 2] >> shift) & 0xF] << shift
    return p


@decoder("apator_metra_erm30")
def apator_metra_erm30(bits, dev):
    """Apator Metra E-RM 30 water meter
    (ref src/devices/apator_metra_erm30.c)."""
    p = _apator_metra_frame(bits, 0x13, 22)
    if isinstance(p, int):
        return p
    mid = ((p[3] << 24) | (p[2] << 16) | (p[1] << 8) | p[0]) ^ 0x30000000
    vol_raw = (((p[7] << 24) | (p[6] << 16) | (p[5] << 8) | p[4])
               & 0x0FFFFFFF) >> 3
    date = (p[16] << 8) | p[15]
    date_str = "%04d-%02d-%02d" % (2000 + ((date >> 9) & 0x7F),
                                   (date >> 5) & 0x0F, date & 0x1F)
    return [Event.make(
        ("model", "ApatorMetra-ERM30"),
        ("id", (mid ^ 0x80000000) - 0x80000000, "ID", "%09d"),
        ("len", 0x13, "Frame length"),
        ("volume_m3", vol_raw / 1000.0, "Volume", "%.3f m3"),
        ("date", date_str, "Date"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("apator_metra_eitn30")
def apator_metra_eitn30(bits, dev):
    """Apator Metra E-ITN 30 heat cost allocator
    (ref src/devices/apator_metra_eitn30.c)."""
    p = _apator_metra_frame(bits, 0x11, 20)
    if isinstance(p, int):
        return p
    mid = ((p[3] << 24) | (p[2] << 16) | (p[1] << 8) | p[0]) ^ 0x38000000
    current = (p[11] << 8) | p[10]
    last_yr = (p[5] << 8) | p[4]
    date = (p[13] << 8) | p[12]
    date_str = "%04d-%02d-%02d" % (2000 + ((date >> 9) & 0x7F),
                                   (date >> 5) & 0x0F, date & 0x1F)
    return [Event.make(
        ("model", "ApatorMetra-EITN30"),
        ("id", (mid ^ 0x80000000) - 0x80000000, "ID", "%09d"),
        ("len", 0x11, "Frame length"),
        ("current_heating", current, "Current Heating"),
        ("last_yr_heating", last_yr, "Last Year Heating"),
        ("date", date_str, "Date"),
        ("mic", "CRC", "Integrity"),
    )]

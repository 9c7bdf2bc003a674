"""Misc decoders batch D (reference files cited per function):
Auriol AFT77B2 / 4-LD5661 / HG04641A, Clipsal CMR113, Acurite 01185M
grill thermometer, Acurite 985 fridge/freezer, EcoDHOME.
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


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _aft77_lsrc(frame, length):
    """Reflected Galois LFSR, gen 0x83 key 0xEC
    (ref src/devices/auriol_aft77b2.c:57)."""
    result = 0
    key = 0xEC
    for i in range(length):
        byte = frame[i]
        mask = 0x80
        while mask > 0:
            if byte & mask:
                result ^= key
            if key & 1:
                key = (key >> 1) ^ 0x83
            else:
                key >>= 1
            mask >>= 1
    return result


@decoder("auriol_aft77b2")
def auriol_aft77b2(bits, dev):
    """Auriol AFT 77 B2 thermometer (ref src/devices/auriol_aft77b2.c)."""
    row = -1
    for r in range(bits.num_rows):
        if bits.bits_per_row[r] == 68:
            row = r
            break
    if row < 0:
        return DECODE_ABORT_EARLY
    ptr = _ints(bits.bb[row])
    if ptr[0] != 0xA5:
        return DECODE_ABORT_EARLY
    frame = [((ptr[i] << 4) | (ptr[i + 1] >> 4)) & 0xFF for i in range(8)]
    if (util.add_bytes(bytes(frame[:6])) & 0xFF) != frame[6]:
        return DECODE_FAIL_MIC
    if _aft77_lsrc(frame, 6) != frame[7]:
        return DECODE_FAIL_MIC
    temp_raw = (ptr[4] >> 4) * 100 + (ptr[4] & 0x0F) * 10 + (ptr[5] >> 4)
    if ptr[3] & 0x08:
        temp_raw = -temp_raw
    return [Event.make(
        ("model", "Auriol-AFT77B2"),
        ("id", frame[1], ""),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.2f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("auriol_4ld5661")
def auriol_4ld5661(bits, dev):
    """Auriol 4-LD5661 rain gauge (ref src/devices/auriol_4ld5661.c)."""
    ret = 0
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] != 52:
            ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[i])
        if b[3] != 0xF0 or (b[1] & 0x40) != 0:
            ret = DECODE_FAIL_MIC
            continue
        temp_raw = _s16(((b[1] & 0x0F) << 12) | (b[2] << 4))
        rain_raw = (b[4] << 12) | (b[5] << 4) | (b[6] >> 4)
        return [Event.make(
            ("model", "Auriol-4LD5661", "Model"),
            ("id", b[0], "ID", "%02x"),
            ("battery_ok", b[1] >> 7, "Battery OK"),
            ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature",
             "%.1f C"),
            ("rain_mm", rain_raw * 1.0, "Rain", "%.1f mm"),
            ("rain", rain_raw, "Rain tips"),
        )]
    return ret


@decoder("auriol_hg04641a")
def auriol_hg04641a(bits, dev):
    """Auriol HG04641A temperature station
    (ref src/devices/auriol_hg04641a.c)."""
    row = bits.find_repeated_row(2, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] < 36:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(row, 0, 36))
    b[4] >>= 4
    s = sum((x >> 4) + (x & 0xF) for x in b[:4])
    if (s & 0xF) != b[4]:
        return DECODE_FAIL_MIC
    flags = b[2] >> 4
    if (flags & 0x6) != 0 or not (flags & 0x1):
        return DECODE_FAIL_SANITY
    temp_decic = _s16(((b[2] & 0x0F) << 12) | (b[3] << 4)) >> 4
    if temp_decic < -400 or temp_decic > 600:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Auriol-HG04641A"),
        ("id", (b[0] << 8) | b[1], "", "%04x"),
        ("battery_ok", int(not (flags & 0x8)), "Battery"),
        ("temperature_C", temp_decic * 0.1, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("cmr113")
def cmr113(bits, dev):
    """Clipsal CMR113 cent-a-meter (ref src/devices/cmr113.c)."""
    if bits.bits_per_row[0] < 350 or bits.bits_per_row[0] > 450:
        return DECODE_ABORT_LENGTH
    buf = _ints(bits.extract_bytes(0, 0, 32))
    if buf[0] != 0xB0 or buf[1] != 0x00 or buf[2] != 0x00:
        return DECODE_ABORT_EARLY
    start = 0
    bit = 0
    out_bits = []
    while start + 3 < bits.bits_per_row[0]:
        b0 = int(bits.extract_bytes(0, start, 3)[0])
        if (b0 >> 6) == 0x00:
            start += 2
            out_bits.append(bit)
        elif (b0 >> 5) == 0x03:
            start += 3
            bit = 1 - bit
            out_bits.append(bit)
        elif start == 0:
            start += 1
        else:
            return DECODE_ABORT_LENGTH
    if len(out_bits) < 2 * 83 + 2:
        return DECODE_ABORT_LENGTH
    if out_bits[:83] != out_bits[85:85 + 83]:
        return DECODE_FAIL_MIC
    current = []
    for i in range(3):
        v = 0
        for k in range(10):
            v = (v << 1) | out_bits[36 + i * 10 + k]
        # 10 bits MSB-aligned in 2 bytes, then bit-reflected
        b0 = util.reverse8((v >> 2) & 0xFF)
        b1 = util.reverse8((v & 0x3) << 6)
        current.append((b0 + ((b1 & 0x3) << 8)) * 0.1)
    return [Event.make(
        ("model", "Clipsal-CMR113"),
        ("current_1_A", current[0], "Current 1", "%.1f A"),
        ("current_2_A", current[1], "Current 2", "%.1f A"),
        ("current_3_A", current[2], "Current 3", "%.1f A"),
    )]


@decoder("acurite_01185m")
def acurite_01185m(bits, dev):
    """Acurite 01185M grill/meat thermometer
    (ref src/devices/acurite_01185m.c)."""
    result = 0
    bits.invert()
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 56:
            result = DECODE_ABORT_LENGTH
            continue
        b = [util.reverse8(x) for x in _ints(bits.bb[row])[:7]]
        s = util.add_bytes(bytes(b[:6]))
        if (s & 0xFF) != b[6]:
            result = DECODE_FAIL_MIC
            continue
        if s == 0:
            return DECODE_FAIL_SANITY
        temp1_raw = (b[2] << 8) | b[3]
        temp2_raw = (b[4] << 8) | b[5]
        return [Event.make(
            ("model", "Acurite-01185M"),
            ("id", b[0], ""),
            ("channel", b[1] & 0x0F, ""),
            ("battery_ok", int(not (b[1] >> 7)), "Battery"),
            ("temperature_1_F", (temp1_raw - 900) * 0.1, "Meat", "%.1f F")
            if 200 < temp1_raw < 7000 else None,
            ("temperature_2_F", (temp2_raw - 900) * 0.1, "Ambient",
             "%.1f F") if 200 < temp2_raw < 7000 else None,
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return result


@decoder("acurite_985")
def acurite_985(bits, dev):
    """Acurite/Chaney 985 fridge/freezer thermometer
    (ref src/devices/acurite.c:1759)."""
    events = []
    result = 0
    for brow in range(bits.num_rows):
        nbits = bits.bits_per_row[brow]
        if nbits < 55 or nbits > 59:
            result = DECODE_ABORT_LENGTH
            continue
        bb = _ints(bits.bb[brow])
        if (bb[2] == 0 and bb[3] == 0 and bb[4] == 0 and bb[5] == 0
                and bb[6] == 0):
            result = DECODE_ABORT_EARLY
            continue
        br = [util.reverse8(x) for x in bb[:7]]
        tempf = br[2]
        sensor_id = (br[3] << 8) | br[4]
        status = br[5]
        sensor_num = (status & 0x01) + 1
        if sensor_num == 2:
            battery_low = 1 if (status & 0x04) else 0
        else:
            battery_low = 1 if (status & 0x02) else 0
        channel_str = "2F" if sensor_num == 2 else "1R"
        crc = br[6]
        crcc = util.crc8le(bytes(br[2:6]), 4, 0x07, 0)
        if crcc != crc:
            # missing trailing 1-bit fix (ref acurite.c:1824)
            if crcc != (crc | 0x80):
                result = DECODE_FAIL_MIC
                continue
        if tempf & 0x80:
            tempf = -(tempf & 0x7F)
        if -40 <= tempf <= 104 or tempf in (-127, 127):
            pass
        else:
            result = DECODE_FAIL_SANITY
            continue
        events.append(Event.make(
            ("model", "Acurite-985"),
            ("id", sensor_id, ""),
            ("channel", channel_str, ""),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_F", float(tempf), "temperature", "%f F"),
            ("status", status, "Status"),
            ("mic", "CRC", "Integrity"),
        ))
    if events:
        return events
    return result


@decoder("ecodhome")
def ecodhome(bits, dev):
    """EcoDHOME smart socket / MCEE solar monitor
    (ref src/devices/ecodhome.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 128:
        return DECODE_ABORT_LENGTH
    start = bits.search(0, 0, bytes([0xAA, 0xAA, 0x2D, 0xD4]), 32) + 32
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if start + 12 * 8 >= bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start, 13 * 8))
    rid = (msg[0] << 24) | (msg[1] << 16) | (msg[2] << 8) | msg[3]
    rid = (rid ^ 0x80000000) - 0x80000000
    m_type = (msg[4] << 8) | msg[5]
    m_subtype = (msg[6] << 8) | msg[7]
    if m_type == 0x7700:
        if (util.add_bytes(bytes(msg[:11])) & 0xFF) != msg[11]:
            return DECODE_FAIL_MIC
        if msg[10] != 0x53:
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "EcoDHOME-SmartSocket"),
            ("id", rid, "", "%08x"),
            ("message_type", m_type, "Message Type", "%04x"),
            ("message_subtype", m_subtype, "Message Subtype", "%04x"),
            ("power_W", float((msg[9] << 8) | msg[8]), "Power", "%.1f W")
            if m_subtype == 0x414B else None,
            ("raw", (msg[8] << 8) | msg[9], "Raw data", "%06x"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    if ((util.add_bytes(bytes(msg[:9])) + 0x35) & 0xFF) != msg[9]:
        return DECODE_FAIL_MIC
    if msg[10] != 0x55:
        return DECODE_FAIL_SANITY
    if msg[11] != 0x00:
        return DECODE_FAIL_SANITY
    power_w = (((msg[7] - 0x33) & 0xFF) << 8) | ((msg[6] - 0x33) & 0xFF)
    return [Event.make(
        ("model", "EcoDHOME-Transmitter"),
        ("id", rid, "", "%08x"),
        ("message_type", m_type, "Message Type", "%04x"),
        ("power_W", float(power_w), "Power", "%.1f W")
        if m_type == 0x3EB3 else None,
        ("raw", (msg[6] << 16) | (msg[7] << 8) | msg[8], "Raw data",
         "%06x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

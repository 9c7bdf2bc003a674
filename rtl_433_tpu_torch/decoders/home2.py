"""Home sensors batch 2 (reference files cited per function):
Calibeur RF-104, Brennenstuhl RCS 2044, Danfoss CFR, RF-tech, Oil
Ultrasonic Standard, Biltema rain, Digitech XC-0324, Companion WTR001,
Rubicson 48659, GT-TMBBQ-05, GT-WT-03.
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
    DECODE_FAIL_OTHER,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("calibeur_RF104")
def calibeur_rf104(bits, dev):
    """Calibeur RF-104 (ref src/devices/calibeur.c)."""
    if bits.num_rows < 3:
        return DECODE_FAIL_SANITY
    b = _ints(bits.bb[1])
    if ((not b[0] and not b[1] and not b[2])
            or (b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF)):
        return DECODE_FAIL_SANITY
    bits.invert()
    b = _ints(bits.bb[1])
    b2 = _ints(bits.bb[2])
    if bits.bits_per_row[1] != 21:
        return DECODE_ABORT_LENGTH
    if util.crc8(bytes(b[:3]), 3, 0x80, 0) == 0:  # should be odd parity
        return DECODE_FAIL_MIC
    if b[0] != b2[0] or b[1] != b2[1] or b[2] != b2[2]:
        return DECODE_FAIL_SANITY
    v = (((b[0] & 0x80) >> 7) | ((b[0] & 0x40) >> 5) | ((b[0] & 0x20) >> 3)
         | ((b[0] & 0x10) >> 1) | ((b[0] & 0x08) << 1) | ((b[0] & 0x04) << 3))
    dev_id = v // 10
    temperature = (v % 10) * 0.1
    v = (((b[0] & 0x02) << 3) | ((b[0] & 0x01) << 5) | ((b[1] & 0x80) >> 7)
         | ((b[1] & 0x40) >> 5) | ((b[1] & 0x20) >> 3) | ((b[1] & 0x10) >> 1)
         | ((b[1] & 0x08) << 3))
    temperature += v - 41.0
    v = (((b[1] & 0x02) << 4) | ((b[1] & 0x01) << 6) | ((b[2] & 0x80) >> 7)
         | ((b[2] & 0x40) >> 5) | ((b[2] & 0x20) >> 3) | ((b[2] & 0x10) >> 1)
         | ((b[2] & 0x08) << 1))
    return [Event.make(
        ("model", "Calibeur-RF104"),
        ("id", dev_id, "ID"),
        ("temperature_C", temperature, "Temperature", "%.1f C"),
        ("humidity", float(v), "Humidity", "%.0f %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("brennenstuhl_rcs_2044")
def brennenstuhl_rcs_2044(bits, dev):
    """Brennenstuhl RCS 2044 (ref src/devices/brennenstuhl_rcs_2044.c)."""
    events = []
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 25:
            continue
        b = _ints(bits.bb[row])
        if ((b[0] & 0xAA) != 0xAA or (b[1] & 0xAA) != 0xAA
                or (b[2] & 0xAA) != 0xAA or b[3] != 0x80):
            continue
        system_code = (((b[0] & 0x40) >> 2) | ((b[0] & 0x10) >> 1)
                       | (b[0] & 0x04) | ((b[0] & 0x01) << 1)
                       | ((b[1] & 0x40) >> 6))
        control_key = ((b[1] & 0x10) | ((b[1] & 0x04) << 1)
                       | ((b[1] & 0x01) << 2) | ((b[2] & 0x40) >> 5)
                       | ((b[2] & 0x10) >> 4))
        key = {0x10: "A", 0x08: "B", 0x04: "C", 0x02: "D",
               0x01: "E"}.get(control_key)
        if key is None:
            continue
        on_off = ((b[2] & 0x04) >> 1) | (b[2] & 0x01)
        if on_off not in (0x01, 0x02):
            continue
        events.append(Event.make(
            ("model", "Brennenstuhl-RCS2044", "Model"),
            ("id", system_code, "id"),
            ("key", key, "key"),
            ("state", "ON" if on_off == 0x02 else "OFF", "state"),
        ))
    return events


_DANFOSS_NIBBLES = {
    0x0B: 0xD, 0x0D: 0xE, 0x0E: 0x3, 0x13: 0x4, 0x15: 0xA, 0x16: 0xF,
    0x19: 0x9, 0x1A: 0x6, 0x25: 0x0, 0x26: 0x7, 0x29: 0x1, 0x2A: 0x5,
    0x2C: 0xC, 0x31: 0xB, 0x32: 0x2, 0x34: 0x8,
}


@decoder("danfoss_CFR")
def danfoss_cfr(bits, dev):
    """Danfoss CFR thermostat (ref src/devices/danfoss.c)."""
    nbits = bits.bits_per_row[0]
    if not (246 <= nbits <= 260):
        return DECODE_ABORT_LENGTH
    off = bits.search(0, 112, bytes([0x36, 0x5C]), 16)
    if nbits - off < 126:
        return DECODE_ABORT_LENGTH
    off += 6
    by = []
    for n in range(10):
        hi = _DANFOSS_NIBBLES.get(
            int(bits.extract_bytes(0, n * 12 + off, 8)[0]) >> 2)
        lo = _DANFOSS_NIBBLES.get(
            int(bits.extract_bytes(0, n * 12 + off + 6, 8)[0]) >> 2)
        if hi is None or lo is None:
            return DECODE_FAIL_SANITY
        by.append((hi << 4) | lo)
    crc_calc = util.crc16(bytes(by[:8]), 8, 0x1021, 0x0000)
    if by[0] != 0x02 or crc_calc != ((by[8] << 8) | by[9]):
        return DECODE_FAIL_MIC
    str_sw = {2: "DAY", 4: "TIMER", 8: "NIGHT"}.get(by[3] & 0x0F, "ERROR")
    return [Event.make(
        ("model", "Danfoss-CFR"),
        ("id", (by[1] << 8) | by[2], "ID"),
        ("temperature_C", by[5] + by[4] / 256.0, "Temperature", "%.2f C"),
        ("setpoint_C", by[7] + by[6] / 256.0, "Setpoint", "%.2f C"),
        ("switch", str_sw, "Switch"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("rftech")
def rftech(bits, dev):
    """RF-tech / INFRA 217S34 (ref src/devices/rftech.c)."""
    r = bits.find_repeated_row(3, 24)
    if r < 0 or bits.bits_per_row[r] != 24:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    temp_c = (b[1] & 0x7F) + (b[2] & 0x0F) * 0.1
    if b[1] & 0x80:
        temp_c = -temp_c
    return [Event.make(
        ("model", "RF-tech"),
        ("id", b[0], "Id"),
        ("battery_ok", int((b[2] & 0x80) == 0x80), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("button", int((b[2] & 0x60) != 0), "Button"),
    )]


@decoder("oil_standard", "oil_standard_ask")
def oil_standard(bits, dev):
    """Apollo/Tekelek oil tank monitor (ref src/devices/oil_standard.c)."""
    def decode_at(bitpos):
        smart_pre = bytes([0x55, 0x55, 0x58])
        if bitpos >= 24 and bits.search(0, bitpos - 24, smart_pre, 24) == bitpos - 24:
            return 0
        databits = BitBuffer()
        bits.manchester_decode(0, bitpos, databits, 41)
        if (databits.bits_per_row[0] < 32 or databits.bits_per_row[0] > 40
                or (int(databits.bb[0][4]) & 0xFE) != 0):
            return 0
        b = _ints(databits.bb[0])
        flags = b[2] & ~0x0A
        depth = 0
        binding_countdown = 0
        if flags & 1:
            binding_countdown = b[3]
        else:
            depth = ((b[2] & 0x02) << 7) | b[3]
            if depth > 305:
                return 0
        return [Event.make(
            ("model", "Oil-SonicStd"),
            ("id", (b[0] << 8) | b[1], "", "%04x"),
            ("flags", flags, "", "%02x"),
            ("alarm", (b[2] & 0x08) >> 3),
            ("binding_countdown", binding_countdown),
            ("depth_cm", depth),
        )]

    events = []
    for pattern in (bytes([0x55, 0x5D]), bytes([0x55, 0x62])):
        bitpos = 0
        while True:
            bitpos = bits.search(0, bitpos, pattern, 16)
            if bitpos + 78 > bits.bits_per_row[0]:
                break
            ret = decode_at(bitpos + 14)
            if ret:
                events += ret
            bitpos += 2
    return events


@decoder("bt_rain")
def bt_rain(bits, dev):
    """Biltema rain gauge (ref src/devices/bt_rain.c)."""
    row = bits.find_repeated_row(4, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] not in (36, 37):
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF and b[3] == 0xFF:
        return DECODE_FAIL_SANITY
    temp_raw = _s16(((b[1] & 0x07) << 13) | (b[2] << 5))
    rain = ((b[1] & 0x07) << 4) | b[3]
    rest = rain % 25
    if rest % 2:
        rain += (rest // 2) * 2048
    else:
        rain += ((rest + 1) // 2) * 2048 + 12 * 2048
    button = (b[1] & 0x08) >> 3
    return [Event.make(
        ("model", "Biltema-Rain"),
        ("id", b[0], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("transmit", "MANUAL" if button else "AUTO", "Transmit"),
        ("temperature_C", (temp_raw >> 5) * 0.1, "Temperature", "%.1f C"),
        ("rain_rate_mm_h", rain * 0.052, "Rain per hour", "%.2f mm/h"),
        ("button", button, "Button"),
    )]


@decoder("digitech_xc0324")
def digitech_xc0324(bits, dev):
    """Digitech XC-0324 / AmbientWeather FT005TH (ref
    src/devices/digitech_xc0324.c)."""
    events = 0
    first = None
    ret = DECODE_FAIL_OTHER
    for r in range(bits.num_rows):
        if bits.bits_per_row[r] < 48:
            continue
        bitpos = 0
        while True:
            bitpos = bits.search(r, bitpos, bytes([0x5F]), 8)
            if bitpos + 48 > bits.bits_per_row[r]:
                break
            b = _ints(bits.extract_bytes(r, bitpos, 48))
            if util.xor_bytes(bytes(b[:6]), 6) != 0:
                ret = DECODE_FAIL_MIC
                bitpos += 48
                continue
            if first is None:
                temp = ((util.reverse8(b[3]) & 0x0F) << 8) | util.reverse8(b[2])
                first = Event.make(
                    ("model", "Digitech-XC0324", "Device Type"),
                    ("id", "%02X" % b[1], "ID"),
                    ("temperature_C", (temp - 400) * 0.1, "Temperature C",
                     "%.1f"),
                    ("humidity", util.reverse8(b[4]), "Humidity", "%u %%"),
                    ("mic", "CHECKSUM", "Integrity"),
                )
            events += 1
            bitpos += 48
    if events > 0:
        first.append(("message_num", events, "Message repeat count"))
        return [first]
    return ret


@decoder("companion_wtr001")
def companion_wtr001(bits, dev):
    """Companion WTR001 (ref src/devices/companion_wtr001.c)."""
    r = bits.find_repeated_row(3, 14)
    if r < 0 or bits.bits_per_row[r] != 14:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(r, 0, 14))
    b[0] = ~b[0] & 0xFF
    b[1] = ~b[1] & 0xFC
    if (b[0] & 0x04) == 0x04:
        return DECODE_FAIL_SANITY
    if not util.parity_bytes(bytes(b[:2]), 2):
        return DECODE_FAIL_MIC
    temp_tenth = util.reverse8(b[0] & 0xF8)
    if temp_tenth < 0x0A or temp_tenth > 0x13:
        return DECODE_FAIL_SANITY
    temp_tenth -= 0x0A
    temp_whole = (util.reverse8(b[1] & 0xF0) | (util.reverse8(b[0] & 0x03) >> 2)
                  | ((b[1] & 0x08) << 3)) & 0xFF
    if temp_whole < 11 or temp_whole > 111:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Companion-WTR001"),
        ("temperature_C", (temp_whole + temp_tenth * 0.1) - 41.0,
         "Temperature", "%.1f C"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("rubicson_48659")
def rubicson_48659(bits, dev):
    """Rubicson 48659 meat thermometer (ref src/devices/rubicson_48659.c)."""
    row = bits.find_repeated_row(10, 32)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 33 or bits.bits_per_row[row] < 10:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if (util.add_bytes(bytes(b[:3]), 3) - b[3]) & 0xFF != 0xA6:
        return DECODE_FAIL_MIC
    # operator-precedence quirk kept from the reference: a set sign bit
    # yields -1, not a negated temperature (ref rubicson_48659.c:145)
    if (b[1] & 0x04) >> 2:
        temp_f = -1.0
    else:
        temp_f = float(((b[1] & 0x3) << 8) | b[2])
    return [Event.make(
        ("model", "Rubicson-48659"),
        ("id", b[0], "Id"),
        ("temperature_F", temp_f, "Temperature", "%.1f F"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("gt_tmbbq05")
def gt_tmbbq05(bits, dev):
    """Globaltronics Quigg GT-TMBBQ-05 (ref src/devices/gt_tmbbq05.c)."""
    r = bits.find_repeated_row(5, 33)
    if r < 0 or bits.bits_per_row[r] != 33:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(r, 1, 32))
    if not b[0] and not b[1] and not b[2] and not b[3]:
        return DECODE_FAIL_SANITY
    p = b[:3] + [b[3] & 0xF0]
    if util.parity_bytes(bytes(p), 4):
        return DECODE_FAIL_MIC
    total = util.add_nibbles(bytes(b[:3]), 3) + (b[3] >> 4)
    if (total & 0xF) != (b[3] & 0xF):
        return DECODE_FAIL_MIC
    tempf = (((b[3] & 0xC0) << 2) | b[1]) - 90
    return [Event.make(
        ("model", "GT-TMBBQ05"),
        ("id", (b[0] << 8) | b[2], "ID Code"),
        ("temperature_F", float(tempf), "Temperature", "%.2f F"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


def _chk_rollbyte(message, nbytes, gen):
    total = 0
    for k in range(nbytes):
        data = message[k]
        key = gen
        for i in range(7, -1, -1):
            if (data >> i) & 1:
                total ^= key & 0xFF
            key >>= 1
    return total


@decoder("gt_wt_03")
def gt_wt_03(bits, dev):
    """Globaltronics GT-WT-03 (ref src/devices/gt_wt_03.c)."""
    row = 0
    if bits.num_rows > 1:
        row = bits.find_repeated_row(bits.num_rows // 2 + 1, 41)
    if row < 0:
        return DECODE_ABORT_LENGTH
    if bits.bits_per_row[row] != 41:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[row])
    if not (b[0] or b[1] or b[2] or b[3] or b[4]):
        return DECODE_ABORT_EARLY
    if _chk_rollbyte(b, 4, 0x3100) ^ b[4] ^ 0x2D:
        return DECODE_FAIL_MIC
    temp_raw = _s16(((b[2] & 0x0F) << 12) | (b[3] << 4))
    temp_c = (temp_raw >> 4) * 0.1
    if temp_c <= -50.2 or temp_c >= 70.2:
        return DECODE_FAIL_SANITY
    humidity_raw = b[1]
    if (humidity_raw != 10 and humidity_raw != 110
            and (humidity_raw < 20 or humidity_raw > 95)):
        return DECODE_FAIL_SANITY
    humidity = humidity_raw
    if humidity_raw == 10:
        humidity = 0
    elif humidity_raw == 110:
        humidity = 100
    return [Event.make(
        ("model", "GT-WT03"),
        ("id", b[0], "ID Code"),
        ("channel", ((b[2] >> 4) & 3) + 1, "Channel"),
        ("battery_ok", int(not ((b[2] >> 7) & 1)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", float(humidity), "Humidity", "%.0f %%"),
        ("button", (b[2] >> 6) & 1, "Button"),
        ("mic", "CRC", "Integrity"),
    )]

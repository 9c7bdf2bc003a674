"""Misc decoder batch A: 20 small OOK/FSK devices (reference files cited
per function)."""

from __future__ import annotations

from ..bits import util
from ..bits.bitbuffer import BitBuffer
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_OTHER,
    DECODE_FAIL_SANITY,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _s32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("jasco")
def jasco(bits, dev):
    """Jasco-Security (ref src/devices/jasco.c): fc0c preamble, Manchester,
    XOR checksum."""
    n = bits.bits_per_row[0]
    if n < 80 or n > 87:
        return DECODE_ABORT_EARLY
    start_pos = bits.search(0, 0, bytes([0xFC, 0x0C]), 16) + 16
    if start_pos + 64 > n:
        return DECODE_ABORT_LENGTH
    packet = BitBuffer()
    bits.manchester_decode(0, start_pos, packet, 32)
    if packet.bits_per_row[0] < 32:
        return DECODE_ABORT_LENGTH
    b = _ints(packet.bb[0])
    if b[0] ^ b[1] ^ b[2] ^ b[3]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Jasco-Security"),
        ("id", (b[0] << 8) | b[1], "Id"),
        ("status", int((b[2] & 0xEF) == 0xEF), "Closed"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("ft004b")
def ft004b(bits, dev):
    """FT-004B (ref src/devices/ft004b.c): 46-bit pattern x3 majority."""
    if bits.bits_per_row[0] not in (137, 138):
        return DECODE_ABORT_LENGTH
    msg = []
    for i in range(6):
        a = int(bits.extract_bytes(0, i * 8, 8)[0])
        b = int(bits.extract_bytes(0, i * 8 + 46, 8)[0])
        c = int(bits.extract_bytes(0, i * 8 + 46 * 2, 8)[0])
        msg.append(util.reverse8((a & b) | (b & c) | (a & c)))
    if msg[0] != 0xF4:
        return DECODE_FAIL_SANITY
    temp_raw = ((msg[4] & 0x7) << 8) | msg[3]
    return [Event.make(
        ("model", "FT-004B"),
        ("temperature_C", temp_raw * 0.05 - 40.0, "Temperature", "%.1f C"),
    )]


@decoder("abmt")
def abmt(bits, dev):
    """Basics-Meat thermometer (ref src/devices/abmt.c)."""
    row = bits.find_repeated_row(4, 90)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 120:
        return DECODE_ABORT_LENGTH
    bitpos = bits.search(row, 0, bytes([0x55, 0xAA, 0xAA]), 24)
    if bitpos == bits.bits_per_row[row] or bitpos < 72:
        return DECODE_FAIL_SANITY
    packet = BitBuffer()
    bits.manchester_decode(row, bitpos - 72, packet, 48)
    packet.invert()
    b = _ints(packet.bb[0])
    bcd = lambda x: (x >> 4) * 10 + (x & 0x0F)
    temp = bcd(b[3]) * 10 + bcd(b[4] >> 4)
    return [Event.make(
        ("model", "Basics-Meat"),
        ("id", b[0], "Id"),
        ("temperature_C", float(temp), "Temperature", "%.1f C"),
    )]


@decoder("grill_thermometer")
def grill_thermometer(bits, dev):
    """RF-T0912 grill thermometer (ref src/devices/grill_thermometer.c):
    inverted 24-bit rows, additive checksum, repeat requirement."""
    bits.invert()
    temp_f = 0
    repeats = 0
    for row in range(bits.num_rows):
        b = _ints(bits.bb[row])
        checksum = (b[0] + b[1]) & 0xFF
        if bits.bits_per_row[row] != 24 or checksum != b[2] or checksum == 0:
            continue
        current = _s16((b[0] << 8) | b[1])
        if temp_f != current:
            temp_f = current
            repeats = 0
        else:
            repeats += 1
    if repeats < 1:
        return DECODE_ABORT_EARLY
    overload = int(temp_f == -1029)
    return [Event.make(
        ("model", "RF-T0912"),
        ("temperature_F", float(temp_f), "Temperature", "%.0f F")
        if not overload else None,
        ("overload", overload, "Overload"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("ibis_beacon")
def ibis_beacon(bits, dev):
    """IBIS-Beacon (ref src/devices/ibis_beacon.c): CRC-16 0x8005."""
    n = bits.bits_per_row[0]
    if bits.num_rows != 1 or n < 232 or n > 250:
        return DECODE_ABORT_LENGTH
    pos = bits.search(0, 0, bytes([0xAB]), 8)
    if pos > 26:
        return DECODE_ABORT_EARLY
    pos += 8
    if n - pos < 224:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, pos, 224))
    if ((msg[26] << 8) | msg[27]) != util.crc16(bytes(msg[:26]), 26,
                                                0x8005, 0x0000):
        return DECODE_FAIL_MIC
    id_ = ((msg[5] & 0x0F) << 12) | (msg[6] << 4) | ((msg[7] & 0xF0) >> 4)
    counter = _s32((msg[20] << 24) | (msg[21] << 16) | (msg[22] << 8) | msg[23])
    return [Event.make(
        ("model", "IBIS-Beacon"),
        ("id", id_, "Vehicle No."),
        ("counter", counter, "Counter"),
        ("code", "".join("%02x" % x for x in msg[:28]), "Code data"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("audiovox_pro_oe3b")
def audiovox_pro_oe3b(bits, dev):
    """Audiovox-PROOE3B car remote (ref src/devices/audiovox_pro_oe3b.c)."""
    if bits.bits_per_row[0] != 25:
        return DECODE_ABORT_LENGTH
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[0])
    if (b[2] & 0xAA) or b[2] == 0x55:
        return DECODE_FAIL_SANITY
    b = [~x & 0xFF for x in b]
    id_ = (b[0] << 8) | b[1]
    if id_ == 0 or id_ == 0xFFFF:
        return DECODE_FAIL_SANITY
    names = ["Lock", "Unlock", "Option", "Trunk"]
    pressed = [names[i] for i in range(4) if b[2] & (0x01 << (2 * i))]
    if not pressed:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Audiovox-PROOE3B", "model"),
        ("id", "%04X" % id_, "ID"),
        ("button_str", "; ".join(pressed), "Button"),
    )]


@decoder("gasmate_ba1008")
def gasmate_ba1008(bits, dev):
    """Gasmate-BA1008 (ref src/devices/gasmate_ba1008.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] != 32:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if (b[0] & 0xF8) != 0xF0:
        return DECODE_ABORT_EARLY
    if (util.add_nibbles(bytes(b[:4]), 4) & 0x0F) != 0x0C:
        return DECODE_FAIL_MIC
    temp_raw = (b[0] & 0x03) * 100 + ((b[1] & 0xF0) >> 4) * 10 + (b[1] & 0x0F)
    temp_c = -temp_raw if (b[0] & 0x04) else temp_raw
    return [Event.make(
        ("model", "Gasmate-BA1008"),
        ("temperature_C", temp_c, "Temperature_C", "%d C"),
        ("unknown_1", (b[2] << 4) | (b[3] >> 4), "Unknown Value", "%03x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("emos_e6016_rain")
def emos_e6016_rain(bits, dev):
    """EMOS-E6016R rain gauge (ref src/devices/emos_e6016_rain.c)."""
    r = bits.find_repeated_row(3, 72)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[r])
    if bits.bits_per_row[r] < 72 or bits.bits_per_row[r] > 73:
        return DECODE_ABORT_LENGTH
    if b[0] != 0x55 or b[1] != 0x5A or b[2] != 0x75:
        return DECODE_ABORT_EARLY
    # note: the reference inverts the buffer via an alias AFTER reading b,
    # so the checks below run on inverted data
    b = [~x & 0xFF for x in b]
    if (sum(b[:8]) & 0xFF) != b[8]:
        return DECODE_FAIL_MIC
    rain_raw = ((b[6] & 0x0F) << 8) | b[7]
    return [Event.make(
        ("model", "EMOS-E6016R"),
        ("id", b[3], "House Code"),
        ("battery_ok", int(bool(b[4] >> 6)), "Battery_OK"),
        ("rain_mm", rain_raw * 0.7, "Rain_mm", "%.1f mm"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("wt1024")
def wt1024(bits, dev):
    """WT0124-Pool thermometer (ref src/devices/wt0124.c)."""
    if bits.bits_per_row[1] != 49:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[1])
    if (b[0] >> 4) != 0x5:
        return DECODE_ABORT_EARLY
    if util.xor_bytes(bytes(b[:4]), 4) != b[4]:
        return DECODE_FAIL_MIC
    s = sum(b[:4])
    s += s >> 8
    s += b[4]
    s &= 0xFF
    if s != b[5]:
        return DECODE_FAIL_MIC
    sensor_rid = ((b[0] & 0x0F) << 4) | (b[1] & 0x0F)
    temp_c = ((((b[1] & 0xF) << 8) | b[2]) - 0x990) * 0.1
    return [Event.make(
        ("model", "WT0124-Pool"),
        ("id", sensor_rid, "Random ID"),
        ("channel", (b[3] >> 4) & 0x3, "Channel"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("vauno_en8822c")
def vauno_en8822c(bits, dev):
    """Vauno-EN8822C (ref src/devices/vauno_en8822c.c)."""
    row = bits.find_repeated_prefix(4, 42)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    chk = ((b[4] & 0x0F) << 2) | (b[5] >> 6)
    s = util.add_nibbles(bytes(b[:4]), 4) + (b[4] >> 4)
    if s == 0:
        return DECODE_ABORT_EARLY
    if (s & 0x3F) != chk:
        return DECODE_FAIL_MIC
    temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Vauno-EN8822C"),
        ("id", b[0], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int(not ((b[4] & 0x10) >> 4)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", b[3] >> 1, "Humidity", "%u %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tr_502msv")
def tr_502msv(bits, dev):
    """TR-502MSV remote socket (ref src/devices/tr_502msv.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] != 21:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if (b[0] & 0x80) == 0:
        return DECODE_ABORT_EARLY
    if (b[2] & 0x20) != 0:
        return DECODE_FAIL_SANITY
    device_id = ((b[0] & 0x7F) << 5) | (b[1] >> 3)
    socket_id = b[1] & 0x07
    on_off = (b[2] & 0x80) >> 7
    command = (b[2] & 0x40) >> 6
    chk1 = (b[2] & 0x10) >> 4
    chk0 = (b[2] & 0x08) >> 3
    s2, s1, s0 = (socket_id >> 2) & 1, (socket_id >> 1) & 1, socket_id & 1
    if chk1 != (command ^ s2 ^ s0) or chk0 != (on_off ^ s1):
        return DECODE_FAIL_MIC
    if socket_id % 2 == 0:
        socket_str = ["1", "3", "2", "4"][socket_id >> 1]
    elif socket_id == 0x7:
        socket_str = "ALL"
    else:
        return DECODE_FAIL_SANITY
    command_str = ["OFF", "BRIGHT", "ON", "DIM"][(on_off << 1) | command]
    return [Event.make(
        ("model", "TR-502MSV", "Model"),
        ("id", device_id, "Device ID", "%u"),
        ("socket_id", socket_str, "Socket"),
        ("command", command_str, "Command"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("wg_pb12v1")
def wg_pb12v1(bits, dev):
    """WG-PB12V1 (ref src/devices/wg_pb12v1.c)."""
    b = _ints(bits.bb[0])
    if bits.bits_per_row[0] < 48:
        return DECODE_ABORT_LENGTH
    if b[0] != 0xFF:
        return DECODE_ABORT_EARLY
    if (b[1] & 0xF0) != 0x30:
        return DECODE_ABORT_EARLY
    if b[5] != util.crc8(bytes(b[1:5]), 4, 0x31, 0):
        return DECODE_FAIL_MIC
    if b[4] != 0xFF:
        return DECODE_FAIL_OTHER
    temp_c = ((((b[1] & 0x0F) << 8) | b[2]) - 400) * 0.1
    return [Event.make(
        ("model", "WG-PB12V1"),
        ("id", b[3] & 0x1F, "ID"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("opus_xt300")
def opus_xt300(bits, dev):
    """Opus-XT300 soil moisture (ref src/devices/opus_xt300.c)."""
    out = []
    fail = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 48:
            fail = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[row])
        if not b[0] and not b[1] and not b[2] and not b[3]:
            fail = DECODE_FAIL_SANITY
            continue
        if b[0] != 0xFF and ((b[1] | 0x1) & 0xFD) == 0x55:
            fail = DECODE_ABORT_EARLY
            continue
        chk = sum(b[1:5]) & 0xFF
        if chk != 0 and chk != b[5]:
            fail = DECODE_FAIL_MIC
            continue
        temp = b[3] - 40
        moisture = b[2]
        if temp > 100 or moisture > 101:
            fail = DECODE_FAIL_SANITY
            continue
        out.append(Event.make(
            ("model", "Opus-XT300"),
            ("channel", b[1] & 0x03, "Channel"),
            ("temperature_C", float(temp), "Temperature", "%.0f C"),
            ("moisture", moisture, "Moisture", "%d %%"),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out if out else fail


@decoder("tfa_marbella")
def tfa_marbella(bits, dev):
    """TFA-Marbella pool thermometer (ref src/devices/tfa_marbella.c)."""
    start_pos = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24)
    if start_pos >= bits.bits_per_row[0]:
        return DECODE_FAIL_SANITY
    msg = _ints(bits.extract_bytes(0, start_pos, 88))
    msg = (msg + [0] * 11)[:11]
    if msg[9] != 0xAA:
        return DECODE_FAIL_SANITY
    if util.lfsr_digest8_reflect(bytes(msg[3:10]), 7, 0x31, 0x31) != msg[10]:
        return DECODE_FAIL_MIC
    temp_c = (((msg[7] << 4) | (msg[8] >> 4)) - 400) * 0.1
    serialnr = (msg[3] << 16) | (msg[4] << 8) | msg[5]
    return [Event.make(
        ("model", "TFA-Marbella"),
        ("id", "%06x" % serialnr),
        ("counter", (msg[6] >> 1) & 0x07),
        ("battery_ok", int(not ((msg[6] >> 7) & 0x01)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("florabest")
def florabest(bits, dev):
    """Florabest-FBTH1 (ref src/devices/florabest.c)."""
    row = bits.find_repeated_row(3, 30)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 30:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] != 0x49:
        return DECODE_FAIL_SANITY
    parity = 0
    for i in range(30):
        parity ^= (b[i // 8] >> (7 - i % 8)) & 1
    if parity != 1:
        return DECODE_FAIL_MIC
    temp_raw = (b[2] << 5) | (b[3] >> 3)
    return [Event.make(
        ("model", "Florabest-FBTH1"),
        ("id", (b[0] << 8) | b[1], "Id", "%04x"),
        ("temperature_F", temp_raw * 0.1 - 90.0, "Temperature", "%.1f F"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("rubicson_pool_48942")
def rubicson_pool_48942(bits, dev):
    """Rubicson-48942 pool thermometer (ref src/devices/
    rubicson_pool_48942.c); checks run on inverted data (aliasing)."""
    row = bits.find_repeated_row(2, 41)
    if row < 0 or bits.bits_per_row[row] != 41:
        return DECODE_ABORT_LENGTH
    bits.invert()  # padding bits stay zero (ref bitbuffer_invert)
    b = _ints(bits.bb[row])
    if (b[3] & 0xF) or b[5]:
        return DECODE_ABORT_EARLY
    if b[0] == 0 and b[2] == 0 and b[4] == 0:
        return DECODE_ABORT_EARLY
    if util.crc8(bytes(b[:4]), 4, 0x31, 0x00) != b[4]:
        return DECODE_FAIL_MIC
    temp_c = ((((b[2] & 0x7F) << 4) | (b[3] >> 4)) - 1024) * 0.1
    return [Event.make(
        ("model", "Rubicson-48942"),
        ("channel", (b[0] >> 4) + 1, "Channel"),
        ("id", ((b[0] & 0x0F) << 6) | ((b[1] & 0xFC) >> 2), "Random ID"),
        ("battery_ok", int(not (b[2] >> 7)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("sharp_spc775")
def sharp_spc775(bits, dev):
    """Sharp-SPC775 (ref src/devices/sharp_spc775.c)."""
    bits.invert()
    r = bits.find_repeated_row(2, 48)
    if r < 0:
        return DECODE_ABORT_EARLY
    pos = bits.search(r, 0, bytes([0xA5]), 8)
    if pos + 48 > bits.bits_per_row[r]:
        return DECODE_FAIL_SANITY
    b = _ints(bits.extract_bytes(r, pos, 48))
    chk_calc = util.xor_bytes(bytes(b[:5]), 5)
    if util.lfsr_digest8_reflect(bytes([chk_calc]), 1, 0x31, 0x31) != b[5]:
        return DECODE_FAIL_MIC
    humidity = b[4]
    if humidity > 100:
        return DECODE_FAIL_SANITY
    temp_c = (_s16(((b[2] & 0x0F) << 12) | (b[3] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Sharp-SPC775"),
        ("id", b[1]),
        ("battery_ok", int(not (b[2] & 0x80)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("wec2103")
def wec2103(bits, dev):
    """WEC-2103 (ref src/devices/wec2103.c): CRC-4 with nibble shuffle."""
    if bits.num_rows != 6 or bits.bits_per_row[2] != 42:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(3, 0, 40))
    crc_received = b[1] >> 4
    b1mod = (b[1] & 0x0F) | ((b[4] & 0x0F) << 4)
    msg = bytes([b[0], b1mod, b[2], b[3]])
    if (util.crc4(msg, 4, 3, 0) ^ (b[4] >> 4)) != crc_received:
        return DECODE_FAIL_MIC
    temp_raw = (b[2] << 4) | ((b[3] & 0xF0) >> 4)
    return [Event.make(
        ("model", "WEC-2103"),
        ("id", b[0], "ID"),
        ("channel", b[4] & 0x0F, "Channel"),
        ("battery_ok", int(not ((b[1] & 0x04) >> 3)), "Battery"),
        ("button", (b[1] & 0x08) >> 3, "Button"),
        ("temperature_F", (temp_raw - 900) * 0.1, "Temperature", "%.2f F"),
        ("humidity", (b[3] & 0x0F) * 10 + ((b[4] & 0xF0) >> 4),
         "Humidity", "%u %%"),
        ("flags", b[1] & 0xF, "Flags"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("auriol_hg02832")
def auriol_hg02832(bits, dev):
    """Auriol-HG02832 (ref src/devices/auriol_hg02832.c)."""
    if bits.num_rows != 2:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 1 or bits.bits_per_row[1] != 40:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[1])
    d0 = b[0] ^ b[1] ^ b[2] ^ b[3]
    if util.crc8(bytes([d0]), 1, 0x31, 0x53) ^ b[4]:
        return DECODE_FAIL_MIC
    temp_c = (_s16(((b[2] & 0x0F) << 12) | (b[3] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Auriol-HG02832"),
        ("id", b[0]),
        ("channel", ((b[2] & 0x30) >> 4) + 1),
        ("battery_ok", int(not (b[2] >> 7)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", float(b[1]), "Humidity", "%.0f %%"),
        ("button", (b[2] & 0x40) >> 6, "Button"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ts_ft002")
def ts_ft002(bits, dev):
    """TS-FT002 tank level meter (ref src/devices/ts_ft002.c)."""
    n = bits.bits_per_row[0]
    if n == 72:
        b = _ints(bits.extract_bytes(0, 0, 72))
    elif n == 71:
        b = [int(bits.bb[0][0]) >> 1] + _ints(bits.extract_bytes(0, 7, 64))
    elif n == 70:
        b = [(int(bits.bb[0][0]) >> 2) | 0x80] + \
            _ints(bits.extract_bytes(0, 6, 64))
    else:
        return DECODE_ABORT_LENGTH
    b = (b + [0] * 9)[:9]
    if util.xor_bytes(bytes(b), 9):
        return DECODE_FAIL_MIC
    b = [util.reverse8(x) for x in b[:8]] + [b[8]]
    id_ = b[1]
    type_ = b[2]
    depth = (b[3] << 4) | (b[4] & 0x0F)
    batt_low = b[4] >> 4
    transmit = b[5] >> 4
    temp_c = (((b[6] << 4) | (b[5] & 0x0F)) - 400) * 0.1
    if (transmit & 0x07) == 0x07:
        transmit = 5
    elif (transmit & 0x08) == 0x08:
        transmit = 30
    elif transmit == 0:
        transmit = 180
    else:
        transmit = 0
    if type_ != 0x11:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "TS-FT002"),
        ("id", id_, "Id"),
        ("depth_cm", depth, "Depth"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("transmit_s", transmit, "Transmit Interval"),
        ("flags", batt_low, "Battery Flag?"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

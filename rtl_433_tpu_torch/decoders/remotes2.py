"""Remotes / home-automation batch 2 (reference files cited per function):
Honda/Ford car keys, Philips AJ3650, GE Color Effects, Dish remote,
LightwaveRF, Vaillant VRT340f, Emos TTX201, SimpliSafe, RadioHead ASK,
Sensible Living.
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


@decoder("hondaremote")
def hondaremote(bits, dev):
    """Honda car key (ref src/devices/hondaremote.c)."""
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 385 or bits.bits_per_row[row] > 394:
            continue
        b = _ints(bits.bb[row])
        if b[0] != 0xFF or b[38] != 0xFF:
            continue
        cmd = b[46] - 0xAA
        code = ("boot", "unlock", "lock")[cmd] if 0 <= cmd < 3 else "unknown"
        return [Event.make(
            ("model", "Honda-CarRemote"),
            ("id", (b[44] << 8) | b[45]),
            ("code", code),
        )]
    return DECODE_FAIL_OTHER


@decoder("fordremote")
def fordremote(bits, dev):
    """Ford car key (ref src/devices/fordremote.c)."""
    events = []
    for i in range(3, bits.num_rows):
        if bits.bits_per_row[i] < 78:
            continue
        if (bits.bits_per_row[i - 3] != 1 or bits.bits_per_row[i - 1] != 1
                or bits.bits_per_row[i - 2] != 9
                or int(bits.bb[i - 2][0]) != 0):
            continue
        b = _ints(bits.bb[i])
        events.append(Event.make(
            ("model", "Ford-CarRemote", "model"),
            ("id", (b[0] << 16) | (b[1] << 8) | b[2], "device-id"),
            ("code", b[7], "data"),
        ))
    return events


@decoder("philips_aj3650")
def philips_aj3650(bits, dev):
    """Philips AJ3650 outdoor sensor (ref src/devices/philips_aj3650.c)."""
    bits.invert()
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 112:
        return DECODE_ABORT_LENGTH
    bb = _ints(bits.bb[0])
    if (bb[0] >> 4) != 0x0:
        return DECODE_ABORT_EARLY
    packet = []
    for i in range(4):
        a = bb[i + 1]
        b = ((bb[i + 5] << 4) & 0xFF) | ((bb[i + 6] >> 4) & 0xF)
        c = bb[i + 10]
        packet.append((a & b) | (b & c) | (a & c))
    if util.crc4(bytes(packet), 4, 0x9, 1) != 0:
        return DECODE_FAIL_MIC
    channel_map = [2, 0, 1, 0, 3]
    channel = packet[0] & 0x0F
    channel = channel_map[channel] if channel < len(channel_map) else 0
    temp_raw = (packet[1] << 2) | (packet[2] >> 6)
    return [Event.make(
        ("model", "Philips-Temperature"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(not (packet[3] & 0x40)), "Battery"),
        ("temperature_C", (temp_raw - 500) * 0.1, "Temperature", "%.1f C"),
    )]


def _ge_decode(bits, row, start, outbuf):
    """10 -> 0, 1100 -> 1 (ref src/devices/ge_coloreffects.c:27-52)."""
    b = bits.bb[row]

    def bit(pos):
        return (int(b[pos >> 3]) >> (7 - (pos & 7))) & 1

    length = bits.bits_per_row[row]
    ipos = start
    while ipos < length:
        bit1 = bit(ipos); ipos += 1
        bit2 = bit(ipos); ipos += 1
        if bit1 == 1 and bit2 == 0:
            outbuf.add_bit(0)
        elif bit1 == 1 and bit2 == 1:
            bit1 = bit(ipos); ipos += 1
            bit2 = bit(ipos); ipos += 1
            if bit1 == 0 and bit2 == 0:
                outbuf.add_bit(1)
            else:
                break
        else:
            break
    return ipos


@decoder("ge_coloreffects")
def ge_coloreffects(bits, dev):
    """GE Color Effects remote (ref src/devices/ge_coloreffects.c)."""
    def decode_at(bitpos):
        packet = BitBuffer()
        _ge_decode(bits, 0, bitpos, packet)
        if packet.bits_per_row[0] != 17:
            return DECODE_ABORT_LENGTH
        b = _ints(packet.bb[0])
        if b[0] & 0xC0:
            return DECODE_FAIL_SANITY
        if b[2] & 0x80:
            return DECODE_FAIL_SANITY
        command = b[1]
        cmd = {0x5A: "change", 0xAA: "on", 0x55: "off"}.get(
            command, "0x%x" % command)
        return [Event.make(
            ("model", "GE-ColorEffects"),
            ("id", b[0], "", "0x%x"),
            ("command", cmd),
        )]

    events = []
    ret = DECODE_FAIL_OTHER
    bitpos = 0
    nbits = bits.bits_per_row[0]
    while True:
        found = None
        for pat, plen in ((bytes([0xCC, 0xFF, 0x00]), 24),
                          (bytes([0xCC, 0xFF, 0x00]), 23),
                          (bytes([0xCC, 0xFE, 0x00]), 23),
                          (bytes([0xCC, 0xFE, 0x00]), 22)):
            f = bits.search(0, bitpos, pat, plen) + plen
            if f + 33 <= nbits:
                found = f
                break
        if found is None:
            break
        bitpos = found
        ret = decode_at(bitpos)
        if isinstance(ret, list):
            events += ret
        bitpos += 1
    return events if events else ret


_DISH_BUTTONS = [
    "Undefined", "Undefined", "Swap", "Undefined", "Position", "PIP", "DVR",
    "Undefined", "Skip Forward", "Skip Backward", "Undefined", "Dish Button",
    "Undefined", "Forward", "Backward", "TV Power", "Reset", "Undefined",
    "Undefined", "Undefined", "Undefined", "Undefined", "SAT",
    "Mute/Volume Up/Volume Down", "Undefined", "#/Search", "*/Format",
    "Undefined", "Undefined", "Undefined", "Stop", "Pause", "Record",
    "Channel Down", "Undefined", "Left", "Recall", "Channel Up", "Undefined",
    "Right", "TV/Video", "View/Live TV", "Undefined", "Guide", "Undefined",
    "Cancel", "Digit 0", "Select", "Page Up", "Digit 9", "Digit 8",
    "Digit 7", "Menu", "Digit 6", "Digit 5", "Digit 4", "Page Down",
    "Digit 3", "Digit 2", "Digit 1", "Play", "Dish Power", "Undefined",
    "Info",
]


@decoder("dish_remote_6_3")
def dish_remote_6_3(bits, dev):
    """Dish Network remote 6.3 (ref src/devices/dish_remote_6_3.c)."""
    r = bits.find_repeated_row(3, 16)
    if r < 0 or bits.bits_per_row[r] > 16:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if (b[0] & 0x03) != 0x02 or (b[1] & 0xE8) != 0xA8:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Dish-RC63"),
        ("button", _DISH_BUTTONS[b[0] >> 2]),
    )]


_LWRF_NIBBLES = {
    0xF6: 0x0, 0xEE: 0x1, 0xED: 0x2, 0xEB: 0x3, 0xDE: 0x4, 0xDD: 0x5,
    0xDB: 0x6, 0xBE: 0x7, 0xBD: 0x8, 0xBB: 0x9, 0xB7: 0xA, 0x7E: 0xB,
    0x7D: 0xC, 0x7B: 0xD, 0x77: 0xE, 0x6F: 0xF,
}


@decoder("lightwave_rf")
def lightwave_rf(bits, dev):
    """LightwaveRF (ref src/devices/lightwave_rf.c)."""
    if bits.bits_per_row[0] != 71 or bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = bits.bb[0]
    stuffed = []
    for n in range(71):
        if (int(b[n // 8]) >> (7 - n % 8)) & 1:
            stuffed.append(1)
        else:
            stuffed += [1, 0]
    if len(stuffed) != 91:
        return DECODE_ABORT_LENGTH
    if stuffed[0] == 0:
        return DECODE_ABORT_EARLY
    idx = 1
    raw = []
    for _ in range(10):
        if stuffed[idx] == 0:
            return DECODE_ABORT_EARLY
        idx += 1
        byte = 0
        for _ in range(8):
            byte = (byte << 1) | stuffed[idx]
            idx += 1
        raw.append(byte)
    nibbles = []
    for byte in raw:
        nib = _LWRF_NIBBLES.get(byte)
        if nib is None:
            return DECODE_FAIL_SANITY
        nibbles.append(nib)
    nb = [(nibbles[i * 2] << 4) | nibbles[i * 2 + 1] for i in range(5)]
    return [Event.make(
        ("model", "Lightwave-RF"),
        ("id", (nb[2] << 16) | (nb[3] << 8) | nb[4], "", "%06x"),
        ("subunit", (nb[1] & 0xF0) >> 4),
        ("command", nb[1] & 0x0F),
        ("parameter", nb[0]),
    )]


@decoder("vaillant_vrt340f")
def vaillant_vrt340f(bits, dev):
    """Vaillant calorMatic VRT340f (ref src/devices/vaillant_vrt340f.c)."""
    if bits.bits_per_row[0] < 128:
        return DECODE_ABORT_LENGTH
    # row_bytes follows spill rows (>1024-bit rows would overrun bb[0])
    src = bits.row_bytes(0)
    out = []
    ones = 0
    for k in range(bits.bits_per_row[0]):
        bit = (int(src[k // 8]) >> (7 - k % 8)) & 1
        if bit == 1:
            out.append(1)
            ones += 1
        else:
            if ones != 5:
                out.append(0)
            ones = 0
    bitcount = len(out)
    nbytes = (bitcount - 1) // 8
    b = []
    for i in range(nbytes + 1):
        byte = 0
        for j in range(8):
            pos = i * 8 + j
            byte = (byte << 1) | (out[pos] if pos < bitcount else 0)
        b.append(byte)
    b = [util.reverse8(x) for x in b[:nbytes]] + b[nbytes:]
    if not (128 <= bitcount <= 131) and not (168 <= bitcount <= 171):
        return DECODE_ABORT_LENGTH
    b += [0] * (20 - len(b))

    def csum_ok(frm, to, cs_from, cs_to):
        expected = (b[cs_from] << 8) | b[cs_to]
        calculated = sum(b[frm:to + 1]) & 0xFFFF
        return ((calculated + expected) & 0xFFFF) == 0

    if b[0] == 0x00 and b[1] == 0x00 and b[2] == 0x7E and 128 <= bitcount <= 131:
        if not csum_ok(3, 11, 12, 13):
            return DECODE_FAIL_MIC
        heating_mode = b[10] >> 7
        target_temperature = b[10] & 0x7F
        return [Event.make(
            ("model", "Vaillant-VRT340f"),
            ("id", (b[3] << 8) | b[4], "Device ID", "0x%04X"),
            ("heating", "OFF" if (heating_mode == 0 and target_temperature == 0)
             else ("ON (2-point)" if heating_mode else "ON (analogue)"),
             "Heating Mode"),
            ("heating_temp", target_temperature, "Heating Water Temp.", "%d"),
            ("water", "ON" if (b[9] & 8) == 0 else "off", "Pre-heated Water"),
            ("battery_ok", int(b[11] == 0), "Battery"),
        )]
    if b[0] == 0x00 and b[1] == 0x00 and b[2] == 0x7E and 168 <= bitcount <= 171:
        if not csum_ok(3, 16, 17, 18):
            return DECODE_FAIL_MIC
        return [Event.make(
            ("model", "Vaillant-VRT340f"),
            ("id", (b[11] << 8) | b[12], "Device ID"),
        )]
    return DECODE_FAIL_SANITY


@decoder("ttx201")
def ttx201(bits, dev):
    """Emos TTX201 temperature sensor (ref src/devices/ttx201.c)."""
    def decode_row(row):
        rowlen = bits.bits_per_row[row]
        if rowlen != 50 and rowlen != 54:
            return DECODE_ABORT_LENGTH
        b = _ints(bits.extract_bytes(row, 2, 56))
        chk = b[0] & 0x3F
        total = util.add_nibbles(bytes(b[1:6]), 5)
        data_type = (b[2] & 0x70) >> 4
        if total == 0:
            return DECODE_ABORT_EARLY
        if chk != (total & 0x3F):
            return DECODE_FAIL_MIC
        if data_type == 0x05:
            cest = b[1] & 0x80
            clock = "%04d-%02d-%02dT%02d:%02d:%02d %s" % (
                (b[1] & 0x7F) + 2000, b[2] & 0x0F, (b[3] & 0xF8) >> 3,
                ((b[3] & 0x07) << 2) | ((b[4] & 0xC0) >> 6), b[4] & 0x3F,
                (b[5] & 0x7E) >> 1, "CEST" if cest else "CET")
            return [Event.make(
                ("model", "Emos-TTX201"),
                ("radio_clock", clock, "Radio Clock"),
                ("mic", "CHECKSUM", "Integrity"),
            )]
        temp = _s16(((b[3] & 0x0F) << 12) | (b[4] << 4))
        return [Event.make(
            ("model", "Emos-TTX201"),
            ("id", b[1], "House Code"),
            ("channel", (b[2] & 0x07) + 1, "Channel"),
            ("battery_ok", int(not (b[2] & 0x08)), "Battery"),
            ("temperature_C", (temp >> 4) * 0.1, "Temperature", "%.1f C"),
            ("mic", "CHECKSUM", "Integrity"),
        )]

    ret = DECODE_FAIL_OTHER
    if 2 <= bits.num_rows <= 10:
        for row in range(bits.num_rows):
            ret = decode_row(row)
            if isinstance(ret, list):
                return ret
    return ret


@decoder("ss_sensor")
def ss_sensor(bits, dev):
    """SimpliSafe home security (ref src/devices/simplisafe.c)."""
    row = bits.find_repeated_row(2, 90)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    if b[0] != 0xCC or b[1] != 0x5F:
        return DECODE_ABORT_EARLY
    bits.invert()
    b = _ints(bits.bb[row])

    def get_id():
        chars = []
        for k in range(3, 8):
            c = util.reverse8(b[k])
            chars.append(chr(c) if 32 <= c <= 126 else "?")
        return "".join(chars)

    msg_type = b[2]  # dispatch byte compared after the invert (0x88/0x66/0x44)
    if msg_type == 0x88:
        if bits.bits_per_row[row] != 92:
            return DECODE_ABORT_LENGTH
        seq = util.reverse8(b[8])
        state = util.reverse8(b[9])
        csum = util.reverse8(b[10])
        if ((seq + state) & 0xFF) != csum:
            return DECODE_FAIL_MIC
        extradata = {1: "Contact Open", 2: "Contact Closed",
                     3: "Alarm Off"}.get(state, "")
        return [Event.make(
            ("model", "SimpliSafe-Sensor"),
            ("id", get_id(), "Device ID"),
            ("seq", seq, "Sequence"),
            ("state", state, "State"),
            ("extradata", extradata, "Extra Data"),
        )]
    if msg_type == 0x66:
        pina = util.reverse8(b[10])
        pinb = util.reverse8(b[11])
        extradata = "Disarm Pin: %x%x%x%x" % (
            pina & 0xF, (pina & 0xF0) >> 4, pinb & 0xF, (pinb & 0xF0) >> 4)
        return [Event.make(
            ("model", "SimpliSafe-Keypad"),
            ("id", get_id(), "Device ID"),
            ("seq", b[9], "Sequence"),
            ("extradata", extradata, "Extra Data"),
        )]
    if msg_type == 0x44:
        extradata = {0x6A: "Arm System - Away", 0xCA: "Arm System - Home",
                     0x3A: "Arm System - Canceled",
                     0x2A: "Keypad Panic Button",
                     0x86: "Keypad Menu Button"}.get(
            b[10], "Unknown Keypad: %02x" % b[10])
        return [Event.make(
            ("model", "SimpliSafe-Keypad"),
            ("id", get_id(), "Device ID"),
            ("seq", b[9], "Sequence"),
            ("extradata", extradata, "Extra Data"),
        )]
    return DECODE_ABORT_EARLY


_RH_SYMBOLS = [0x0D, 0x0E, 0x13, 0x15, 0x16, 0x19, 0x1A, 0x1C,
               0x23, 0x25, 0x26, 0x29, 0x2A, 0x2C, 0x32, 0x34]


def _rh_symbol_6to4(symbol):
    for i in range((symbol >> 2) & 8, 16):
        if symbol == _RH_SYMBOLS[i]:
            return i
    return 0xFF


def _radiohead_extract(bits, row):
    """RadioHead 4-to-6 decode (ref src/devices/radiohead_ask.c:56-148).

    Returns payload list or a negative DECODE_* code."""
    length = bits.bits_per_row[row]
    msg_len = 60
    init_pattern = bytes([0x55, 0x55, 0x55, 0x51, 0xCD])
    pos = bits.search(row, 0, init_pattern, 40)
    if pos == length:
        return DECODE_ABORT_EARLY
    payload = []
    nb_bytes = 0
    pos += 40
    while pos < length and nb_bytes < msg_len:
        rx = _ints(bits.extract_bytes(row, pos, 16))
        rx += [0] * (2 - len(rx))
        rx[0] = util.reverse8(rx[0])
        rx[1] = util.reverse8(rx[1])
        rx[1] = (((rx[1] & 0x0F) << 2) + (rx[0] >> 6)) & 0xFF
        rx[0] &= 0x3F
        hi = _rh_symbol_6to4(rx[0])
        if hi > 0xF:
            return DECODE_FAIL_SANITY
        lo = _rh_symbol_6to4(rx[1])
        if lo > 0xF:
            return DECODE_FAIL_SANITY
        byte = (hi << 4) | lo
        payload.append(byte)
        if nb_bytes == 0:
            msg_len = byte
            if msg_len < 2 or msg_len > 60:
                break
        nb_bytes += 1
        pos += 12
    if msg_len < 2 or msg_len > 60:
        return DECODE_ABORT_LENGTH
    payload += [0] * (67 - len(payload))
    crc = (payload[msg_len - 1] << 8) | payload[msg_len - 2]
    crc_calc = (~util.crc16lsb(bytes(payload[:msg_len - 2]), msg_len - 2,
                               0x8408, 0xFFFF)) & 0xFFFF
    if crc_calc != crc:
        return DECODE_FAIL_MIC
    return payload[:msg_len] + [0] * (67 - msg_len), msg_len


@decoder("radiohead_ask")
def radiohead_ask(bits, dev):
    """RadioHead ASK generic packets (ref src/devices/radiohead_ask.c)."""
    res = _radiohead_extract(bits, 0)
    if isinstance(res, int):
        return res
    payload, msg_len = res
    data_len = msg_len - 4 - 3
    if data_len <= 0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "RadioHead-ASK"),
        ("len", data_len, "Data len"),
        ("to", payload[1], "To"),
        ("from", payload[2], "From"),
        ("id", payload[3], "Id"),
        ("flags", payload[4], "Flags"),
        ("payload", payload[5:5 + data_len], "Payload"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("sensible_living")
def sensible_living(bits, dev):
    """Sensible Living moisture sensor (ref src/devices/radiohead_ask.c:310)."""
    res = _radiohead_extract(bits, 0)
    if isinstance(res, int):
        return res
    p, _ = res
    return [Event.make(
        ("model", "SensibleLiving-Moisture"),
        ("house_id", p[1], "House ID"),
        ("module_id", (p[2] << 8) | p[3], "Module ID"),
        ("sensor_type", p[4], "Sensor Type"),
        ("sensor_count", p[5], "Sensor Count"),
        ("alarms", p[6], "Alarms"),
        ("sensor_value", (p[7] << 8) | p[8], "Sensor Value"),
        ("battery_mV", ((p[9] << 8) | p[10]) * 10, "Battery Voltage"),
        ("mic", "CRC", "Integrity"),
    )]

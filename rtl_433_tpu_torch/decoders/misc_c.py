"""Misc decoder batch C: car remotes, more TPMS, power/meter devices
(reference files cited per function)."""

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


def _s32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("opel_mokka")
def opel_mokka(bits, dev):
    """Opel-Mokka key fob (ref src/devices/opel_mokka.c)."""
    out = []
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] != 268:
            continue
        b = _ints(bits.bb[i])
        if any(b[:11]):
            continue
        t = _ints(bits.extract_bytes(i, 90, 11))
        key_id = (t[0] << 3) | (t[1] >> 5)
        t = _ints(bits.extract_bytes(i, 90 + 12 * 8 + 1, 11))
        check_id = (t[0] << 3) | (t[1] >> 5)
        if key_id != check_id or key_id == 0:
            continue
        event_type = ((b[12] & 0x07) << 2) | ((b[13] & 0xC0) >> 6)
        code = _ints(bits.extract_bytes(i, 90 + 17, 64))
        out.append(Event.make(
            ("model", "Opel-Mokka"),
            ("id", key_id),
            ("event", event_type),
            ("code", "".join("%02x" % x for x in code[:8])),
        ))
    return out


@decoder("gm_car_remote")
def gm_car_remote(bits, dev):
    """GM-ABO1502T car remote (ref src/devices/gm_car_remote.c)."""
    if bits.bits_per_row[0] < 113 or bits.num_rows > 1:
        return DECODE_ABORT_LENGTH
    offset = bits.bits_per_row[0] - 113
    b = _ints(bits.extract_bytes(0, offset, 112))
    if b[0] != 0xFF:
        return DECODE_FAIL_SANITY
    button_checksum = util.add_nibbles(bytes(b[2:3]), 1)
    if button_checksum == 0 or (button_checksum & 0xF) != 0:
        return DECODE_FAIL_MIC
    full_checksum = sum(b[1:14])
    if full_checksum == 0 or (full_checksum & 0xFF) != 0:
        return DECODE_FAIL_MIC
    button = b[2] & 0x7
    id_ = (b[3] << 24) | (b[4] << 16) | (b[5] << 8) | b[6]
    button_str = {0x1: "Unlock", 0x2: "Lock", 0x3: "Trunk",
                  0x4: "Panic"}.get(button, "?")
    return [Event.make(
        ("model", "GM-ABO1502T", "model"),
        ("id", "%02X%08X" % (b[1], id_), "ID"),
        ("encrypted", "%06X" % ((b[10] << 16) | (b[11] << 8) | b[12])),
        ("button_code", button, "Button Code"),
        ("button_str", button_str, "Button"),
        ("sequence", (b[7] << 16) | (b[8] << 8) | b[9], "Sequence"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("chrysler_car_remote")
def chrysler_car_remote(bits, dev):
    """Chrysler-CarRemote (ref src/devices/chrysler_car_remote.c)."""
    out = []
    bits.invert()
    for row in range(bits.num_rows):
        n = bits.bits_per_row[row]
        if n >= 49:
            offset = 49
        elif n == 48:
            offset = 48
        else:
            continue
        b = [util.reverse8(x) for x in _ints(bits.extract_bytes(
            row, n - offset, 48))]
        s = sum(b[:5])
        if (s & 0xFF) != b[5]:
            continue
        if s == 0 or s == 0xFF * 5:
            continue
        id_ = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
        button = b[4] >> 4
        multi_press = (b[4] & 0x4) != 0
        names = ["Unlock", "Lock", "Panic"]
        pressed = [names[i] for i in range(3) if button & (1 << i)]
        if not pressed or (len(pressed) > 1) != multi_press:
            continue
        out.append(Event.make(
            ("model", "Chrysler-CarRemote", "model"),
            ("id", "%08X" % id_, "ID"),
            ("button_code", button, "Button Code"),
            ("button_str", "; ".join(pressed), "Button"),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out


@decoder("siemens_5wy72xx_car_remote")
def siemens_5wy72xx(bits, dev):
    """Siemens-5WY72XX car remote (ref src/devices/siemens_5wy72xx.c)."""
    if bits.bits_per_row[0] < 113 or bits.num_rows > 1:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0x60, 0x01]), 16) + 16
    b = _ints(bits.extract_bytes(0, offset, 96))
    b = (b + [0] * 12)[:12]
    s = sum(b)
    if s == 0 or s == 0xFF * 12:
        return DECODE_FAIL_SANITY
    if util.xor_bytes(bytes(b), 12) != 0:
        return DECODE_FAIL_MIC
    button = b[4]
    names = ["Lock", "Unlock", "Trunk", "Panic", "Left Door", "Right Door"]
    pressed = [names[i] for i in range(6) if button & (1 << i)]
    return [Event.make(
        ("model", "Siemens-5WY72XX", "model"),
        ("id", "%02X%02X%02X%02X" % (b[3], b[2], b[1], b[0]), "ID"),
        ("encrypted", "%02X%02X%02X%02X" % (b[10], b[9], b[8], b[7])),
        ("button_code", button, "Button Code"),
        ("button_str", "; ".join(pressed), "Button"),
        ("sequence", (b[5] << 8) | b[6], "Sequence"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("six_sc_two_car_remote")
def six_sc_two_car_remote(bits, dev):
    """MIC6SC2-CarRemote (ref src/devices/mic6sc2_car_remote.c)."""
    row = bits.find_repeated_row(1, 48)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 88:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] != 0x55 or b[1] != 0x54:
        return DECODE_FAIL_SANITY
    if util.xor_bytes(bytes(b[2:11]), 9):
        return DECODE_FAIL_MIC
    encrypted = (util.reverse8(b[5]) << 24) | (util.reverse8(b[4]) << 16) \
        | (util.reverse8(b[3]) << 8) | util.reverse8(b[2])
    button = util.reverse8(b[6]) & 0xF
    sequence = (util.reverse8(b[8]) << 8) | util.reverse8(b[7])
    button_str = {0x1: "Unlock", 0x2: "Lock", 0x3: "Trunk",
                  0x4: "Panic"}.get(button, "?")
    return [Event.make(
        ("model", "MIC6SC2-CarRemote", "model"),
        ("encrypted", "%08X" % encrypted),
        ("button_code", button, "Button Code"),
        ("button_str", button_str, "Button"),
        ("sequence", sequence, "Sequence"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("alps_fwb1u545_car_remote")
def alps_fwb1u545(bits, dev):
    """Alps-FWB1U545 car remote (ref src/devices/alps_fwb1u545.c)."""
    if bits.bits_per_row[0] != 76 or bits.num_rows > 1:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if b[0] != 0x55 or b[5] != b[6]:
        return DECODE_FAIL_SANITY
    id_ = (b[1] << 24) | (b[2] << 16) | (b[3] << 8) | b[4]
    if id_ == 0 or id_ == 0xFFFFFFFF:
        return DECODE_FAIL_SANITY
    button = b[5] >> 4
    button_str = {0xE: "Lock", 0xC: "Panic", 0x5: "Panic Held",
                  0x1: "Unlock"}.get(button, "?")
    return [Event.make(
        ("model", "Alps-FWB1U545", "model"),
        ("id", "%08X" % id_, "ID"),
        ("button_code", button, "Button Code"),
        ("button_str", button_str, "Button"),
        ("sequence", (b[7] << 8) | b[8], "Sequence"),
    )]


@decoder("tpms_porsche")
def tpms_porsche(bits, dev):
    """Porsche TPMS (ref src/devices/tpms_porsche.c)."""
    out = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0x33, 0x33, 0x20]), 20)
        if bitpos + 100 > bits.bits_per_row[0]:
            break
        packet = BitBuffer()
        bits.differential_manchester_decode(0, bitpos + 20, packet, 80)
        bitpos += 2
        if packet.bits_per_row[0] < 80:
            continue
        b = _ints(packet.bb[0])
        if util.crc16(bytes(b[:10]), 10, 0x1021, 0xFFFF) != 0:
            continue
        id_ = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
        out.append(Event.make(
            ("model", "Porsche"),
            ("type", "TPMS"),
            ("id", "%08x" % id_),
            ("pressure_kPa", float(b[4] * 5 // 2 - 100), "Pressure",
             "%.1f kPa"),
            ("temperature_C", float(b[5] - 40), "Temperature", "%.0f C"),
            ("flags", (b[6] << 8) | b[7], "", "%04x"),
            ("mic", "CRC", "Integrity"),
        ))
    return out


def _nissan_checksum(b):
    """sum2N checksum (ref src/devices/tpms_nissan.c:17-31)."""
    chk = 0
    for i in range(4):
        chk += (b[i] >> 7) + (b[i] >> 5) + (b[i] >> 3) + (b[i] >> 1) \
            + ((b[i] << 1) & 0xFF)
    chk += (b[4] >> 7) + (b[4] >> 5) + (b[4] >> 3)
    return ~chk & 0x03


@decoder("tpms_nissan")
def tpms_nissan(bits, dev):
    """Nissan TPMS (ref src/devices/tpms_nissan.c)."""
    out = []
    ret = 0
    bitpos = 0
    preamble = bytes([0xF5, 0x55, 0x55, 0x55, 0xE0])
    while True:
        bitpos = bits.search(0, bitpos, preamble, 36)
        if bitpos + 77 > bits.bits_per_row[0]:
            break
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos + 36, packet, 113)
        bitpos += 1
        if packet.bits_per_row[0] < 37:
            ret = DECODE_FAIL_SANITY
            continue
        packet.invert()
        b = _ints(packet.bb[0])
        if _nissan_checksum(b) != 0:
            ret = DECODE_FAIL_MIC
            continue
        id_ = ((b[0] & 0x1F) << 19) | (b[1] << 11) | (b[2] << 3) | (b[3] >> 5)
        pressure_raw = ((b[3] & 0x1F) << 3) | (b[4] >> 5)
        out.append(Event.make(
            ("model", "Nissan"),
            ("type", "TPMS"),
            ("id", "%06x" % id_),
            ("mode", b[0] >> 5),
            ("pressure_PSI", pressure_raw / 4.0 - 3.0, "Pressure",
             "%.1f PSI"),
            ("unknown", (b[4] & 0x1F) >> 3),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out if out else ret


@decoder("tpms_jansite_solar")
def tpms_jansite_solar(bits, dev):
    """Jansite-Solar TPMS (ref src/devices/tpms_jansite_solar.c)."""
    out = []
    ret = 0
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xA6, 0xA6, 0x5A]), 24)
        if bitpos + 80 > bits.bits_per_row[0]:
            break
        packet = BitBuffer()
        bits.manchester_decode(0, bitpos, packet, 88)
        packet.invert()
        bitpos += 2
        if packet.bits_per_row[0] < 88:
            ret = DECODE_FAIL_SANITY
            continue
        b = _ints(packet.bb[0])
        if ((b[0] << 8) | b[1]) != 0xDD33:
            ret = DECODE_FAIL_SANITY
            continue
        if ((b[9] << 8) | b[10]) != util.crc16(bytes(b[2:9]), 7, 0x8005, 0):
            ret = DECODE_FAIL_MIC
            continue
        id_ = (b[2] << 16) | (b[3] << 8) | b[4]
        out.append(Event.make(
            ("model", "Jansite-Solar"),
            ("type", "TPMS"),
            ("id", "%06x" % id_),
            ("flags", b[5]),
            ("pressure_kPa", b[7] * 1.6, "Pressure", "%.0f kPa"),
            ("temperature_C", b[6] - 55.0, "Temperature", "%.0f C"),
            ("code", "".join("%02x" % x for x in b[2:11])),
            ("mic", "CRC", "Integrity"),
        ))
    return out if out else ret


@decoder("tpms_schrader_motorcycle")
def tpms_schrader_motorcycle(bits, dev):
    """Schrader-Motorcycle TPMS (ref src/devices/
    tpms_schrader_motorcycle.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    n = bits.bits_per_row[0]
    pos = bits.search(0, 0, bytes([0x7F, 0xF8]), 13)
    if pos >= n:
        return DECODE_ABORT_EARLY
    pos += 13
    if n - pos < 56:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 56))
    if util.crc8(bytes(b[:7]), 7, 0x07, 0xE0):
        return DECODE_FAIL_MIC
    id_ = ((b[0] & 0x03) << 22) | (b[1] << 14) | (b[2] << 6) | (b[3] >> 2)
    pressure_raw = ((b[3] & 0x03) << 8) | b[4]
    return [Event.make(
        ("model", "Schrader-Motorcycle"),
        ("type", "TPMS"),
        ("id", id_, "", "%u"),
        ("pressure_kPa", pressure_raw * 0.5, "Pressure", "%.1f kPa"),
        ("temperature_C", float(b[5] - 50), "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("mcpower_kinetic")
def mcpower_kinetic(bits, dev):
    """McPower-Kinetic switch (ref src/devices/mcpower_kinetic.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0xAA, 0xAA]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    pos += 16
    if bits.bits_per_row[0] - pos < 48:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 48))
    if util.crc16(bytes(b[:4]), 4, 0x1021, 0xAA55) != ((b[4] << 8) | b[5]):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "McPower-Kinetic"),
        ("id", (b[0] << 8) | b[1], "", "%04x"),
        ("button_left", (b[2] >> 6) & 1, "Left button"),
        ("button_right", (b[2] >> 5) & 1, "Right button"),
        ("counter", b[2] & 0xF, "Counter"),
        ("flags", b[3], "Flags", "%02x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("revolt_nc5462")
def revolt_nc5462(bits, dev):
    """Revolt-NC5462 power meter (ref src/devices/revolt_nc5462.c)."""
    bits.invert()
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 104:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[0])
    s = sum(b[:11])
    if s == 0:
        return DECODE_FAIL_SANITY
    if (s & 0xFF) != b[11]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Revolt-NC5462"),
        ("id", ((b[0] & 0x7F) << 8) | b[1], "House Code"),
        ("voltage_V", b[2], "Voltage", "%d V"),
        ("current_A", ((b[3] << 8) | b[4]) * 0.01, "Current", "%.2f A"),
        ("frequency_Hz", b[5], "Frequency", "%d Hz"),
        ("power_W", ((b[6] << 8) | b[7]) * 0.1, "Power", "%.2f W"),
        ("power_factor_VA", b[8] * 0.01, "Power factor", "%.2f VA"),
        ("energy_kWh", ((b[9] << 8) | b[10]) * 0.01, "Energy", "%.2f kWh"),
        ("button", b[0] >> 7, "Button"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("ert_scm")
def ert_scm(bits, dev):
    """ERT-SCM utility meter (ref src/devices/ert_scm.c)."""
    if bits.bits_per_row[0] != 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if not b[0] and not b[1] and not b[2] and not b[3]:
        return DECODE_FAIL_SANITY
    if util.crc16(bytes(b[2:12]), 10, 0x6F63, 0):
        return DECODE_FAIL_MIC
    consumption = (b[4] << 16) | (b[5] << 8) | b[6]
    ert_id = ((b[2] & 0x06) << 23) | (b[7] << 16) | (b[8] << 8) | b[9]
    return [Event.make(
        ("model", "ERT-SCM"),
        ("id", ert_id, "Id"),
        ("physical_tamper", (b[3] & 0xC0) >> 6, "Physical Tamper"),
        ("ert_type", (b[3] >> 2) & 0x0F, "ERT Type"),
        ("encoder_tamper", b[3] & 0x03, "Encoder Tamper"),
        ("consumption_data", consumption, "Consumption Data"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("philips_aj7010")
def philips_aj7010(bits, dev):
    """Philips-AJ7010 (ref src/devices/philips_aj7010.c)."""
    bits.invert()
    if bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    if bits.bits_per_row[0] != 40:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if not b[0] and not b[2] and not b[3] and not b[4]:
        return DECODE_FAIL_SANITY
    if b[0] != 0x00:
        return DECODE_FAIL_SANITY
    if util.xor_bytes(bytes(b[:5]), 5) and \
            util.xor_bytes(bytes(b[:3]), 3) ^ b[4]:
        return DECODE_FAIL_MIC
    channel = {0x36: 3, 0x45: 2, 0x5A: 1}.get(b[1], 0)
    temp_raw = ((b[3] & 0x3F) << 8) | b[2]
    return [Event.make(
        ("model", "Philips-AJ7010"),
        ("channel", channel, "Channel"),
        ("temperature_C", temp_raw / 353.0 - 9.2, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

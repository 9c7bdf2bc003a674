"""Remotes / home automation, part 4 (reference files cited per
function): RojaFlex shutters, Universal 24V fan controller, Martec
MPLCD fan remote, CED7000 shot timer.
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


_ROJAFLEX_CMDS = {
    0x0A: "Stop", 0x1A: "Up", 0x8A: "Down",
    0x9A: "Save/Unsave position", 0xDA: "Go saved position",
    0xEA: "Request Status", 0x85: "Pos. Status 0%", 0x95: "Pos. Status 20%",
    0xA5: "Pos. Status 40%", 0xB5: "Pos. Status 60%",
    0xC5: "Pos. Status 80%", 0xD5: "Pos. Status 100%",
}


@decoder("rojaflex")
def rojaflex(bits, dev):
    """RojaFlex shutter and remote devices (ref src/devices/rojaflex.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pre = bytes([0xAA, 0xAA, 0xD3, 0x91, 0xD3, 0x91])
    start = bits.search(0, 0, pre, 48)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    nbits = (bits.bits_per_row[0] - start - 48) & 0xFE
    if nbits < 88 - 16 or nbits > 88:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.extract_bytes(0, start + 48, nbits))
    msg += [0] * (11 - len(msg))
    has_crc = nbits == 88
    if has_crc:
        if ((msg[9] << 8) | msg[10]) != util.crc16(bytes(msg[:9]), 9,
                                                   0x8005, 0xFFFF):
            return DECODE_FAIL_MIC
    if (msg[5] & 0xF) == 0x5:
        model = "RojaFlex-Shutter"
    elif (msg[5] & 0xF) == 0xA:
        model = "RojaFlex-Remote" if has_crc else "RojaFlex-Bridge"
    else:
        model = "RojaFlex-Other"
    return [Event.make(
        ("model", model, "Model"),
        ("id", (msg[1] << 20) | (msg[2] << 12) | (msg[3] << 4)
         | (msg[4] >> 4), "ID", "%07x"),
        ("channel", msg[4] & 0xF, "Channel"),
        ("token", (msg[7] << 8) | msg[8], "Msg Token", "%04x"),
        ("cmd_id", msg[5], "Value", "%02x"),
        ("cmd_name", _ROJAFLEX_CMDS.get(msg[5], "unknown"), "Command"),
        ("cmd_value", msg[6], "Value"),
        ("mic", "CRC", "Integrity") if has_crc else None,
    )]


_UNIFAN_BUTTONS = {
    0x19: "All Off", 0x17: "Light On/Off", 0x1B: "Forward", 0x0A: "Fan",
    0x0E: "Reverse", 0x09: "Fan Off", 0x0F: "Speed 1", 0x0D: "Speed 2",
    0x03: "Speed 3", 0x15: "Speed 4", 0x10: "Speed 5", 0x13: "speed 6",
    0x1D: "1H", 0x16: "2H", 0x06: "3H",
}


@decoder("universalfanctrl")
def universalfanctrl(bits, dev):
    """Universal 24V fan controller (ref src/devices/universalfanctrl.c)."""
    row = bits.find_repeated_row(3, 33)
    if row < 0:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if not (b[4] & 0x80):
        return DECODE_FAIL_SANITY
    s = util.xor_bytes(bytes(b[:4]))
    if ((s >> 4) ^ (s & 0xF)) != 0xA:
        return DECODE_FAIL_MIC
    button = ((b[2] & 0x0F) << 1) + ((b[3] & 0x80) >> 7)
    return [Event.make(
        ("model", "UniFan-24V"),
        ("id", (b[0] << 12) + (b[1] << 4) + (b[2] >> 4), "Transmitter ID"),
        ("button", _UNIFAN_BUTTONS.get(button, "Unknown"), "Button"),
        ("button_code", button, "Button Code"),
        ("counter", (b[3] & 0x7F) >> 4, "Rolling Counter"),
        ("mic", "CHECKSUM", ""),
    )]


_MARTEC_SPEEDS = ["off", "high", "medium", "low"]


@decoder("martec_mplcd")
def martec_mplcd(bits, dev):
    """Martec MPLCD ceiling fan remote (ref src/devices/martec_mplcd.c)."""
    row = bits.find_repeated_row(2, 22)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 22:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(row, 1, 21))
    checksum = util.add_nibbles(bytes(b[:2]), 2) & 0x0F
    if checksum != ((b[2] >> 3) & 0x0F):
        return DECODE_FAIL_MIC
    if b[0] == 0 and b[1] == 0:
        return DECODE_FAIL_SANITY
    channel = util.reflect4((~b[0] >> 1) & 0x0F)
    dimmer = ((b[0] & 0x01) << 6) + ((b[1] >> 2) & 0x3F)
    if dimmer > 0:
        dimmer = 42 - dimmer
    return [Event.make(
        ("model", "Martec-MPLCD"),
        ("id", channel, ""),
        ("dimmer", dimmer, ""),
        ("speed", _MARTEC_SPEEDS[b[1] & 0x03], ""),
        ("mic", "CHECKSUM", ""),
    )]


@decoder("ced7000")
def ced7000(bits, dev):
    """CED7000 shot timer (ref src/devices/ced7000.c)."""
    row = bits.find_repeated_row(2, 6 * 16 + 3 * 8)
    if row < 0:
        return DECODE_ABORT_EARLY
    bitpos = bits.search(row, 0, bytes([0xAA, 0x4D, 0x5E]), 24) + 24
    if bitpos >= bits.bits_per_row[row]:
        return DECODE_ABORT_EARLY
    bits.invert()
    decoded = BitBuffer()
    ret = bits.manchester_decode(row, bitpos, decoded, 169)
    if ret != 202:
        return DECODE_FAIL_MIC
    b = _ints(decoded.bb[0])[:(ret // 8 + 1)]
    b = _ints(util.reflect_nibbles(bytes(b[:ret // 8])))
    sid = ((b[1] & 0xF) * 1000 + (b[1] >> 4) * 100 + (b[0] & 0xF) * 10
           + (b[0] >> 4))
    count = (b[2] & 0xF) * 10 + (b[2] >> 4)
    final = ((b[5] >> 4) * 100 + (b[4] & 0xF) * 10 + (b[4] >> 4)
             + (b[3] & 0xF) * 0.1 + (b[3] >> 4) * 0.01)
    split = ((b[7] & 0xF) * 100 + (b[7] >> 4) * 10 + (b[6] & 0xF)
             + (b[6] >> 4) * 0.1 + (b[5] & 0xF) * 0.01)
    return [Event.make(
        ("model", "CED7000", "Model"),
        ("id", sid, "ID", "%04u"),
        ("count", count, "Shot Count"),
        ("final", final, "Final Time", "%.2f s"),
        ("split", split, "Split Time", "%.2f s"),
    )]

"""Microchip KeeLoq hopping-code remotes (reference files cited per
function): HCS361 (6 timing variants), HCS362 (PWM + Manchester).
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


def _hcs361_decode(bits, dev):
    """HCS361 common decode (ref src/devices/hcs361.c)."""
    if bits.num_rows < 2 or bits.bits_per_row[1] != 67:
        return DECODE_ABORT_LENGTH
    r0 = _ints(bits.bb[0])
    if bits.bits_per_row[0] == 6 and r0[0] != 0xFC:
        return DECODE_FAIL_SANITY
    if bits.bits_per_row[0] == 7 and r0[0] != 0xFE:
        return DECODE_FAIL_SANITY
    if bits.bits_per_row[0] == 12:
        preamble = (r0[0] << 8) | r0[1]
        if preamble != 0xAAA0 and preamble != 0xFFF0:
            return DECODE_FAIL_SANITY
    b = _ints(bits.bb[1])
    if all(b[i] == 0xFF for i in range(8)):
        return DECODE_FAIL_SANITY
    crc = 0
    crc_bat_low = 0
    actual_crc = (b[8] >> 5) & 0x3
    for i in range(65):
        bit = b[i // 8] >> (7 - (i % 8))
        crc_bit = ((crc >> 1) ^ bit) & 0x1
        if i == 64:
            crc_bit_bat_low = ((crc >> 1) ^ ~bit) & 0x1
            crc_bat_low = crc_bit_bat_low | (
                ((crc_bit_bat_low ^ crc) << 1) & 0x2)
        crc = crc_bit | (((crc_bit ^ crc) << 1) & 0x2)
    if actual_crc != crc and actual_crc != crc_bat_low:
        return DECODE_FAIL_MIC
    encrypted = ((util.reverse8(b[3]) << 24) | (util.reverse8(b[2]) << 16)
                 | (util.reverse8(b[1]) << 8) | util.reverse8(b[0]))
    serial = ((util.reverse8(b[7] & 0xF0) << 24)
              | (util.reverse8(b[6]) << 16) | (util.reverse8(b[5]) << 8)
              | util.reverse8(b[4]))
    btn = b[7] & 0x0F
    btn_num = ((btn & 0x08) | ((btn & 0x01) << 2) | (btn & 0x02)
               | ((btn & 0x04) >> 2))
    if serial == 0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Microchip-HCS361"),
        ("id", "%08X" % serial, ""),
        ("battery_ok", int((b[8] & 0x80) == 0x80), "Battery"),
        ("button", btn_num, "Button"),
        ("encrypted", "%08X" % encrypted, ""),
        ("mic", "CRC", "Integrity"),
    )]


for _sym in ("hcs361_txwak_0_bsel_0", "hcs361_txwak_0_bsel_1",
             "hcs361_txwak_1_bsel_0", "hcs361_txwak_1_bsel_1",
             "hcs361_vpwm_1_bsel_0", "hcs361_vpwm_1_bsel_1"):
    decoder(_sym)(_hcs361_decode)


def _hcs362_crc(b):
    crc0 = crc1 = 0
    for n in range(65):
        d = (b[n // 8] >> (7 - (n % 8))) & 1
        next_crc1 = crc0 ^ d
        next_crc0 = crc0 ^ d ^ crc1
        crc0, crc1 = next_crc0, next_crc1
    return (crc1 << 1) | crc0


def _hcs362_decode(bits, dev, is_mc):
    """HCS362 common decode (ref src/devices/hcs362.c)."""
    if is_mc:
        if bits.bits_per_row[0] < 12 * 2 - 8 or \
                bits.bits_per_row[0] > 12 * 2 + 8:
            return DECODE_ABORT_LENGTH
        b = _ints(bits.bb[0])
        if b[0] != 0xAA or b[1] != 0xAA or b[2] != 0xAA:
            return DECODE_ABORT_EARLY
        if bits.num_rows < 2 or bits.bits_per_row[1] < 71 * 2 \
                or bits.bits_per_row[1] > 72 * 2 + 4:
            return DECODE_ABORT_LENGTH
        b = _ints(bits.bb[1])
        if (b[0] & 0xC0) != 0x80:
            return DECODE_ABORT_EARLY
        msg = BitBuffer()
        # the reference checks the consumed raw position, not the decoded
        # bit count (ref src/devices/hcs362.c:129)
        length = bits.manchester_decode(1, 2, msg, 72)
        if length < 69 + 1:
            return DECODE_ABORT_LENGTH
        msg.invert()
        b = _ints(msg.bb[0])
    else:
        if bits.bits_per_row[0] != 12 or (bits.num_rows < 2
                                          or bits.bits_per_row[1] != 69):
            return DECODE_ABORT_LENGTH
        b = _ints(bits.bb[0])
        if b[0] != 0xFF or (b[1] & 0xF0) != 0xF0:
            return DECODE_ABORT_EARLY
        b = _ints(bits.bb[1])
    if all(b[i] == 0xFF for i in range(1, 8)):
        return DECODE_FAIL_SANITY
    actual_crc = ((b[8] >> 6) & 1) | (((b[8] >> 5) & 1) << 1)
    if actual_crc != _hcs362_crc(b):
        return DECODE_FAIL_MIC
    encrypted = ((util.reverse8(b[3]) << 24) | (util.reverse8(b[2]) << 16)
                 | (util.reverse8(b[1]) << 8) | util.reverse8(b[0]))
    serial = ((util.reverse8(b[7] & 0xF0) << 24)
              | (util.reverse8(b[6]) << 16) | (util.reverse8(b[5]) << 8)
              | util.reverse8(b[4]))
    btn = b[7] & 0x0F
    btn_num = ((btn & 0x08) | ((btn & 0x01) << 2) | (btn & 0x02)
               | ((btn & 0x04) >> 2))
    queue = ((b[8] >> 4) & 1) | (((b[8] >> 3) & 1) << 1)
    return [Event.make(
        ("model", "Microchip-HCS362"),
        ("id", "%07X" % serial, ""),
        ("battery_ok", int(not ((b[8] & 0x80) == 0x80)), "Battery"),
        ("button", btn_num, "Button"),
        ("repeat", queue, "Repeat"),
        ("encrypted", "%08X" % encrypted, ""),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("hcs362_pwm")
def hcs362_pwm(bits, dev):
    """HCS362 PWM mode (ref src/devices/hcs362.c)."""
    return _hcs362_decode(bits, dev, False)


@decoder("hcs362_mc")
def hcs362_mc(bits, dev):
    """HCS362 Manchester mode (ref src/devices/hcs362.c)."""
    return _hcs362_decode(bits, dev, True)

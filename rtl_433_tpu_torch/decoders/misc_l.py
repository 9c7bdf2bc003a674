"""Misc decoders batch L (reference files cited per function):
Elero blinds remote, Elsner Solexa 230V.
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


_ELERO_NIBBLE = [0x0A, 0x03, 0x01, 0x0C, 0x0D, 0x07, 0x0F, 0x06, 0x00,
                 0x08, 0x0B, 0x0E, 0x09, 0x02, 0x05, 0x04]


def _elero_decode_command(msg):
    """Obfuscated command block decode (ref src/devices/elero.c:56)."""
    for i in range(8):
        nh = _ELERO_NIBBLE[(msg[i] >> 4) & 0xF]
        nl = _ELERO_NIBBLE[msg[i] & 0xF]
        msg[i] = (nh << 4) | nl
    key = 0xFE
    for i in range(2):
        ln = (msg[i] - key) & 0x0F
        hn = ((msg[i] & 0xF0) - (key & 0xF0)) & 0xFF
        msg[i] = hn | ln
        key = (key - 0x22) & 0xFF
    xor_b0 = msg[0]
    xor_b1 = msg[1]
    for i in range(0, 8, 2):
        msg[i] ^= xor_b0
        msg[i + 1] ^= xor_b1
    key = 0xBA
    for i in range(2, 8):
        ln = (msg[i] - key) & 0x0F
        hn = ((msg[i] & 0xF0) - (key & 0xF0)) & 0xFF
        msg[i] = hn | ln
        key = (key - 0x22) & 0xFF
    return msg


@decoder("elero")
def elero(bits, dev):
    """Elero blinds/awning remote (ref src/devices/elero.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, bytes([0xA7, 0x23, 0xA7, 0x23]), 31)
    if start == bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    start += 31
    avail_bits = bits.bits_per_row[0] - start
    if avail_bits < 8:
        return DECODE_ABORT_LENGTH
    avail_bytes = min(avail_bits // 8, 40)
    frame = _ints(util.ibm_whitening(bytes(
        _ints(bits.extract_bytes(0, start, avail_bytes * 8)))))
    frame += [0] * (40 - len(frame))
    length = frame[0]
    total = length + 3
    if total > 40 or avail_bytes < total:
        return DECODE_ABORT_LENGTH
    crc_calc = util.crc16(bytes(frame[:total - 2]), total - 2, 0x8005,
                          0xFFFF)
    if crc_calc != ((frame[total - 2] << 8) | frame[total - 1]):
        return DECODE_FAIL_MIC
    ndst = frame[16]
    if 17 + ndst + 2 + 8 + 2 > total:
        return DECODE_FAIL_SANITY
    src = (frame[7] << 16) | (frame[8] << 8) | frame[9]
    channel_str = "".join("%02X" % frame[17 + i] for i in range(ndst))
    enc = _elero_decode_command(list(frame[17 + ndst + 2:
                                           17 + ndst + 10]))
    command_str = {0x20: "Up", 0x10: "Stop", 0x40: "Down"}.get(enc[2], "?")
    return [Event.make(
        ("model", "Elero"),
        ("id", "%06X" % src, "ID"),
        ("channel", channel_str, "Channel"),
        ("command", command_str, "Command"),
        ("counter", frame[1], "Counter"),
        ("mic", "CRC", "Integrity"),
    )]


def _elsner_spread(x, k):
    v = (x << k) & 0xFF
    if x & 1:
        v |= (1 << k) - 1
    return v


def _elsner_step(prev, base, old, new_):
    return (_elsner_spread(prev, 1) + base + new_ - old) & 0xFF


def _elsner_xform(inb, nbytes, taps):
    nbits = nbytes * 8
    out = [0] * nbytes
    for n in range(nbits):
        bit = (inb[n // 8] >> (7 - (n % 8))) & 1
        for t in taps:
            if n - t >= 0:
                bit ^= (inb[(n - t) // 8] >> (7 - ((n - t) % 8))) & 1
        out[n // 8] |= bit << (7 - (n % 8))
    return out


_ELSNER_CMDS = {0xCC00: "close", 0xBB00: "open",
                0xBD00: "stop_or_release", 0x00EF: "automode_a",
                0x00E3: "automode_b", 0xAAC0: "filler",
                0xA9C0: "automode_companion"}


@decoder("elsner_solexa")
def elsner_solexa(bits, dev):
    """Elsner Solexa 230V (ref src/devices/elsner_solexa.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x0A]), 8) + 8
    length = bits.bits_per_row[0]
    if pos >= length or length - pos < 38 * 8:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, pos, 38 * 8))
    crc_calc = util.crc16(bytes(b[:36]), 36, 0x1021, 0x68B3)
    if crc_calc != ((b[36] << 8) | b[37]):
        return DECODE_FAIL_MIC
    p = _elsner_xform(b, 36, (5, 7))
    id_str = "%02x%02x%02x%02x" % (p[0], p[1], p[2], p[3])
    payload_str = "".join("%02x" % p[4 + i] for i in range(32))
    rp0 = b[4]
    param_ok = (b[7] == ((_elsner_spread(rp0, 3) + 0x48) & 0xFF)
                and b[8] == ((_elsner_spread(rp0, 4) + 0xD0) & 0xFF)
                and b[9] == ((_elsner_spread(rp0, 5) + 0xA0) & 0xFF))
    counter = (b[5] - _elsner_spread(rp0, 1)) & 0xFF
    q = _elsner_xform(b, 36, (7,))
    family1 = (q[4 + 3] >> 4) & 1
    command = None
    if param_ok and family1:
        branch1 = (q[4 + 17] >> 2) & 1
        l12 = util.parity8(rp0 & 0xF9)
        l13 = util.parity8(rp0 & 0xFD)
        l14 = 1 ^ util.parity8(rp0 & 0xFF)
        l17 = util.parity8(rp0 & 0xFE)
        l18 = 1 ^ util.parity8(rp0 & 0xFF)
        l19 = util.parity8(rp0 & 0xFE)
        if not branch1:
            exp0 = _elsner_step(b[4 + 12], 0x6A, l12, l13)
            exp1 = _elsner_step(exp0, 0x30, l13, l14)
            obs0 = b[4 + 13]
            obs1 = b[4 + 14]
        else:
            exp0 = _elsner_step(b[4 + 17], 0x30, l17, l18)
            exp1 = _elsner_step(exp0, 0x30, l18, l19)
            obs0 = b[4 + 18]
            obs1 = b[4 + 19]
        token = (((obs0 - exp0) & 0xFF) << 8) | ((obs1 - exp1) & 0xFF)
        command = _ELSNER_CMDS.get(token)
    return [Event.make(
        ("model", "Elsner-Solexa"),
        ("id", id_str, "Sync/ID"),
        ("rolling", "%02x" % rp0, "Rolling state") if param_ok else None,
        ("counter", counter, "Counter") if param_ok else None,
        ("command", command, "Command") if command is not None else None,
        ("data", payload_str, "Data"),
        ("mic", "CRC", "Integrity"),
    )]

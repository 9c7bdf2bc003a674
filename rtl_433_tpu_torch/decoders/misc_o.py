"""Misc decoders batch O (reference files cited per function):
Risco Agility PIR, EnOcean ERP1, Garmin ANT/ANT+, Somfy io-homecontrol.
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


def _gray(n):
    p = n
    n >>= 1
    while n:
        p ^= n
        n >>= 1
    return p


@decoder("risco_agility")
def risco_agility(bits, dev):
    """Risco 2-way Agility PIR/PET RWX95P
    (ref src/devices/risco_agility.c:105)."""
    len_msg = 16
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, bytes([0x55, 0x5A]), 16)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    dec = BitBuffer()
    bits.differential_manchester_decode(0, pos + 16, dec, len_msg * 8)
    if dec.bits_per_row[0] < len_msg * 8:
        return DECODE_ABORT_LENGTH
    b = _ints(dec.bb[0])[:len_msg]
    if util.crc16(bytes(b), len_msg, 0x8005, 0x8181):
        return DECODE_FAIL_MIC
    if ((b[0] << 8) | b[1]) != 0xFF60:
        return DECODE_ABORT_LENGTH
    rid = (b[6] << 16) | (b[7] << 8) | b[8]
    b = _ints(util.reflect_bytes(bytes(b)))
    state = _gray(b[12] & 0xF)
    tamper = (state & 0x4) >> 2
    motion = (state & 0x2) >> 1
    low_batt = (_gray((b[12] & 0xF0) >> 4) & 0x8) >> 3
    counter = _gray((b[5] << 8) | b[4])
    return [Event.make(
        ("model", "Risco-RWX95P"),
        ("id", rid, ""),
        ("counter", counter, "Counter"),
        ("tamper", 1, "Tamper") if tamper else None,
        ("motion", 1, "Motion") if motion else None,
        ("battery_ok", int(not low_batt), "Battery_OK"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("enocean_erp1")
def enocean_erp1(bits, dev):
    """EnOcean ERP1 (ref src/devices/enocean_erp1.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bits.invert()
    start = bits.search(0, 0, bytes([0x55, 0x20]), 11)
    if start >= bits.bits_per_row[0]:
        return DECODE_FAIL_SANITY
    row = _ints(bits.bb[0])
    end = bits.bits_per_row[0]

    def bit_at(p):
        if (p >> 3) >= len(row):
            return 0
        return (row[p >> 3] >> (7 - (p & 7))) & 1

    out = []  # decoded bit list

    def decode_8of12(pos):
        """8/12 group decode (ref src/devices/enocean_erp1.c:21)."""
        if pos + 12 > end:
            return DECODE_ABORT_LENGTH
        out.append(bit_at(pos))
        out.append(bit_at(pos + 1))
        b2 = bit_at(pos + 2)
        out.append(b2)
        if b2 != (0 if bit_at(pos + 3) else 1):
            return DECODE_FAIL_SANITY
        out.append(bit_at(pos + 4))
        out.append(bit_at(pos + 5))
        b6 = bit_at(pos + 6)
        out.append(b6)
        if b6 != (0 if bit_at(pos + 7) else 1):
            return DECODE_FAIL_SANITY
        out.append(bit_at(pos + 8))
        out.append(bit_at(pos + 9))
        return (bit_at(pos + 10) << 1) | bit_at(pos + 11)

    pos = start + 11
    more = 0x01
    while True:
        more = decode_8of12(pos) & 0xFF
        pos += 12
        if not (pos < end and more == 0x01):
            break
    nbits = len(out)
    if nbits < 16:
        return DECODE_ABORT_LENGTH
    by = [0] * ((nbits + 7) // 8)
    for i, bit in enumerate(out):
        if bit:
            by[i >> 3] |= 0x80 >> (i & 7)
    chk = util.crc8(bytes(by), (nbits - 1) // 8, 0x07, 0x00)
    p = nbits - 8
    last = 0
    for i in range(8):
        q = p + i
        byte = by[q >> 3] if (q >> 3) < len(by) else 0
        last = (last << 1) | ((byte >> (7 - (q & 7))) & 1)
    if chk != last:
        return DECODE_FAIL_MIC
    tstr = "".join("%02x" % x for x in by[:(nbits + 7) // 8])
    return [Event.make(
        ("model", "EnOcean-ERP1"),
        ("telegram", tstr, ""),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ant_antplus")
def ant_antplus(bits, dev):
    """Garmin ANT / ANT+ (ref src/devices/ant_antplus.c)."""
    if bits.bits_per_row[0] < 120 or bits.bits_per_row[0] > 200:
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, bytes([0xAA]), 8) + 8
    if bit_offset + 17 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bit_offset, 17 * 8))
    if util.crc16(bytes(b), 17, 0x1021, 0xFFFF) != 0:
        b = _ints(bits.extract_bytes(0, bit_offset + 1, 17 * 8))
        if util.crc16(bytes(b), 17, 0x1021, 0xFFFF) != 0:
            return DECODE_FAIL_MIC
    net_key = (b[1] << 8) | b[0]
    did = (b[3] << 8) | b[2]
    payload = " ".join("%02x" % x for x in b[7:15])
    return [Event.make(
        ("model", "Garmin-ANT"),
        ("network", "ANT+" if net_key == 0xC5A6 else "ANT", "Network"),
        ("channel", net_key, "Net key", "0x%04x"),
        ("id", did, "Device #", "0x%04x"),
        ("device_type", b[4], "Device type"),
        ("tx_type", b[5], "TX type"),
        ("payload", payload, "Payload"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("somfy_iohc")
def somfy_iohc(bits, dev):
    """Somfy io-homecontrol (ref src/devices/somfy_iohc.c:98)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    offset = bits.search(0, 0, bytes([0x57, 0xFD, 0x99]), 24) + 24
    if offset >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    num_bits = min(bits.bits_per_row[0] - offset, 34 * 10)
    b = _ints(util.extract_bytes_uart_8n1(bits.bb[0], offset, num_bits))
    length = len(b)
    b += [0] * (34 - length)
    if length < 11:
        return DECODE_ABORT_LENGTH
    msg_len = b[0] & 0x1F
    if length < msg_len + 3:
        return DECODE_ABORT_LENGTH
    if msg_len < 8:
        return DECODE_ABORT_LENGTH
    length = msg_len + 3
    end_flag = (b[0] & 0x80) >> 7
    start_flag = (b[0] & 0x40) >> 6
    protocol_mode = (b[0] & 0x20) >> 5
    use_beacon = (b[1] & 0x80) >> 7
    is_routed = (b[1] & 0x40) >> 6
    low_power = (b[1] & 0x20) >> 5
    version = b[1] & 0x03
    dst_addr = (b[2] << 16) | (b[3] << 8) | b[4]
    src_addr = (b[5] << 16) | (b[6] << 8) | b[7]
    cmd_id = b[8]
    seq_nr = 0
    mac = ""
    data_length = msg_len - 8
    if protocol_mode == 0 or data_length < 8:
        msg_data = "".join("%02x" % x for x in b[9:9 + data_length])
    else:
        data_length -= 8
        msg_data = "".join("%02x" % x for x in b[9:9 + data_length])
        seq_nr = (b[9 + data_length] << 8) | b[9 + data_length + 1]
        mac = "".join("%02x" % x
                      for x in b[9 + data_length + 2:9 + data_length + 8])
    if util.crc16lsb(bytes(b[:length]), length, 0x8408, 0x0000) != 0:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Somfy-IOHC"),
        ("id", src_addr, "Source", "%06x"),
        ("dst_id", dst_addr, "Target", "%06x"),
        ("msg_type", cmd_id, "Command", "%02x"),
        ("msg", msg_data, "Message"),
        ("mode", "One-way" if protocol_mode else "Two-way", "Mode"),
        ("version", version, "Version"),
        ("counter", seq_nr, "Counter") if protocol_mode == 1 else None,
        ("mac", mac, "MAC") if protocol_mode == 1 else None,
        ("flag_end", end_flag, "End flag"),
        ("flag_start", start_flag, "Start flag"),
        ("flag_mode", protocol_mode, "Mode flag"),
        ("flag_beacon", use_beacon, "Beacon flag"),
        ("flag_routed", is_routed, "Routed flag"),
        ("flag_lpm", low_power, "LPM flag"),
        ("mic", "CRC", "Integrity"),
    )]

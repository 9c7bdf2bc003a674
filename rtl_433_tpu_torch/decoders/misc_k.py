"""Misc decoders batch K (reference files cited per function):
RFM69 Moteino, CTT wildlife tags, Landis+Gyr Gridstream.
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


@decoder("rfm69_lowpowerlab_moteino")
def rfm69_lowpowerlab_moteino(bits, dev):
    """RFM69 LowPowerLab Moteino
    (ref src/devices/rfm69_lowpowerlab_moteino.c)."""
    posn = bits.search(0, 0, bytes([0x2D]), 8)
    if posn < 24 or posn > 28:
        return DECODE_ABORT_EARLY
    message = _ints(bits.extract_bytes(0, posn - 24, 65 * 8))
    message += [0] * (72 - len(message))
    payload_len = message[5]
    if payload_len > 65:
        return DECODE_ABORT_LENGTH
    payload = _ints(bits.extract_bytes(0, posn + 16,
                                       (payload_len + 1) * 8))
    crc = (~util.crc16(bytes(payload), payload_len + 1, 0x1021, 0x1D0F)
           & 0xFFFF)
    if ((crc >> 8) != message[6 + payload_len]
            or (crc & 0xFF) != message[6 + payload_len + 1]):
        return DECODE_FAIL_MIC
    if message[7] == 0x02:
        message[6 + payload_len] = 0x00
        # the reference passes the ints as DATA_STRING pointers (UB);
        # emit sane integers instead
        msg_bytes = bytes(message[9:9 + 30])
        msg_str = msg_bytes.split(b"\x00")[0].decode("latin-1")
        return [Event.make(
            ("model", "Moteino-RFM69", "Model"),
            ("id", message[6], "Node Id "),
            ("gateway_id", message[7], "Gateway Id"),
            ("msg", msg_str, "Message"),
            ("mic", "CRC", "Integrity"),
        )]
    return 0


_MOTUS_CODE = {0x00, 0x07, 0x19, 0x1E, 0x2A, 0x2D, 0x33, 0x34, 0x4B, 0x4C,
               0x52, 0x55, 0x61, 0x66, 0x78, 0x7F, 0x80, 0x87, 0x99, 0x9E,
               0xAA, 0xAD, 0xB3, 0xB4, 0xCB, 0xCC, 0xD2, 0xD5, 0xE1, 0xE6,
               0xF8, 0xFF}


@decoder("ctt_life_power_hybrid")
def ctt_life_power_hybrid(bits, dev):
    """CTT LifeTag/PowerTag/HybridTag
    (ref src/devices/ctt_life_power_hybrid.c)."""
    events = []
    saw_bad_crc = False
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 56:
            continue
        sync_pos = bits.search(row, 0, bytes([0xD3, 0x91]), 16)
        if sync_pos >= bits.bits_per_row[row]:
            continue
        if sync_pos + 56 > bits.bits_per_row[row]:
            continue
        payload = _ints(bits.extract_bytes(row, sync_pos + 16, 40))
        if util.crc8(bytes(payload[:4]), 4, 0x07, 0x00) != payload[4]:
            saw_bad_crc = True
            continue
        cid = ((payload[0] << 24) | (payload[1] << 16) | (payload[2] << 8)
               | payload[3])
        motus_tag = int(all(p in _MOTUS_CODE for p in payload[:4]))
        events.append(Event.make(
            ("model", "CTT-Tag"),
            ("id", (cid ^ 0x80000000) - 0x80000000, "Tag ID", "0x%08X"),
            ("valid_motus", motus_tag, "Valid Motus tag"),
            ("mic", "CRC", "Integrity"),
        ))
    if events:
        return events
    return DECODE_FAIL_MIC if saw_bad_crc else 0


_GRIDSTREAM_CRC_INIT = [
    (0xE623, "Kansas City MO", "Evergy-Missouri West"),
    (0x5FD6, "Dallas TX", "Oncor"),
    (0xD553, "Austin TX", "Austin Energy"),
    (0x45F8, "Dallas TX", "CoServ"),
    (0x62C1, "Quebec CAN", "Hydro-Quebec"),
    (0x23D1, "Seattle WA", "Seattle City Light"),
    (0x2C22, "Santa Barbara CA", "Southern California Edison"),
    (0x142A, "Washington", "Puget Sound Energy"),
    (0x47F7, "Pennsylvania", "PPL Electric"),
    (0x22C6, "Long Island NY", "PSEG Long Island"),
    (0x8819, "Alameda CA", "Alameda Municipal Power"),
    (0x4E2D, "Milwaukee WI", "We Energies"),
    (0x1D65, "Phoenix AZ", "APS"),
    (0xB9A9, "Mattoon IL", "Coles-Moultrie Electric Co-op"),
    (0xD1FF, "Newark NJ", "PSEG New Jersey"),
    (0xBA1F, "Burleson TX", "United Cooperative Services"),
]


def _gridstream_checksum(fulllength, length, b, adjust):
    """CRC init-value scan (ref src/devices/gridstream.c:137)."""
    if fulllength - 4 + adjust < length:
        return DECODE_ABORT_LENGTH
    crc = (b[2 + length + adjust] << 8) | b[3 + length + adjust]
    for idx, (init, _, _) in enumerate(_GRIDSTREAM_CRC_INIT):
        if util.crc16(bytes(b[4 + adjust:4 + adjust + length - 2]),
                      length - 2, 0x1021, init) == crc:
            return idx
    return DECODE_FAIL_MIC


def _gridstream_decode(bits, dev):
    """Gridstream frame decode (ref src/devices/gridstream.c:160)."""
    pre_v4 = bytes([0xAA, 0xAA, 0x00, 0x5F, 0xF0])
    pre_v5 = bytes([0xAA, 0xAA, 0x00, 0x7F, 0xF8])
    offset = bits.search(0, 0, pre_v4, 36) + 36
    if offset >= bits.bits_per_row[0]:
        offset = bits.search(0, 0, pre_v5, 37) + 37
        if offset >= bits.bits_per_row[0]:
            return DECODE_FAIL_SANITY
        protocol_version = 5
    else:
        protocol_version = 4
    num_bits = min(bits.bits_per_row[0] - offset, 256 * 10)
    b = _ints(util.extract_bytes_uart_8n1(bits.bb[0], offset, num_bits))
    decoded_len = len(b)
    b += [0] * (256 - decoded_len)
    if decoded_len < 5:
        return DECODE_FAIL_SANITY
    if b[0] != 0x2A:
        return 0
    subtype = b[1]
    subtype_mod = 0
    if subtype == 0xD2:
        stream_len = b[2]
        subtype_mod = -1
    else:
        stream_len = (b[2] << 8) | b[3]
    ci = b[4 + subtype_mod]
    if subtype == 0xD2 and ci == 0x52:
        return [Event.make(
            ("model", "LandisGyr-GS"),
            ("subtype", subtype, ""),
            ("protoversion", protocol_version, ""),
            ("ci", ci, "CI"),
            ("encrypted", 1, "Encrypted"),
        )]
    crcidx = _gridstream_checksum(decoded_len, stream_len, b, subtype_mod)
    if crcidx < 0:
        return DECODE_FAIL_MIC
    destwan = srcwan = srcaddr = destaddr = ""
    srcwanaddress = 0
    uptime = 0
    clock = 0
    if subtype == 0x55:
        destwan = "".join("%02x" % x for x in b[5:11])
        srcwan = "".join("%02x" % x for x in b[11:17])
        srcwanaddress = 1
        srcaddr = "".join("%02x" % x for x in b[24:28])
        uptime = (b[18] << 24) | (b[19] << 16) | (b[20] << 8) | b[21]
    elif subtype == 0xD5:
        destaddr = "".join("%02x" % x for x in b[5:9])
        srcaddr = "".join("%02x" % x for x in b[9:13])
        if stream_len == 0x47:
            clock = (b[14] << 24) | (b[15] << 16) | (b[16] << 8) | b[17]
            uptime = (b[22] << 24) | (b[23] << 16) | (b[24] << 8) | b[25]
            srcwan = "".join("%02x" % x for x in b[30:36])
            srcwanaddress = 1
    init, location, provider = _GRIDSTREAM_CRC_INIT[crcidx]
    return [Event.make(
        ("model", "LandisGyr-GS"),
        ("networkID", "%04x" % init, "Network ID"),
        ("location", location, "Location"),
        ("provider", provider, "Provider"),
        ("subtype", subtype, ""),
        ("protoversion", protocol_version, ""),
        ("ci", ci, "CI"),
        ("mic", "CRC", "Integrity"),
        ("id", srcaddr, "Source Meter ID") if subtype != 0xD2 else None,
        ("wanaddress", srcwan, "Source Meter WAN ID")
        if srcwanaddress == 1 else None,
        ("destaddress", destwan, "Target Meter WAN ID")
        if subtype == 0x55 else None,
        ("destaddress", destaddr, "Target Meter ID")
        if subtype == 0xD5 else None,
        ("timestamp", (clock ^ 0x80000000) - 0x80000000, "Timestamp")
        if subtype == 0xD5 and stream_len == 0x47 else None,
        ("uptime", (uptime ^ 0x80000000) - 0x80000000, "Uptime")
        if uptime > 0 else None,
    )]


@decoder("gridstream96")
def gridstream96(bits, dev):
    """Landis+Gyr Gridstream 9.6k (ref src/devices/gridstream.c)."""
    return _gridstream_decode(bits, dev)


@decoder("gridstream192")
def gridstream192(bits, dev):
    """Landis+Gyr Gridstream 19.2k (ref src/devices/gridstream.c)."""
    return _gridstream_decode(bits, dev)


@decoder("gridstream384")
def gridstream384(bits, dev):
    """Landis+Gyr Gridstream 38.4k (ref src/devices/gridstream.c)."""
    return _gridstream_decode(bits, dev)

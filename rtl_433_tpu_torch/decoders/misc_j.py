"""Misc decoders batch J (reference files cited per function):
ELV EM 1000, ELV WS 2000, FS20/FHT.
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


def _ad_pop(bb, nbits, bit):
    """LSB-first field extraction (ref src/devices/elv.c:8)."""
    val = 0
    for i in range(nbits):
        byte_no = (bit + i) // 8
        bit_no = 7 - ((bit + i) % 8)
        if byte_no < len(bb) and (int(bb[byte_no]) & (1 << bit_no)):
            val |= 1 << i
    return val


@decoder("elv_em1000")
def elv_em1000(bits, dev):
    """ELV EM 1000 (ref src/devices/elv.c:24)."""
    if bits.num_rows < 3:
        return DECODE_ABORT_EARLY
    rows = [_ints(bits.bb[r]) + [0] * 14 for r in range(3)]
    bb_p = []
    for i in range(14):
        if rows[0][i] == rows[1][i] or rows[0][i] == rows[2][i]:
            bb_p.append(rows[0][i])
        elif rows[1][i] == rows[2][i]:
            bb_p.append(rows[1][i])
        else:
            return DECODE_ABORT_EARLY
    bit = 18
    dec = []
    checksum_calculated = 0
    for _ in range(9):
        dec.append(_ad_pop(bb_p, 8, bit))
        bit += 8
        stopbit = _ad_pop(bb_p, 1, bit)
        bit += 1
        if not stopbit:
            return DECODE_ABORT_EARLY
        checksum_calculated ^= dec[-1]
    if _ad_pop(bb_p, 8, bit) != checksum_calculated:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "ELV-EM1000"),
        ("id", dec[1], ""),
        ("seq", dec[2], ""),
        ("total", dec[3] | (dec[4] << 8), ""),
        ("current", dec[5] | (dec[6] << 8), ""),
        ("peak", dec[7] | (dec[8] << 8), ""),
    )]


_WS2000_TYPES = ["!AS3",
                 "AS2000/ASH2000/S2000/S2001A/S2001IA/ASH2200/S300IA",
                 "!S2000R", "!S2000W", "S2001I/S2001ID", "!S2500H",
                 "!Pyrano", "KS200/KS300"]
_WS2000_LENGTH = [5, 8, 5, 8, 12, 9, 8, 14, 8, 0, 0, 0, 0, 0, 0, 0]


@decoder("elv_ws2000")
def elv_ws2000(bits, dev):
    """ELV WS 2000 (ref src/devices/elv.c:104)."""
    bb = _ints(bits.bb[0]) + [0] * 16
    bit = 11
    dec = [0] * 16
    dec[0] = _ad_pop(bb, 4, bit)
    bit += 4
    if not _ad_pop(bb, 1, bit):
        return DECODE_ABORT_EARLY
    bit += 1
    check = dec[0]
    s = dec[0]
    for i in range(1, _WS2000_LENGTH[dec[0]] + 1):
        dec[i] = _ad_pop(bb, 4, bit)
        bit += 4
        if not _ad_pop(bb, 1, bit):
            return DECODE_ABORT_EARLY
        bit += 1
        check ^= dec[i]
        s += dec[i]
    if check:
        return DECODE_FAIL_MIC
    sum_received = _ad_pop(bb, 4, bit)
    if sum_received != ((s + 5) & 0xF):
        return DECODE_FAIL_MIC
    subtype = _WS2000_TYPES[dec[0]] if dec[0] <= 7 else "?"
    temp = ((-1.0 if (dec[1] & 8) else 1.0)
            * (dec[4] * 10 + dec[3] + dec[2] * 0.1))
    humidity = dec[7] * 10 + dec[6] + dec[5] * 0.1
    pressure = 0
    is_ksx00 = 0
    it_rains = 0
    wind = 0.0
    rainsum = 0
    unknown = 0
    if dec[0] == 4:
        pressure = 200 + dec[10] * 100 + dec[9] * 10 + dec[8]
    if dec[0] == 7:
        is_ksx00 = 1
        it_rains = 1 if (dec[1] & 2) else 0
        humidity = float(dec[6] * 10 + dec[5])
        wind = dec[9] * 10 + dec[8] + dec[7] * 0.1
        rainsum = (dec[12] << 8) + (dec[11] << 4) + dec[10]
        unknown = dec[13]
    return [Event.make(
        ("model", "ELV-WS2000"),
        ("subtype", subtype, ""),
        ("id", dec[1] & 7, ""),
        ("temperature_C", temp, "", "%.1f C"),
        ("humidity", humidity, "", "%.1f %%"),
        ("pressure_hPa", pressure, "", "%d hPa") if pressure else None,
        ("wind_avg_km_h", wind, "", "%.1f km/h") if is_ksx00 else None,
        ("rain_count", rainsum, "", "%d") if is_ksx00 else None,
        ("rain_mm", rainsum * 0.295, "", "%.1f mm") if is_ksx00 else None,
        ("is_raining", it_rains, "", "%d") if is_ksx00 else None,
        ("unknown", unknown, "", "%d") if is_ksx00 else None,
    )]


_FS20_CMD = ["off", "on, 6.25%", "on, 12.5%", "on, 18.75%", "on, 25%",
             "on, 31.25%", "on, 37.5%", "on, 43.75%", "on, 50%",
             "on, 56.25%", "on, 62.5%", "on, 68.75%", "on, 75%",
             "on, 81.25%", "on, 87.5%", "on, 93.75%", "on, 100%",
             "on, last value", "toggle on/off", "dim up", "dim down",
             "dim up/down", "set timer", "status request", "off, timer",
             "on, timer", "last value, timer", "reset to default",
             "unused", "unused", "unused", "unused"]
_FS20_FLAGS = ["(none)", "Extended", "BiDir", "Extended | BiDir",
               "Response", "Response | Extended", "Response | BiDir",
               "Response | Extended | BiDir"]
_FHT_CMD = ["end-of-sync", "valve open", "valve close", "? (0x3)",
            "? (0x4)", "? (0x5)", "valve open <ext>%", "? (0x7)",
            "offset adjust", "? (0x9)", "valve de-scale", "? (0x11)",
            "sync countdown", "? (0x13)", "beep", "pairing?"]
_FHT_FLAGS = ["(none)", "Extended", "BS?", "Extended | BS?", "Repeat",
              "Repeat | Extended", "Repeat | BS?",
              "Repeat | Extended | BS?"]


def _fs20_find_preamble(bits, bitpos):
    """Preamble scan (ref src/devices/fs20.c:41)."""
    row_bits = bits.bits_per_row[0]
    b = _ints(bits.row_bytes(0)) + [0, 0]
    while (bitpos + 12 + 45 <= row_bits
           and (b[(bitpos // 8) + 1] == 0 or b[bitpos // 8] != 0)):
        bitpos += 8
    if bitpos:
        bitpos -= 1
        bitpos &= ~0x3
    bitpos = bits.search(0, bitpos, bytes([0x00, 0x10]), 12)
    if bitpos < row_bits:
        data_pos = bitpos + 12
        if data_pos + 45 > row_bits:
            return DECODE_ABORT_LENGTH
        return data_pos
    return DECODE_FAIL_SANITY


def _fs20_get_byte(b, pos):
    """9-bit parity byte (ref src/devices/fs20.c:77). Returns (data, err)."""
    word = ((b[pos // 8] << 8) | b[(pos // 8) + 1]) & 0xFFFF
    word = (word << (pos & 7)) & 0xFFFF
    data = word >> 8
    err = util.parity8(data) != ((word >> 7) & 1)
    return data, err


@decoder("fs20")
def fs20(bits, dev):
    """FS20 / FHT remote (ref src/devices/fs20.c)."""
    bits.invert()
    b = _ints(bits.row_bytes(0)) + [0, 0]
    ext = 0
    rc = DECODE_FAIL_MIC
    bitpos = 0
    hc = address = cmd = s = 0
    while True:
        bitpos = _fs20_find_preamble(bits, bitpos)
        if bitpos < 0:
            break
        ext = 0
        if bitpos + 45 > bits.bits_per_row[0]:
            rc = DECODE_ABORT_LENGTH
            break
        data, err = _fs20_get_byte(b, bitpos)
        if err:
            continue
        hc = data << 8
        data, err = _fs20_get_byte(b, bitpos + 9)
        if err:
            continue
        hc |= data
        address, err = _fs20_get_byte(b, bitpos + 18)
        if err:
            continue
        cmd, err = _fs20_get_byte(b, bitpos + 27)
        if err:
            continue
        data, err = _fs20_get_byte(b, bitpos + 36)
        if err:
            continue
        if cmd & 0x20:
            ext = data
            if bitpos + 54 > bits.bits_per_row[0]:
                rc = DECODE_ABORT_LENGTH
                break
            data, err = _fs20_get_byte(b, bitpos + 45)
            if err:
                continue
        s = data
        rc = 1
        break
    if rc <= 0:
        return rc
    if bitpos < 0:
        return bitpos
    s = (s - (hc >> 8) - (hc & 0xFF) - address - cmd - ext) & 0xFF
    is_fs20 = 6 <= s <= 8
    is_fht = 0xC <= s <= 0xE
    if not is_fs20 and not is_fht:
        return DECODE_FAIL_SANITY
    if is_fht and (cmd & 0x0F) == 0x00 and not (cmd & 0x20):
        return DECODE_FAIL_SANITY
    if is_fs20 and (cmd & 0x1F) >= 0x1C:
        return DECODE_FAIL_SANITY
    if hc == 0 and address == 0:
        return DECODE_FAIL_SANITY
    ad_b4 = 0
    a = address
    for i in range(4):
        ad_b4 += (a % 4 + 1) << (i * 4)
        a //= 4
    hc_b4 = 0
    h = hc
    for i in range(8):
        hc_b4 += ((h % 4) + 1) << (i * 4)
        h //= 4
    return [Event.make(
        ("model", "FS20" if is_fs20 else "FHT", ""),
        ("housecode", hc_b4, "", "%x"),
        ("address", ad_b4, "", "%x"),
        ("command", _FS20_CMD[cmd & 0x1F] if is_fs20
         else _FHT_CMD[cmd & 0xF], ""),
        ("flags", _FS20_FLAGS[cmd >> 5] if is_fs20
         else _FHT_FLAGS[cmd >> 5], ""),
        ("ext", ext, "", "%x"),
        ("mic", "PARITY", "Integrity"),
    )]

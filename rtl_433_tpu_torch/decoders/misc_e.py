"""Misc decoders batch E (reference files cited per function):
Kidde smoke alarm, EN2058 4-probe thermometer, TFA 30.390x series,
TFA 30.3307 wind sensor.
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


@decoder("kidde_smoke")
def kidde_smoke(bits, dev):
    """Kidde RF-SM-DC smoke alarm (ref src/devices/kidde_smoke.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 50:
        return DECODE_ABORT_LENGTH
    row_len = bits.bits_per_row[0]
    start = 0
    while start < row_len:
        decoded = BitBuffer()
        nxt = bits.differential_manchester_decode(0, start, decoded, 0)
        length = decoded.bits_per_row[0]
        start = nxt if nxt > start else start + 1
        if length < 25:
            continue
        b = decoded.bb[0]
        search_start = 9
        while search_start + 16 <= length:
            pos = decoded.search(0, search_start, bytes([0x7F]), 8)
            if pos + 16 > length:
                break
            search_start = pos + 1
            if pos < 9:
                continue
            if util.bit_at(b, pos - 9) != 0:
                continue
            id_refl = 0
            for i in range(8):
                id_refl = (id_refl << 1) | util.bit_at(b, pos - 8 + i)
            id2_refl = 0
            for i in range(8):
                id2_refl = (id2_refl << 1) | util.bit_at(b, pos + 8 + i)
            if id2_refl != (id_refl ^ 0x80):
                continue
            return [Event.make(
                ("model", "Kidde-Smoke"),
                ("id", util.reverse8(id_refl), "", "%02x"),
            )]
    return DECODE_FAIL_SANITY


@decoder("en2058")
def en2058(bits, dev):
    """EN2058 four-probe thermometer (ref src/devices/en2058.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 174:
        return DECODE_ABORT_LENGTH
    offset = 0
    for _ in range(9):
        offset = bits.search(0, offset, bytes([0xFF, 0xFE, 0, 0]), 30)
        if offset >= bits.bits_per_row[0]:
            return DECODE_ABORT_EARLY
        offset += 30
        id_bytes = _ints(bits.extract_bytes(0, offset + 56, 24))
        data_bytes = _ints(bits.extract_bytes(0, offset + 80, 80))
        checksum = (0x56 + util.add_bytes(bytes(id_bytes))
                    + util.add_bytes(bytes(data_bytes[:8]))) & 0xFF
        if checksum != data_bytes[9]:
            continue
        temps = [((data_bytes[k * 2] << 8 | data_bytes[k * 2 + 1]) - 900)
                 / 10.0 for k in range(4)]
        has_sequence = offset + 320 <= bits.bits_per_row[0]
        sequence = 0
        if has_sequence:
            sequence = int(bits.extract_bytes(0, offset + 304, 16)[0])
        return [Event.make(
            ("model", "EN2058"),
            ("id", (id_bytes[0] << 16) | (id_bytes[1] << 8) | id_bytes[2],
             ""),
            ("temperature1_F", temps[0], "Temperature 1", "%.1f F"),
            ("temperature2_F", temps[1], "Temperature 2", "%.1f F"),
            ("temperature3_F", temps[2], "Temperature 3", "%.1f F"),
            ("temperature4_F", temps[3], "Temperature 4", "%.1f F"),
            ("sequence", sequence, "Sequence") if has_sequence else None,
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return DECODE_ABORT_EARLY


def _crc32_reflected(msg):
    crc = 0xFFFFFFFF
    for byte in msg:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0xEDB88320 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _s_bits(v, nbits):
    return ((v & ((1 << nbits) - 1)) ^ (1 << (nbits - 1))) - (
        1 << (nbits - 1))


@decoder("tfa_30_390x")
def tfa_30_390x(bits, dev):
    """TFA Dostmann 30.390x series (ref src/devices/tfa_30_390x.c)."""
    sync = bytes([0x4B, 0x2D, 0xD4, 0x2B])
    bitpos = bits.search(0, 0, sync, 32)
    if bitpos + 32 + 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    length = int(bits.extract_bytes(0, bitpos + 32, 8)[0])
    if length not in (24, 30, 36):
        return DECODE_ABORT_LENGTH
    if bitpos + 32 + length * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bitpos, 32 + length * 8))
    crc_calc = _crc32_reflected(bytes(b[4:length]))
    crc_frame = ((b[length + 3] << 24) | (b[length + 2] << 16)
                 | (b[length + 1] << 8) | b[length])
    if crc_calc != crc_frame:
        return DECODE_FAIL_MIC
    if not b[5] and not b[6] and not b[7] and not b[8]:
        return DECODE_FAIL_SANITY
    id_str = "%02X%02X%02X%02X" % (b[5], b[6], b[7], b[8])
    battery_ok = int(not (b[9] & 0x08))
    manual_transmit = (b[9] & 0x02) >> 1
    seq_number = b[10] | (b[11] << 8)
    head = [
        ("id", id_str, ""),
        ("battery_ok", battery_ok, "Battery OK"),
        ("manual_transmit", manual_transmit, "Manual Transmit"),
        ("seq_number", seq_number, "Sequence Number"),
    ]
    if b[5] in (0xA0, 0xA6):
        if length != 30:
            return DECODE_FAIL_SANITY
        temp_c = [_s_bits((b[12 + k * 6] | (b[13 + k * 6] << 8)), 11) * 0.1
                  for k in range(3)]
        hum = [(b[14 + k * 6] | (b[15 + k * 6] << 8)) * 0.1
               for k in range(3)]
        return [Event.make(
            ("model", "TFA-303908" if b[5] == 0xA0 else "TFA-303906", ""),
            *head,
            ("temperature_C", temp_c[0], "Temperature", "%.1f C"),
            ("temperature_C_last", temp_c, "Temp. last"),
            ("humidity", hum[0], "Humidity", "%.1f %%"),
            ("humidity_last", hum, "Humidity last"),
            ("mic", "CRC", "Integrity"),
        )]
    if b[5] == 0xA3:
        if length != 30:
            return DECODE_FAIL_SANITY
        temp_c = [_s_bits((b[12 + k * 6] | (b[13 + k * 6] << 8)), 11) * 0.1
                  for k in range(3)]
        ext_c = [_s_bits((b[14 + k * 6] | (b[15 + k * 6] << 8)), 11) * 0.1
                 for k in range(3)]
        return [Event.make(
            ("model", "TFA-303902", ""),
            *head,
            ("temperature_C", temp_c[0], "Temperature", "%.1f C"),
            ("temperature_C_last", temp_c, "Temp. last"),
            ("temperature_C_ext", ext_c[0], "Temperature ext.", "%.1f C"),
            ("temperature_C_ext_last", ext_c, "Temp. ext. last"),
            ("mic", "CRC", "Integrity"),
        )]
    if b[5] == 0xA4:
        if length != 36:
            return DECODE_FAIL_SANITY
        temp_c = [_s_bits((b[12 + k * 8] | (b[13 + k * 8] << 8)), 12) * 0.1
                  for k in range(3)]
        hum = [(b[14 + k * 8] | (b[15 + k * 8] << 8)) * 0.1
               for k in range(3)]
        ext_c = [_s_bits((b[16 + k * 8] | (b[17 + k * 8] << 8)), 12) * 0.1
                 for k in range(3)]
        return [Event.make(
            ("model", "TFA-303905", ""),
            *head,
            ("temperature_C", temp_c[0], "Temperature", "%.1f C"),
            ("temperature_C_last", temp_c, "Temp. last"),
            ("humidity", hum[0], "Humidity", "%.1f %%"),
            ("humidity_last", hum, "Humidity last"),
            ("temperature_C_ext", ext_c[0], "Temperature ext.", "%.1f C"),
            ("temperature_C_ext_last", ext_c, "Temp. ext. last"),
            ("mic", "CRC", "Integrity"),
        )]
    if b[5] == 0xA5:
        if length != 24:
            return DECODE_FAIL_SANITY
        temp_c = [_s_bits((b[12 + k * 4] | (b[13 + k * 4] << 8)), 11) * 0.1
                  for k in range(3)]
        return [Event.make(
            ("model", "TFA-303901", ""),
            *head,
            ("temperature_C", temp_c[0], "Temperature", "%.1f C"),
            ("temperature_C_last", temp_c, "Temp. last"),
            ("mic", "CRC", "Integrity"),
        )]
    return DECODE_FAIL_SANITY


@decoder("tfa_30_3307")
def tfa_30_3307(bits, dev):
    """TFA 30.3307.02 WeatherHub wind sensor
    (ref src/devices/tfa_30_3307.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    length = bits.bits_per_row[0]
    b = bits.bb[0]
    last_bit = 0
    psk = 0
    last_psk = 0
    nrzs = 0
    lfsr = 0
    sr = 0
    sr_cnt = -1
    rdata = [0] * 48
    byte_cnt = 0
    for i in range(length):
        if byte_cnt >= 48:
            break
        bit = util.bit_at(b, i)
        if bit == last_bit:
            psk = 1 - psk
        if psk == last_psk:
            nrzs = 1 - nrzs
        last_bit = bit
        last_psk = psk
        descrambled = nrzs ^ ((lfsr >> 16) & 1) ^ ((lfsr >> 11) & 1)
        lfsr = ((lfsr << 1) | nrzs) & 0xFFFFFFFF
        sr = ((sr >> 1) | (descrambled << 31)) & 0xFFFFFFFF
        if sr == 0x2BD42D4B:
            sr_cnt = 0
            rdata[0] = sr & 0xFF
            rdata[1] = (sr >> 8) & 0xFF
            rdata[2] = (sr >> 16) & 0xFF
            byte_cnt = 3
        if sr_cnt == 0:
            rdata[byte_cnt] = (sr >> 24) & 0xFF
            byte_cnt += 1
        if sr_cnt >= 0:
            sr_cnt = (sr_cnt + 1) & 7
    if byte_cnt < 12:
        return DECODE_ABORT_LENGTH
    plen = rdata[4]
    if plen < 11 or plen + 4 > byte_cnt:
        return DECODE_ABORT_LENGTH
    if rdata[5] != 0x0B:
        return DECODE_ABORT_EARLY
    crc_calc = 0xE7720AE4
    for i in range(4, plen):
        crc_calc ^= rdata[i] << 24
        for _ in range(8):
            crc_calc = ((crc_calc << 1) ^ 0x04C11DB7 if
                        crc_calc & 0x80000000 else crc_calc << 1) \
                & 0xFFFFFFFF
    crc_msg = ((rdata[plen] << 24) | (rdata[plen + 1] << 16)
               | (rdata[plen + 2] << 8) | rdata[plen + 3])
    if crc_calc != crc_msg:
        return DECODE_FAIL_MIC
    rid = 0
    for i in range(6):
        rid = (rid << 8) | rdata[5 + i]
    msg = rdata[11:]
    if plen - 11 < 7:
        return DECODE_FAIL_SANITY
    v = (msg[3] << 24) | (msg[4] << 16) | (msg[5] << 8) | msg[6]
    return [Event.make(
        ("model", "TFA-303307"),
        ("id", "%06x%06x" % (rid >> 24, rid & 0xFFFFFF), ""),
        ("wind_dir_deg", 22.5 * (v >> 28), "Wind Direction", "%.1f"),
        ("wind_avg_m_s",
         (((v >> 16) & 0xFF) + 256 * ((v >> 25) & 1)) / 10.0,
         "Wind Speed", "%.1f m/s"),
        ("wind_max_m_s",
         (((v >> 8) & 0xFF) + 256 * ((v >> 24) & 1)) / 10.0, "Wind Gust",
         "%.1f m/s"),
        ("mic", "CRC", "Integrity"),
    )]

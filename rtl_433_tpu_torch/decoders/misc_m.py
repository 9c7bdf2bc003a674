"""Misc decoders batch M (reference files cited per function):
Watts Vision thermostat, Voltcraft EnergyCount 3000.
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


_WV_SETPOINT_MODE = {0x00: "Comfort", 0x01: "Off", 0x02: "Anti-freeze",
                     0x03: "Reduced/ECO", 0x04: "Boost/Timer",
                     0x08: "Auto (Comfort phase)",
                     0x0B: "Auto (Reduced phase)",
                     0x10: "Manual/Temporary"}
_WV_SENSOR_MODE = {0: "Amb", 1: "FLR", 2: "FLL", 3: "Air"}


@decoder("watts_vision")
def watts_vision(bits, dev):
    """Watts Vision thermostat (ref src/devices/watts_vision.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    row_len = bits.bits_per_row[0]
    bitpos = bits.search(0, 0, bytes([0xAA, 0xD3, 0x91, 0xD3, 0x91]), 40)
    if bitpos >= row_len:
        return DECODE_ABORT_EARLY
    bitpos += 40
    if bitpos + 8 > row_len:
        return DECODE_ABORT_LENGTH
    length = int(bits.extract_bytes(0, bitpos, 8)[0])
    if length not in (0x14, 0x22):
        return DECODE_ABORT_EARLY
    total_bits = (length + 3) * 8
    if bitpos + total_bits > row_len:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bitpos, total_bits)) + [0] * 3
    crc_mdb_calc = util.crc16lsb(bytes(b[1:length - 1]), length - 2,
                                 0xA001, 0xFFFF)
    if crc_mdb_calc != ((b[length] << 8) | b[length - 1]):
        return DECODE_FAIL_MIC
    crc_cms_calc = util.crc16(bytes(b[:length + 1]), length + 1, 0x8005,
                              0xFFFF)
    if crc_cms_calc != ((b[length + 1] << 8) | b[length + 2]):
        return DECODE_FAIL_MIC
    if b[5] != 0xC6:
        return DECODE_FAIL_SANITY
    items = [
        ("model", "Watts-Vision"),
        ("id", "%08x" % ((b[1] << 24) | (b[2] << 16) | (b[3] << 8)
                         | b[4]), ""),
        ("dest", "%08x" % ((b[6] << 24) | (b[7] << 16) | (b[8] << 8)
                           | b[9]), ""),
        ("msg_type", "command" if length == 0x14 else "status", ""),
    ]
    records_len = length - 11
    pos = 0
    while pos < records_len:
        tag = b[10 + pos]
        if tag == 0x00:
            break
        value_len = (tag >> 6) + 1
        if pos + 1 + value_len > records_len:
            break
        val = b[10 + pos + 1:10 + pos + 1 + value_len]
        if tag == 0x03:
            items.append(("association_id", val[0], ""))
        elif tag == 0xDF:
            items.append(("state_raw", "%02x%02x%02x%02x" % tuple(val),
                          ""))
        elif tag == 0x3B:
            items.append(("flags_raw", val[0], "", "%02x"))
        elif tag == 0x8D:
            items.append(("report_flags_0", val[0], "", "%02x"))
            items.append(("report_flags_1", val[1], "", "%02x"))
            items.append(("report_flags_2", val[2], "", "%02x"))
        elif tag == 0x8A:
            raw = (val[0] << 8) | val[1]
            if raw != 0x084C:
                items.append(("mode_setpoint_F", raw / 10.0, "", "%.1f"))
            items.append(("setpoint_mode",
                          _WV_SETPOINT_MODE.get(val[2], "unknown"), ""))
        elif tag == 0x4B:
            raw = (val[0] << 8) | val[1]
            if raw != 0x084C:
                items.append(("temperature_F", raw / 10.0, "", "%.1f"))
        elif tag == 0x5E:
            raw = (val[0] << 8) | val[1]
            if raw != 0x084C:
                items.append(("temperature_2_F", raw / 10.0, "", "%.1f"))
        elif tag == 0xCC:
            raw1 = (val[0] << 8) | val[1]
            raw2 = (val[2] << 8) | val[3]
            if raw1 != 0:
                items.append(("floor_limit_1_F", raw1 / 10.0, "", "%.1f"))
            if raw2 != 0:
                items.append(("floor_limit_2_F", raw2 / 10.0, "", "%.1f"))
        elif tag == 0x8E:
            items.append(("setpoint_min_C", val[0], ""))
            items.append(("setpoint_max_C", val[1], ""))
            items.append(("sensor_mode",
                          _WV_SENSOR_MODE[val[2] & 0x3], ""))
            items.append(("sensor_flags_raw", val[2], "", "%02x"))
        elif tag == 0x4C:
            items.append(("diagnostic_code", val[0], "", "%02x"))
            items.append(("diagnostic_flags", val[1], "", "%02x"))
        pos += 1 + value_len
    items.append(("mic", "CRC", ""))
    return [Event.make(*items)]


def _ec3k_unpack(buf, start, num):
    val = 0
    for i in range(num):
        val = (val << 4) | ((buf[(start + i) // 2]
                             >> ((1 - ((start + i) & 1)) * 4)) & 0x0F)
    return val


@decoder("ec3k")
def ec3k(bits, dev):
    """Voltcraft EnergyCount 3000 (ref src/devices/ec3k.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 90:
        return DECODE_ABORT_LENGTH
    # row_bytes follows spill continuation rows: rows longer than 1024 bits
    # (ref bitbuffer row spilling) would overrun a plain bb[0] slice
    row = _ints(bits.row_bytes(0))

    def bit_at(bit):
        return (row[bit >> 3] >> (7 - (bit & 7))) & 1

    def symbol_at(bit):
        bit0 = bit_at(bit - 1) if bit > 0 else 0
        return 1 if bit0 == bit_at(bit) else 0

    nbits = bits.bits_per_row[0]
    syms = [symbol_at(i) for i in range(nbits)]
    rc = DECODE_ABORT_EARLY
    packetbuffer = [0] * 41
    packetpos = 0
    in_packet = 0
    onecount = 0
    recbyte = 0
    recpos = 0
    for bufferpos in range(17, nbits):
        out = syms[bufferpos]
        if bufferpos > 17:
            out ^= syms[bufferpos - 17]
        if bufferpos > 12:
            out ^= syms[bufferpos - 12]
        if out:
            if onecount < 6 and packetpos < 41:
                onecount += 1
                recbyte = (recbyte >> 1) | 0x80
                recpos += 1
                if recpos == 8 and in_packet:
                    recpos = 0
                    packetbuffer[packetpos] = recbyte
                    packetpos += 1
            else:
                packetpos = in_packet = onecount = recbyte = recpos = 0
        else:
            if onecount < 5 and packetpos < 41:
                recbyte = recbyte >> 1
                recpos += 1
                if recpos == 8 and in_packet:
                    recpos = 0
                    packetbuffer[packetpos] = recbyte
                    packetpos += 1
            elif onecount == 5:
                pass  # bit unstuffing
            elif onecount == 6:
                in_packet = 1 - in_packet
                packetpos = 0
                recpos = 0
            else:
                packetpos = in_packet = onecount = recbyte = recpos = 0
                onecount = 0
                continue
            onecount = 0
        if packetpos >= 41:
            rc = _ec3k_fields(packetbuffer)
            if isinstance(rc, list):
                return rc
            packetpos = in_packet = onecount = recbyte = recpos = 0
    return rc


def _ec3k_fields(pb):
    """Field extraction (ref src/devices/ec3k.c:223)."""
    eid = _ec3k_unpack(pb, 1, 4)
    time_total_low = _ec3k_unpack(pb, 5, 4)
    pad_1 = _ec3k_unpack(pb, 9, 4)
    time_on_low = _ec3k_unpack(pb, 13, 4)
    pad_2 = _ec3k_unpack(pb, 17, 7)
    energy_low = _ec3k_unpack(pb, 24, 7)
    power_current = _ec3k_unpack(pb, 31, 4) / 10.0
    power_max = _ec3k_unpack(pb, 35, 4) / 10.0
    energy2 = _ec3k_unpack(pb, 39, 6)
    time_total_high = _ec3k_unpack(pb, 59, 3)
    pad_3 = _ec3k_unpack(pb, 62, 5)
    energy_high = _ec3k_unpack(pb, 67, 4) << 28
    time_on_high = _ec3k_unpack(pb, 71, 3)
    reset_counter = _ec3k_unpack(pb, 74, 2)
    flags = _ec3k_unpack(pb, 76, 1)
    pad_4 = _ec3k_unpack(pb, 77, 1)
    received_crc = 0xFFFF ^ (_ec3k_unpack(pb, 78, 2)
                             | (_ec3k_unpack(pb, 80, 2) << 8))
    calculated_crc = util.crc16lsb(bytes(pb[:39]), 39, 0x8408, 0xFFFF)
    if pad_1 or pad_2 or pad_3 or pad_4:
        return DECODE_FAIL_SANITY
    if calculated_crc != received_crc:
        return DECODE_FAIL_MIC
    energy_ws = energy_high | energy_low
    return [Event.make(
        ("model", "Voltcraft-EC3k"),
        ("id", eid, "", "%04x"),
        ("power", power_current, "Power"),
        ("energy", energy_ws / (1000.0 * 3600.0), "Energy"),
        ("energy2", energy2 / (1000.0 * 3600.0), "Energy 2"),
        ("time_total",
         time_total_low | (time_total_high << 16), "Time total"),
        ("time_on", time_on_low | (time_on_high << 16), "Time on"),
        ("power_max", power_max, "Power max"),
        ("reset_counter", reset_counter, "Reset counter"),
        ("flags", flags, "Flags"),
        ("mic", "CRC", "Integrity"),
    )]

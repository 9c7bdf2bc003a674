"""Wireless M-Bus EN 13757-4 (ref src/devices/m_bus.c).

Implements the physical and data-link layers for modes C&T (uplink and
downlink), S, R, F plus the RADIAN/RADIAN0 meter transport, and the
application-layer record parser (DIF/VIF data records, ELL/AFL headers,
KNX-RF and QDS walk-by vendor formats).
"""

from __future__ import annotations

from dataclasses import dataclass, field

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

BLOCK1A_SIZE = 12
BLOCK1B_SIZE = 10
BLOCK2B_SIZE = 118


def _bcd2int(bcd):
    return 10 * (bcd >> 4) + (bcd & 0xF)


_3OF6 = {22: 0x0, 13: 0x1, 14: 0x2, 11: 0x3, 28: 0x4, 25: 0x5, 26: 0x6,
         19: 0x7, 44: 0x8, 37: 0x9, 38: 0xA, 35: 0xB, 52: 0xC, 49: 0xD,
         50: 0xE, 41: 0xF}


def _bitrow_get_byte(row, pos):
    """8 bits at arbitrary bit position from a byte row (zero padded)."""
    out = 0
    for i in range(8):
        p = pos + i
        byte = int(row[p >> 3]) if (p >> 3) < len(row) else 0
        out = (out << 1) | ((byte >> (7 - (p & 7))) & 1)
    return out


def _decode_3of6_buffer(row, bit_offset, num_bytes):
    """3of6 decode (ref src/devices/m_bus.c:61)."""
    output = bytearray(num_bytes)
    ok = -1
    for n in range(num_bytes):
        nh = _3OF6.get(_bitrow_get_byte(row, n * 12 + bit_offset) >> 2,
                       0xF0)
        nl = _3OF6.get(_bitrow_get_byte(row, n * 12 + bit_offset + 6) >> 2,
                       0xF0)
        if nh > 0xF or nl > 0xF:
            nl &= 0x0F
            if ok < 0:
                ok = n
        output[n] = ((nh << 4) | nl) & 0xFF
    if ok < 0:
        ok = num_bytes
    return output, ok


def _crc_valid(b, crc_offset):
    if crc_offset + 2 > len(b):
        return False
    crc_calc = (~util.crc16(bytes(b[:crc_offset]), crc_offset, 0x3D65, 0)
                & 0xFFFF)
    crc_read = (b[crc_offset] << 8) | b[crc_offset + 1]
    return crc_calc == crc_read


def _manuf_decode(m_field):
    return ("%c%c%c" % (((m_field >> 10) & 0x1F) + 0x40,
                        ((m_field >> 5) & 0x1F) + 0x40,
                        (m_field & 0x1F) + 0x40))


_DEVICE_TYPES = {
    0x00: "Other", 0x01: "Oil", 0x02: "Electricity", 0x03: "Gas",
    0x04: "Heat", 0x05: "Steam", 0x06: "Warm Water", 0x07: "Water",
    0x08: "Heat Cost Allocator", 0x09: "Compressed Air",
    0x0A: "Cooling load meter", 0x0B: "Cooling load meter", 0x0C: "Heat",
    0x0D: "Heat/Cooling load meter", 0x0E: "Bus/System component",
    0x0F: "Unknown", 0x15: "Hot Water", 0x16: "Cold Water",
    0x17: "Hot/Cold Water meter", 0x18: "Pressure", 0x19: "A/D Converter",
    0x1A: "Smoke detector", 0x1B: "Room sensor", 0x1C: "Gas detector",
    0x20: "Breaker (electricity)", 0x21: "Valve (gas or water)",
    0x28: "Waste water meter", 0x29: "Garbage", 0x2A: "Carbon dioxide",
    0x25: "Customer unit (display device)",
    0x31: "Communication controller", 0x32: "Unidirectional repeater",
    0x33: "Bidirectional repeater",
    0x36: "Radio converter (system side)",
    0x37: "Radio converter (meter side)",
}


@dataclass
class _Block2:
    CI: int = 0
    AC: int = 0
    ST: int = 0
    CW: int = 0
    pl_offset: int = 0
    ell_ci: int = 0
    ell_cc: int = 0
    ell_acc: int = 0
    ell_sec_mode: int = 0
    knx_ctrl: int = 0
    src: int = 0
    dst: int = 0
    l_npci: int = 0
    tpci: int = 0
    apci: int = 0
    qds_walk_by: int = 0


@dataclass
class _Block1:
    L: int = 0
    C: int = 0
    M_str: str = ""
    A_ID: int = 0
    A_Version: int = 0
    A_DevType: int = 0
    block2: _Block2 = field(default_factory=_Block2)
    knx_mode: int = 0
    knx_sn: bytes = b""


_HUMIDITY_FACTOR = [0.1, 1.0]

_OMS_HUM = [
    ["humidity", "average_humidity_1h", "average_humidity_24h", "error_04"],
    ["maximum_humidity_1h", "maximum_humidity_24h", "error_13", "error_14"],
    ["minimum_humidity_1h", "minimum_humidity_24h", "error_23", "error_24"],
    ["error_31", "error_32", "error_33", "error_34"],
]
_OMS_HUM_EL = [
    ["Humidity", "Average Humidity 1h", "Average Humidity 24h",
     "Error [0][4]"],
    ["Maximum Humidity 1h", "Maximum Humidity 24h", "Error [1][3]",
     "Error [1][4]"],
    ["Minimum Humidity 1h", "Minimum Humidity 24h", "Error [2][3]",
     "Error [2][4]"],
    ["Error 31", "Error 32", "Error 33", "Error 34"],
]
_HISTORY_HOURS = ["1h", "24h", "err[2]", "err[3]"]
_HISTORY_MONTHS = [("m%d" % i, "of month -%d" % i) for i in range(1, 13)]
_VALUE_TYPES = [("inst", ""), ("max", "Max"), ("min", "Min"),
                ("err", "Err")]

# unit-type table indices (ref src/devices/m_bus.c:233)
(kEnergy_Wh, kEnergy_J, kVolume, kMass, kPower_W, kPower_Jh, kVolumeFlow_h,
 kVolumeFlow_min, kVolumeFlow_s, kMassFlow, kTemperatureFlow,
 kTemperatureReturn, kTemperatureDiff, kTemperatureExtern, kPressure,
 kTimeDate, kDate, kHca, kOnTimeSec, kOnTimeMin, kOnTimeHours, kOnTimeDays,
 kOperTimeSec, kOperTimeMin, kOperTimeHours, kOperTimeDays) = range(26)

_UNIT_NAMES = [
    ("energy_wh", "Energy", "Wh"), ("energy_j", "Energy", "J"),
    ("volume", "Volume", "m3"), ("mass", "Mass", "kg"),
    ("power_w", "Power", "W"), ("power_jh", "Power", "J/h"),
    ("volume_flow_h", "Volume flow", "m3/h"),
    ("volume_flow_min", "Volume flow", "m3/min"),
    ("volume_flow_s", "Volume flow", "l/s"),
    ("mass_flow", "Mass flow", "kg/h"),
    ("temperature_flow", "Flow temperature", "C"),
    ("temperature_return", "Return temperature", "C"),
    ("temperature_diff", "Temperature diff", "K"),
    ("temperature_ext", "Temperature extern", "C"),
    ("pressure", "Pressure", "bar"), ("timedate", "TimeDate", ""),
    ("date", "Date", ""), ("hca", "HCA", ""), ("ontime_s", "OnTime", "s"),
    ("ontime_m", "OnTime", "min"), ("ontime_h", "OnTime", "hours"),
    ("ontime_d", "OnTime", "days"), ("opertime_s", "OperTime", "s"),
    ("opertime_m", "OperTime", "min"), ("opertime_h", "OperTime", "hours"),
    ("opertime_d", "OperTime", "days"),
]

_POW10 = [0.001, 0.01, 0.1, 1, 10, 100, 1000, 10000]


def _append_str(items, unit_type, value_type, sn, key_extra, pretty_extra,
                value):
    value_type &= 0x3
    if not key_extra:
        key = "%s_%s_%d" % (_VALUE_TYPES[value_type][0],
                            _UNIT_NAMES[unit_type][0], sn)
    else:
        key = "%s_%s_%s_%d" % (_VALUE_TYPES[value_type][0],
                               _UNIT_NAMES[unit_type][0], key_extra, sn)
    if not pretty_extra:
        pretty = "%s %s[%d]" % (_VALUE_TYPES[value_type][1],
                                _UNIT_NAMES[unit_type][1], sn)
    else:
        pretty = "%s %s %s" % (_VALUE_TYPES[value_type][1],
                               _UNIT_NAMES[unit_type][1], pretty_extra)
    items.append((key, value, pretty))


def _append_val(items, unit_type, value_type, sn, key_extra, pretty_extra,
                val, exp):
    prefix = ""
    if exp < -6:
        exp += 6
        prefix = "u"
    elif exp < -3:
        exp += 3
        prefix = "m"
    elif exp <= 0:
        prefix = ""
    elif exp <= 3:
        exp -= 3
        prefix = "k"
    elif exp <= 6:
        exp -= 6
        prefix = "M"
    elif exp <= 9:
        exp -= 9
        prefix = "G"
    exp += 3
    if exp < 0 or exp > 7:
        return
    fvalue = val * _POW10[exp]
    _append_str(items, unit_type, value_type, sn, key_extra, pretty_extra,
                "%.3f %s%s" % (fvalue, prefix, _UNIT_NAMES[unit_type][2]))


def _tm_decode(b, data_size):
    """CP48/CP32/CP16 date decode (ref src/devices/m_bus.c:358)."""
    if data_size == 6:
        if b[1] & 0x80:
            return "invalid"
        return "%02d-%02d-%02dT%02d:%02d:%02d" % (
            ((b[3] & 0xE0) >> 5) | ((b[4] & 0xF0) >> 1), b[4] & 0x0F,
            b[3] & 0x1F, b[2] & 0x1F, b[1] & 0x3F, b[0] & 0x3F)
    if data_size == 4:
        if b[0] & 0x80:
            return "invalid"
        return "%02d-%02d-%02dT%02d:%02d:00" % (
            ((b[2] & 0xE0) >> 5) | ((b[3] & 0xF0) >> 1), b[3] & 0x0F,
            b[2] & 0x1F, b[1] & 0x1F, b[0] & 0x3F)
    if data_size == 2:
        if (b[1] & 0x0F) > 12:
            return "invalid"
        return "%02d-%02d-%02d" % (
            ((b[0] & 0xE0) >> 5) | ((b[1] & 0xF0) >> 1), b[1] & 0x0F,
            b[0] & 0x1F)
    return "unknown"


def _s_int(val, bits):
    return ((val & ((1 << bits) - 1)) ^ (1 << (bits - 1))) - (
        1 << (bits - 1))


def _decode_val(b, dif_coding):
    """Value decode by DIF coding (ref src/devices/m_bus.c:423).
    Returns (consumed, value)."""
    val = 0
    if dif_coding == 15:
        return -1, 0
    if dif_coding == 14:
        for i in range(5, -1, -1):
            val = val * 10 + (b[i] >> 4)
            val = val * 10 + (b[i] & 0xF)
        return 6, val
    if dif_coding == 13:
        if b[0] <= 0xBF:
            return b[0] + 1, 0
        if b[0] <= 0xCF:
            return (b[0] - 0xC0) * 2, 0
        if b[0] <= 0xDF:
            return (b[0] - 0xD0) * 2, 0
        if b[0] <= 0xEF:
            return b[0] - 0xE0, 0
        if b[0] <= 0xFA:
            return b[0] - 0xF0, 0
        return -1, 0
    if dif_coding == 12:
        for i in range(3, -1, -1):
            val = val * 10 + (b[i] >> 4)
            val = val * 10 + (b[i] & 0xF)
        return 4, val
    if dif_coding == 11:
        for i in range(2, -1, -1):
            val = val * 10 + (b[i] >> 4)
            val = val * 10 + (b[i] & 0xF)
        return 3, val
    if dif_coding == 10:
        for i in range(1, -1, -1):
            val = val * 10 + (b[i] >> 4)
            val = val * 10 + (b[i] & 0xF)
        return 2, val
    if dif_coding == 9:
        return 1, (b[0] >> 4) * 10 + (b[0] & 0xF)
    if dif_coding == 8:
        return -1, 0
    if dif_coding == 7:
        for i in range(7, -1, -1):
            val = (val << 8) | b[i]
        return 8, _s_int(val, 64)
    if dif_coding == 6:
        if b[5] & 0x80:
            val = 0xFFFFFF
        for i in range(5, -1, -1):
            val = (val << 8) | b[i]
        return 6, _s_int(val, 64)
    if dif_coding == 5:
        import struct
        f = struct.unpack("<f", bytes(b[:4]))[0]
        # C llround: round half away from zero
        import math
        v = math.floor(f + 0.5) if f >= 0 else math.ceil(f - 0.5)
        return 4, int(v)
    if dif_coding == 4:
        return 4, _s_int((b[3] << 24) | (b[2] << 16) | (b[1] << 8) | b[0],
                         32)
    if dif_coding == 3:
        val = 0xFFFFFFFFFF if (b[2] & 0x80) else 0
        val = (val << 8) | b[2]
        val = (val << 8) | b[1]
        val = (val << 8) | b[0]
        return 3, _s_int(val, 64)
    if dif_coding == 2:
        return 2, _s_int((b[1] << 8) | b[0], 16)
    if dif_coding == 1:
        return 1, _s_int(b[0], 8)
    if dif_coding == 0:
        return 0, 0
    return -1, 0


def _decode_records(items, b, dif_coding, vif_linear, vif_uam,
                    vif_combinable, dif_sn, dif_ff, dif_su):
    """Decode one data record (ref src/devices/m_bus.c:553)."""
    consumed, val = _decode_val(b, dif_coding)
    if vif_linear == 0:
        u = vif_uam
        if (u & 0xF8) == 0:
            _append_val(items, kEnergy_Wh, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x7))
        elif (u & 0xF8) == 0x08:
            _append_val(items, kEnergy_J, dif_ff, dif_sn, "", "", val,
                        u & 0x7)
        elif (u & 0xF8) == 0x10:
            if dif_sn < 8:
                _append_val(items, kVolume, dif_ff, dif_sn, "", "", val,
                            -6 + (u & 0x7))
            elif dif_sn <= 19:
                sn = dif_sn - 8
                _append_val(items, kVolume, dif_ff, sn,
                            _HISTORY_MONTHS[sn][0], _HISTORY_MONTHS[sn][1],
                            val, -6 + (u & 0x7))
        elif (u & 0xF8) == 0x18:
            _append_val(items, kEnergy_J, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x7))
        elif (u & 0xFC) == 0x20:
            unit = [kOnTimeSec, kOnTimeMin, kOnTimeHours, kOnTimeDays][
                u & 3]
            _append_val(items, unit, dif_ff, dif_sn, "", "", val, 0)
        elif (u & 0xFC) == 0x24:
            unit = [kOperTimeSec, kOperTimeMin, kOperTimeHours,
                    kOperTimeDays][u & 3]
            _append_val(items, unit, dif_ff, dif_sn, "", "", val, 0)
        elif (u & 0xF8) == 0x28:
            _append_val(items, kPower_W, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x7))
        elif (u & 0xF8) == 0x30:
            _append_val(items, kPower_Jh, dif_ff, dif_sn, "", "", val,
                        u & 0x7)
        elif (u & 0xF8) == 0x38:
            _append_val(items, kVolumeFlow_h, dif_ff, dif_sn, "", "", val,
                        -6 + (u & 0x7))
        elif (u & 0xF8) == 0x40:
            _append_val(items, kVolumeFlow_min, dif_ff, dif_sn, "", "",
                        val, -7 + (u & 0x7))
        elif (u & 0xF8) == 0x48:
            _append_val(items, kVolumeFlow_s, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x7))
        elif (u & 0xF8) == 0x50:
            _append_val(items, kMassFlow, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x7))
        elif (u & 0xFC) == 0x58:
            _append_val(items, kTemperatureFlow, dif_ff, dif_sn, "", "",
                        val, -3 + (u & 0x3))
        elif (u & 0xFC) == 0x5C:
            _append_val(items, kTemperatureReturn, dif_ff, dif_sn, "", "",
                        val, -3 + (u & 0x3))
        elif (u & 0xFC) == 0x60:
            _append_val(items, kTemperatureDiff, dif_ff, dif_sn, "", "",
                        val, -3 + (u & 0x3))
        elif (u & 0xFC) == 0x64:
            _append_val(items, kTemperatureExtern, dif_ff, dif_sn, "",
                        _HISTORY_HOURS[dif_sn & 0x3], val, -3 + (u & 0x3))
        elif (u & 0xFC) == 0x68:
            _append_val(items, kPressure, dif_ff, dif_sn, "", "", val,
                        -3 + (u & 0x3))
        elif (u & 0xFE) == 0x6C:
            t = _tm_decode(b, dif_coding)
            if u & 1:
                if t:
                    if vif_combinable == 0x39:
                        _append_str(items, kTimeDate, dif_ff, dif_sn,
                                    "start", "Start", t)
                    else:
                        _append_str(items, kTimeDate, dif_ff, dif_sn, "",
                                    "", t)
            else:
                if t:
                    _append_str(items, kDate, dif_ff, dif_sn, "", "", t)
        elif u == 0x6E:
            _append_val(items, kHca, dif_ff, dif_sn, "", "", val, 0)
        elif (u & 0xFC) == 0x70 or (u & 0xFC) == 0x74 or u in (0x78, 0x79,
                                                               0x7A):
            pass
        else:
            items.append(("unknown", "none", "Unknown"))
    elif vif_linear == 0x7B:
        if (vif_uam >> 1) == 0xD:
            items.append((_OMS_HUM[dif_ff & 0x3][dif_sn & 0x3],
                          val * _HUMIDITY_FACTOR[vif_uam & 0x1],
                          _OMS_HUM_EL[dif_ff & 0x3][dif_sn & 0x3],
                          "%.1f %%"))
    elif vif_linear == 0x7D:
        if vif_uam == 0x0C:
            items.append(("model_version", val, "Model/Version"))
        elif vif_uam == 0x0D:
            items.append(("hardware_version", val, "Hardware Version"))
        elif vif_uam == 0x0E:
            items.append(("firmware_version", val, "Firmware Version"))
        elif vif_uam == 0x0F:
            items.append(("software_version", val, "Software Version"))
        elif vif_uam == 0x1B:
            state = b[0] & 0x44
            items.append(("switch", "open" if state == 0x44 else "closed",
                          "Switch"))
        elif vif_uam == 0x3A:
            items.append(("counter_0" if dif_su == 0 else "counter_1",
                          (b[3] << 24) | (b[2] << 16) | (b[1] << 8) | b[0],
                          "Counter 0" if dif_su == 0 else "Counter 1",
                          "%d"))
    return consumed


def _parse_payload(items, block1, out_data, out_length):
    """Record stream parser (ref src/devices/m_bus.c:731)."""
    b = out_data
    if block1.block2.qds_walk_by:
        q = BLOCK1A_SIZE - 2
        if block1.A_DevType == 6:
            _decode_records(items, b[q + 17:], 0x0C, 0x00, 0x13, 0, 0, 0, 0)
            _decode_records(items, b[q + 21:], 0x02, 0x00, 0x6C, 0, 1, 0, 0)
            _decode_records(items, b[q + 23:], 0x0C, 0x00, 0x13, 0, 1, 0, 0)
            _decode_records(items, b[q + 27:], 0x02, 0x00, 0x6C, 0, 17, 0,
                            0)
            _decode_records(items, b[q + 29:], 0x0C, 0x00, 0x13, 0, 17, 0,
                            0)
        if block1.A_DevType == 8:
            _decode_records(items, b[q + 17:], 0x0C, 0x00, 0x6E, 0, 0, 0, 0)
            _decode_records(items, b[q + 21:], 0x02, 0x00, 0x6C, 0, 1, 0, 0)
            _decode_records(items, b[q + 23:], 0x0C, 0x00, 0x6E, 0, 1, 0, 0)
            _decode_records(items, b[q + 27:], 0x02, 0x00, 0x6C, 0, 17, 0,
                            0)
            _decode_records(items, b[q + 29:], 0x0C, 0x00, 0x6E, 0, 17, 0,
                            0)
    off = block1.block2.pl_offset
    if off < len(b) and b[off] == 0x2F:
        off += 1
    if off < len(b) and b[off] == 0x2F:
        off += 1
    while off < block1.L and off < out_length:
        dife_array = [0] * 10
        dife_cnt = 0
        vife_array = [0] * 10
        vife_cnt = 0
        dif = b[off]
        dif_sn = (dif & 0x40) >> 6
        while off < len(b) and b[off] & 0x80:
            off += 1
            if off >= len(b):
                return
            dife_array[dife_cnt] = b[off]
            dife_cnt += 1
            if dife_cnt >= 10:
                return
        dif_sn = ((dife_array[0] & 0x0F) << 1) | dif_sn
        dif_su = (dife_array[0] & 0x40) >> 6
        off += 1
        dif_coding = dif & 0x0F
        dif_ff = (dif & 0x30) >> 4
        if off >= len(b):
            return
        vif = b[off]
        while off < len(b) and b[off] & 0x80:
            off += 1
            if off >= len(b):
                return
            vife_array[vife_cnt] = b[off] & 0x7F
            vife_cnt += 1
            if vife_cnt >= 10:
                return
        off += 1
        vif_combinable = 0
        if vif == 0xFB:
            vif_linear = 0x7B
            vif_uam = vife_array[0]
        elif vif == 0xFD:
            vif_linear = 0x7D
            vif_uam = vife_array[0]
        elif vif == 0xFF:
            vif_linear = 0x7F
            vif_uam = vife_array[0]
        else:
            vif_linear = 0
            vif_uam = vif & 0x7F
            vif_combinable = vife_array[0]
        consumed = _decode_records(items, b[off:], dif_coding, vif_linear,
                                   vif_uam, vif_combinable, dif_sn, dif_ff,
                                   dif_su)
        if consumed == -1:
            return
        off += consumed


def _ell_len(ci):
    return {0x8C: 2, 0x8D: 8, 0x8E: 10, 0x8F: 16}.get(ci, -1)


def _parse_ci(b, remaining, pl_base, b2):
    """CI / ELL / AFL / TPL header parser (ref src/devices/m_bus.c:919)."""
    if remaining < 1:
        return
    b2.CI = b[0]
    ell = _ell_len(b2.CI)
    if ell >= 0:
        if remaining < 1 + ell:
            return
        b2.ell_ci = b[0]
        b2.ell_cc = b[1]
        b2.ell_acc = b[2]
        if b2.CI in (0x8D, 0x8F):
            sn_off = 11 if b2.CI == 0x8F else 3
            sn = (b[sn_off] | (b[sn_off + 1] << 8) | (b[sn_off + 2] << 16)
                  | (b[sn_off + 3] << 24))
            b2.ell_sec_mode = (sn >> 29) & 0x7
        else:
            b2.ell_sec_mode = 0
        if b2.ell_sec_mode != 0:
            return
        _parse_ci(b[1 + ell:], remaining - 1 - ell, pl_base + 1 + ell, b2)
        return
    if b2.CI == 0x90:
        if remaining < 2:
            return
        afl_len = b[1]
        if remaining < 2 + afl_len:
            return
        _parse_ci(b[2 + afl_len:], remaining - 2 - afl_len,
                  pl_base + 2 + afl_len, b2)
        return
    if b2.CI == 0x7A:
        b2.AC = b[1]
        b2.ST = b[2]
        b2.CW = (b[4] << 8) | b[3]
        b2.pl_offset = pl_base + 5
    elif b2.CI == 0x72:
        b2.AC = b[9]
        b2.ST = b[10]
        b2.CW = (b[12] << 8) | b[11]
        b2.pl_offset = pl_base + 13
    elif b2.CI == 0x78:
        b2.pl_offset = pl_base + 1
    if (b2.CI == 0x78 and remaining >= 10 and b[1] == 0x0D and b[2] == 0xFF
            and b[3] == 0x5F and b[4] == 0x35):
        b2.AC = b[7]
        b2.ST = b[5]
        b2.CW = (b[9] << 8) | b[8]
        b2.pl_offset = pl_base + 1
        b2.qds_walk_by = 1


def _parse_block2(in_data, in_length, block1, block1_size, pl_base):
    b = in_data[block1_size:]
    b2 = block1.block2
    if block1.knx_mode:
        b2.knx_ctrl = b[0]
        b2.src = (b[1] << 8) | b[2]
        b2.dst = (b[3] << 8) | b[4]
        b2.l_npci = b[5]
        b2.tpci = b[6]
        b2.apci = b[7]
    else:
        remaining = in_length - block1_size if in_length > block1_size \
            else 0
        _parse_ci(b, remaining, pl_base, b2)
    return 0


def _decode_format_a(in_data, in_length, block1):
    """Format A frame (ref src/devices/m_bus.c:1040).
    Returns (ok, out_data, out_length)."""
    block1.L = in_data[0]
    block1.C = in_data[1]
    if in_data[2] == 0xFF and in_data[3] == 0x03:
        block1.knx_mode = 1
        block1.knx_sn = bytes(in_data[4:10])
    else:
        block1.M_str = _manuf_decode((in_data[3] << 8) | in_data[2])
        block1.A_ID = (_bcd2int(in_data[7]) * 1000000
                       + _bcd2int(in_data[6]) * 10000
                       + _bcd2int(in_data[5]) * 100
                       + _bcd2int(in_data[4]))
        block1.A_Version = in_data[8]
        block1.A_DevType = in_data[9]
    out_length = block1.L - 9 + BLOCK1A_SIZE - 2
    if not _crc_valid(in_data, 10):
        return False, b"", 0
    num_data_blocks = (block1.L - 9 + 15) // 16
    if (block1.L < 9 or (block1.L - 9) + num_data_blocks * 2
            > in_length - BLOCK1A_SIZE):
        return False, b"", 0
    out = bytearray(512)
    out[:BLOCK1A_SIZE - 2] = in_data[:BLOCK1A_SIZE - 2]
    for n in range(num_data_blocks):
        in_off = BLOCK1A_SIZE + n * 18
        out_off = n * 16 + BLOCK1A_SIZE - 2
        block_size = min(block1.L - 9 - n * 16, 16) + 2
        if not _crc_valid(in_data[in_off:], block_size - 2):
            return False, b"", 0
        out[out_off:out_off + block_size] = \
            in_data[in_off:in_off + block_size]
    _parse_block2(in_data, in_length, block1, BLOCK1A_SIZE,
                  BLOCK1A_SIZE - 2)
    return True, bytes(out), out_length


def _decode_format_b(in_data, in_length, block1):
    """Format B frame (ref src/devices/m_bus.c:1090)."""
    block1.L = in_data[0]
    block1.C = in_data[1]
    block1.M_str = _manuf_decode((in_data[3] << 8) | in_data[2])
    block1.A_ID = (_bcd2int(in_data[7]) * 1000000
                   + _bcd2int(in_data[6]) * 10000
                   + _bcd2int(in_data[5]) * 100 + _bcd2int(in_data[4]))
    block1.A_Version = in_data[8]
    block1.A_DevType = in_data[9]
    out_length = block1.L - 11 + BLOCK1B_SIZE - 2
    if block1.L < 12 or block1.L + 1 > in_length:
        return False, b"", 0
    if not _crc_valid(in_data,
                      min(block1.L - 1, BLOCK1B_SIZE + BLOCK2B_SIZE - 2)):
        return False, b"", 0
    out = bytearray(512)
    n = min(block1.L - 11, BLOCK2B_SIZE - 2) + BLOCK1B_SIZE
    out[:n] = in_data[:n]
    l_offset = BLOCK1B_SIZE + BLOCK2B_SIZE - 1
    if block1.L > l_offset + 2:
        if not _crc_valid(in_data[BLOCK1B_SIZE + BLOCK2B_SIZE:],
                          block1.L - l_offset - 2):
            return False, b"", 0
        out[BLOCK2B_SIZE - 2:BLOCK2B_SIZE - 2 + block1.L - l_offset - 2] = \
            in_data[BLOCK2B_SIZE:BLOCK2B_SIZE + block1.L - l_offset - 2]
        out_length -= 2
    out_length += 2
    _parse_block2(in_data, in_length, block1, BLOCK1B_SIZE, BLOCK1B_SIZE)
    return True, bytes(out), out_length


def _output_data(out_data, out_length, block1, mode):
    """Assemble the output event (ref src/devices/m_bus.c:1134)."""
    b2 = block1.block2
    if block1.knx_mode:
        items = [
            ("model", "KNX-RF"),
            ("sn", "".join("%02x" % x for x in block1.knx_sn), "SN"),
            ("knx_ctrl", b2.knx_ctrl, "KNX-Ctrl", "0x%02X"),
            ("src", b2.src, "Src", "0x%04X"),
            ("dst", b2.dst, "Dst", "0x%04X"),
            ("l_npci", b2.l_npci, "L/NPCI", "0x%02X"),
            ("tpci", b2.tpci, "TPCI", "0x%02X"),
            ("apci", b2.apci, "APCI", "0x%02X"),
        ]
    else:
        items = [
            ("model", "Wireless-MBus"),
            ("mode", mode, "Mode"),
            ("M", block1.M_str, "Manufacturer"),
            ("id", block1.A_ID, "ID"),
            ("version", block1.A_Version, "Version"),
            ("type", block1.A_DevType, "Device Type", "0x%02X"),
            ("type_string", _DEVICE_TYPES.get(block1.A_DevType, ""),
             "Device Type String"),
            ("C", block1.C, "Control", "0x%02X"),
        ]
    items.append(("data",
                  "".join("%02x" % x
                          for x in out_data[:max(out_length, 0)]), "Data"))
    if b2.ell_ci:
        items.append(("ell_ci", b2.ell_ci, "ELL Control Info", "0x%02X"))
        items.append(("ell_cc", b2.ell_cc, "ELL Comm Control", "0x%02X"))
        items.append(("ell_acc", b2.ell_acc, "ELL Access number",
                      "0x%02X"))
    if b2.CI and b2.CI != b2.ell_ci:
        items.append(("CI", b2.CI, "Control Info", "0x%02X"))
        if b2.pl_offset:
            items.append(("AC", b2.AC, "Access number", "0x%02X"))
            items.append(("ST", b2.ST, "Status", "0x%02X"))
            items.append(("CW", b2.CW, "Configuration Word", "0x%04X"))
    if not block1.knx_mode and not b2.pl_offset:
        if b2.ell_ci and b2.ell_sec_mode:
            items.append(("payload_encrypted", 1, "Payload Encrypted"))
    elif b2.CW & 0x0500:
        items.append(("payload_encrypted", 1, "Payload Encrypted"))
    else:
        _parse_payload(items, block1, out_data, out_length)
    items.append(("mic", "CRC", "Integrity"))
    return [Event.make(*items)]


def _mode_c_t(bits, dev):
    """Mode C&T callback (ref src/devices/m_bus.c:1226)."""
    if (bits.bits_per_row[0] < 32 + 13 * 8
            or bits.bits_per_row[0] > 64 + 256 * 12):
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, bytes([0x54, 0x3D]), 16)
    if bit_offset + 13 * 8 >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    bit_offset += 16
    row = bits.bb[0]
    block1 = _Block1()
    next_byte = _bitrow_get_byte(row, bit_offset)
    bit_offset += 8
    if next_byte == 0x54:
        mode = "C"
        next_byte = _bitrow_get_byte(row, bit_offset)
        bit_offset += 8
        if next_byte == 0xCD:
            length = (bits.bits_per_row[0] - bit_offset) // 8
            data_in = bytes(bits.extract_bytes(0, bit_offset, length * 8))
            data_in += bytes(512 - len(data_in))
            ok, out, out_len = _decode_format_a(data_in, length, block1)
            if not ok:
                return DECODE_FAIL_SANITY
        elif next_byte == 0x3D:
            length = (bits.bits_per_row[0] - bit_offset) // 8
            data_in = bytes(bits.extract_bytes(0, bit_offset, length * 8))
            data_in += bytes(512 - len(data_in))
            ok, out, out_len = _decode_format_b(data_in, length, block1)
            if not ok:
                return DECODE_FAIL_SANITY
        else:
            return 0
    else:
        mode = "T"
        bit_offset -= 8
        length = (bits.bits_per_row[0] - bit_offset) // 12
        data_in, ok3of6 = _decode_3of6_buffer(row, bit_offset, length)
        if ok3of6 < 0:
            return DECODE_FAIL_SANITY
        data_in = bytes(data_in) + bytes(512 - len(data_in))
        ok, out, out_len = _decode_format_a(data_in, length, block1)
        if not ok:
            return DECODE_FAIL_SANITY
    return _output_data(out, out_len, block1, mode)


@decoder("m_bus_mode_c_t")
def m_bus_mode_c_t(bits, dev):
    """Wireless M-Bus mode C&T uplink (ref src/devices/m_bus.c:1493)."""
    return _mode_c_t(bits, dev)


@decoder("m_bus_mode_c_t_downlink")
def m_bus_mode_c_t_downlink(bits, dev):
    """Wireless M-Bus mode T downlink (ref src/devices/m_bus.c:1504)."""
    return _mode_c_t(bits, dev)


@decoder("m_bus_mode_s")
def m_bus_mode_s(bits, dev):
    """Wireless M-Bus mode S (ref src/devices/m_bus.c:1402)."""
    if (bits.bits_per_row[0] < 32 + 13 * 8
            or bits.bits_per_row[0] > 64 + 256 * 8):
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xAA, 0xAB, 0x32]), 24) + 24
    if offset < bits.bits_per_row[0]:
        bits.invert()
        return DECODE_ABORT_EARLY
    bit_offset = bits.search(0, 0, bytes([0x54, 0x76, 0x96]), 24) + 24
    if bit_offset >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    packet = BitBuffer()
    bits.manchester_decode(0, bit_offset, packet, 800)
    # the reference uses the raw bit count as the byte length here;
    # replicated for parity (ref src/devices/m_bus.c:1432)
    length = bits.bits_per_row[0]
    data_in = bytes(packet.extract_bytes(0, 0, min(length, 512 * 8)))
    data_in += bytes(512 - min(len(data_in), 512))
    block1 = _Block1()
    ok, out, out_len = _decode_format_a(data_in, length, block1)
    if not ok:
        return 0
    return _output_data(out, out_len, block1, "S")


@decoder("m_bus_mode_r")
def m_bus_mode_r(bits, dev):
    """Wireless M-Bus mode R (ref src/devices/m_bus.c:1314)."""
    if (bits.bits_per_row[0] < 32 + 13 * 8
            or bits.bits_per_row[0] > 64 + 256 * 8):
        return 0
    bit_offset = bits.search(0, 0, bytes([0x55, 0x54, 0x76, 0x96]), 32)
    if bit_offset + 13 * 8 >= bits.bits_per_row[0]:
        return 0
    bit_offset += 32
    length = (bits.bits_per_row[0] - bit_offset) // 8
    data_in = bytes(bits.extract_bytes(0, bit_offset, length * 8))
    data_in += bytes(512 - len(data_in))
    block1 = _Block1()
    ok, out, out_len = _decode_format_a(data_in, length, block1)
    if not ok:
        return 0
    return _output_data(out, out_len, block1, "R")


@decoder("m_bus_mode_f")
def m_bus_mode_f(bits, dev):
    """Wireless M-Bus mode F stub (ref src/devices/m_bus.c:1352)."""
    if (bits.bits_per_row[0] < 32 + 13 * 8
            or bits.bits_per_row[0] > 64 + 256 * 8):
        return 0
    bit_offset = bits.search(0, 0, bytes([0x55, 0xF6]), 16)
    if bit_offset + 13 * 8 >= bits.bits_per_row[0]:
        return 0
    bit_offset += 16
    next_byte = _bitrow_get_byte(bits.bb[0], bit_offset)
    if next_byte in (0x8D, 0x72):
        return 1  # recognized but not implemented (matches reference)
    return 0


_RADIAN_CONTROL = {0x06: "ack", 0x10: "request", 0x11: "response"}


def _radian_find_wmbus_frame(body):
    """Locate wired M-Bus telegram (ref src/devices/m_bus.c:1605)."""
    body_len = len(body)
    for i in range(max(body_len - 3, 0)):
        if (body[i] != 0x68 or body[i + 3] != 0x68
                or body[i + 1] != body[i + 2]):
            continue
        wlen = body[i + 1]
        if i + 4 + wlen + 2 > body_len:
            continue
        c_frame = body[i + 4:]
        if (sum(c_frame[:wlen]) & 0xFF) != c_frame[wlen] \
                or c_frame[wlen + 1] != 0x16:
            continue
        return c_frame, wlen
    return None, 0


def _radian_decode_row(bits, row):
    """RADIAN row decode (ref src/devices/m_bus.c:1635)."""
    row_bits = bits.bits_per_row[row]
    pos = bits.search(row, 0, bytes([0x0F, 0xFF, 0xFF, 0xFF, 0xF0]), 36)
    if pos >= row_bits:
        return DECODE_ABORT_EARLY
    pos += 36
    if pos >= row_bits:
        return DECODE_ABORT_LENGTH
    max_bits = min(row_bits - pos, 256 * 11)
    frame = [int(x) for x in
             util.extract_bytes_uart_8n2(bits.bb[row], pos, max_bits)]
    frame_len = len(frame)
    frame += [0] * (256 - frame_len)
    if frame_len < 6:
        return DECODE_ABORT_LENGTH
    declared_len = frame[0]
    if declared_len < 6 or declared_len > 256:
        return DECODE_FAIL_SANITY
    if frame_len < declared_len:
        return DECODE_ABORT_LENGTH
    crc_rx = frame[declared_len - 2] | (frame[declared_len - 1] << 8)
    crc_calc = util.crc16lsb(bytes(frame[:declared_len - 2]),
                             declared_len - 2, 0x8408, 0x0000)
    if crc_calc != crc_rx:
        return DECODE_FAIL_MIC
    control = frame[1]
    addr_off, body_off, spaced_hdr = 2, 12, 0
    if (declared_len >= 18 and frame[2] == 0x00 and frame[8] == 0x00
            and frame[14] == 0x00):
        addr_off, body_off, spaced_hdr = 3, 15, 1
    if body_off + 2 > declared_len:
        return DECODE_FAIL_SANITY
    body_len = declared_len - body_off - 2
    receiver = "".join("%02x" % x for x in frame[addr_off:addr_off + 5])
    sender = "".join(
        "%02x" % x
        for x in frame[addr_off + 5 + spaced_hdr:
                       addr_off + 10 + spaced_hdr])
    body_hex = "".join("%02x" % x
                       for x in frame[body_off:body_off + body_len])
    frame_hex = "".join("%02x" % x for x in frame[:declared_len])
    items = [
        ("model", "RADIAN"),
        ("len", declared_len, "Length"),
        ("control", control, "Control", "0x%02x"),
        ("control_string", _RADIAN_CONTROL.get(control, "unknown"),
         "Control type"),
        ("header_variant", "spaced" if spaced_hdr else "compact",
         "Header variant"),
        ("receiver_id", receiver, "Receiver ID"),
        ("sender_id", sender, "Sender ID"),
        ("body_len", body_len, "Body length"),
        ("body", body_hex, "Body"),
        ("crc", crc_rx, "CRC", "0x%04x"),
        ("data", frame_hex, "Data"),
    ]
    wmbus, wlen = _radian_find_wmbus_frame(
        bytes(frame[body_off:body_off + body_len]))
    if wmbus is not None:
        block1 = _Block1()
        block1.L = wlen
        wdata = bytes(wmbus[:min(wlen, 512)])
        wdata += bytes(512 - len(wdata))
        wrem = len(wdata) - 2 if wlen > 2 else 0
        wrem = min(wlen, 512) - 2 if min(wlen, 512) > 2 else 0
        _parse_ci(wdata[2:], wrem, 2, block1.block2)
        if block1.block2.CI in (0x72, 0x7A):
            _parse_payload(items, block1, wdata, min(wlen, 512))
    items.append(("mic", "CRC", "Integrity"))
    return [Event.make(*items)]


@decoder("radian")
def radian(bits, dev):
    """RADIAN/RADIAN0 meter (ref src/devices/m_bus.c:1794)."""
    events = []
    aborts = 0
    fails = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < 36 + 6 * 11:
            aborts += 1
            continue
        ret = _radian_decode_row(bits, row)
        if isinstance(ret, list):
            events += ret
        elif ret in (DECODE_FAIL_MIC, DECODE_FAIL_SANITY):
            fails += 1
        else:
            aborts += 1
    if events:
        return events
    if fails:
        return DECODE_FAIL_MIC
    if aborts:
        return DECODE_ABORT_EARLY
    return DECODE_ABORT_LENGTH

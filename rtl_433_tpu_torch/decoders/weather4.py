"""Weather / garden sensors batch 4 (reference files cited per
function): Vevor 7-in-1, Sainlogic SA8, WallarGe CLTX001, Shenzhen Wale
WL-TH6R, Homelead HG9901, RainPoint HCS012ARF.
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("vevor_7in1")
def vevor_7in1(bits, dev):
    """Vevor 7-in-1 weather station (ref src/devices/vevor_7in1.c)."""
    pre = bytes([0xAA, 0xAA, 0xCA, 0xCA, 0x54])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    ret = 0
    pos = 0
    while True:
        pos = bits.search(0, pos, pre, 40)
        if pos + 264 > bits.bits_per_row[0]:
            break
        pos += 40
        if pos + 21 * 8 > bits.bits_per_row[0]:
            ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.extract_bytes(0, pos, 21 * 8))
        if (util.add_bytes(bytes(b[:19])) & 0xFF) != b[19]:
            ret = DECODE_FAIL_MIC
            continue
        if b[0] == 0xAA and b[1] == 0:
            wind_raw = ((b[8] << 8) | b[9]) - 257
            direction_deg = (((b[11] & 0x0F) << 8) | b[12]) - 257
            rain_raw = ((b[13] << 8) | b[14]) - 257
            light_lux = ((b[16] << 8) | b[17]) - 257
            if (light_lux & 0x8000) >> 15 == 1:
                light_lux = (light_lux & 0x7FFF) * 10
            return [Event.make(
                ("model", "Vevor-7in1"),
                ("id", (b[2] << 8) | b[3], "", "%04x"),
                ("channel", b[1] & 0x0F, "Channel"),
                ("battery_ok", int(not ((b[4] & 0x80) >> 7)),
                 "Battery_OK"),
                ("temperature_C", (((b[5] << 8) | b[6]) - 500) * 0.1,
                 "Temperature", "%.1f C"),
                ("humidity", b[7], "Humidity", "%u %%"),
                ("wind_avg_km_h", wind_raw / 8.333, "Wind avg speed",
                 "%.1f km/h"),
                ("wind_max_km_h", b[10] / 1.25, "Wind max speed",
                 "%.1f km/h"),
                ("wind_dir_deg", direction_deg, "Wind Direction"),
                ("rain_mm", rain_raw * 0.233, "Total rainfall", "%.1f mm"),
                ("uvi", float((b[15] & 0x1F) - 1), "UV Index", "%.0f"),
                ("light_lux", light_lux, "Lux", "%u"),
                ("mic", "CHECKSUM", "Integrity"),
            )]
        pos += 264
    return ret


@decoder("sainlogic_sa8")
def sainlogic_sa8(bits, dev):
    """Sainlogic SA8 weather station (ref src/devices/sainlogic_sa8.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    offset = bits.search(0, 0, bytes([0xFC, 0x95]), 16) + 16
    if offset >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    num_bits = min(bits.bits_per_row[0] - offset, 41 * 10)
    b = _ints(util.extract_bytes_uart_8n1(bits.bb[0], offset, num_bits))
    if len(b) < 41:
        return DECODE_ABORT_LENGTH
    # CRC only logged by the reference, not enforced
    temp_raw = _s16((b[20] << 8) | b[19])
    return [Event.make(
        ("model", "Sainlogic-SA8"),
        ("id", "%02x%02x%02x%02x%02x%02x" % (b[4], b[3], b[6], b[5], b[8],
                                             b[7]), ""),
        ("battery_ok", (b[38] & 0x10) >> 4, "Battery_OK"),
        ("counter", (b[16] << 8) | b[15], "Counter"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[21], "Humidity", "%u %%"),
        ("wind_avg_km_h", ((b[30] << 8) | b[29]) * 0.036, "Wind avg speed",
         "%.1f km/h"),
        ("wind_max_km_h", ((b[28] << 8) | b[27]) * 0.036, "Wind max speed",
         "%.1f km/h"),
        ("wind_dir_deg", (b[32] << 8) | b[31], "Wind Direction"),
        ("rain_mm", ((b[34] << 8) | b[33]) * 0.42893617, "Total rainfall",
         "%.1f mm"),
        ("unknown", (b[36] << 8) | b[35], "Unknown", "%04x"),
        ("flags", (b[38] << 8) | b[37], "Flags", "%04x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("wallarge_cltx001")
def wallarge_cltx001(bits, dev):
    """WallarGe CLTX001 outdoor sensor
    (ref src/devices/wallarge_cltx001.c)."""
    ret = DECODE_ABORT_LENGTH
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 56:
            continue
        b = [(~x) & 0xFF for x in _ints(bits.bb[row])[:7]]
        if b[6] != (util.add_bytes(bytes(b[:5])) & 0xFF):
            ret = DECODE_FAIL_MIC
            continue
        parity_byte = b[5]
        parity_valid = True
        if parity_byte & 0x07:
            parity_valid = False
        else:
            for i in range(5):
                if util.parity8(b[i]) == ((parity_byte >> (7 - i)) & 1):
                    parity_valid = False
                    break
        if not parity_valid:
            ret = DECODE_FAIL_MIC
            continue
        battery_low = (b[3] & 0x80) >> 7
        test_mode = (b[3] & 0x40) >> 6
        temp_raw = _s16(((b[3] & 0x0F) << 12) | (b[4] << 4))
        return [Event.make(
            ("model", "WallarGe-CLTX001", "Model"),
            ("id", (b[0] << 8) | b[1], "Sensor ID"),
            ("channel", ((b[3] & 0x30) >> 4) + 1, "Channel"),
            ("battery_ok", int(not battery_low), "Battery")
            if battery_low else None,
            ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature",
             "%.1f C"),
            ("test", test_mode, "Test?") if test_mode else None,
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return ret


@decoder("shenzhen_wale_wl_th6r")
def shenzhen_wale_wl_th6r(bits, dev):
    """Shenzhen Wale WL-TH6R temp/humidity sensor
    (ref src/devices/shenzhen_wale_wl_th6r.c)."""
    row = bits.find_repeated_prefix(2, 72)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 73:
        return DECODE_ABORT_LENGTH
    b = [(~x) & 0xFF for x in _ints(bits.bb[row])[:9]]
    for i in range(7):
        b[i] ^= b[7]
    x = util.xor_bytes(bytes(b[:7]))
    s = util.add_bytes(bytes(b[:7]))
    mic = 0xA5 ^ x ^ (s & 0xFF) ^ (s >> 8)
    if b[8] != mic:
        return DECODE_FAIL_MIC
    temp_c = _s16((b[3] << 8) | b[4]) * 0.1
    if temp_c < -20.0 or temp_c > 60.0:
        return DECODE_FAIL_SANITY
    if b[5] > 127:
        return DECODE_FAIL_SANITY
    pairing = b[7] >> 7
    cycle = 0x40 if (b[7] & 0x40) else (b[7] & 0x3F)
    return [Event.make(
        ("model", "WL-TH6R", "Model"),
        ("id", (b[0] << 16) | (b[1] << 8) | b[2], "Sensor ID", "%06X"),
        ("battery_ok", 0, "Battery") if b[6] < 20 else None,
        ("battery_pct", b[6], "Battery level", "%d %%"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", b[5], "Humidity", "%d %%"),
        ("pairing", pairing, "Pairing?") if pairing else None,
        ("cycle", cycle, "Cycle"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_HG9901_LUX = [60, 200, 400, 600, 1000, 1500, 2800, 4500, 10000, -1, -1,
               -1, -1, -1, -1, -1]


@decoder("homelead_hg9901")
def homelead_hg9901(bits, dev):
    """Homelead HG9901 soil sensor (ref src/devices/homelead_hg9901.c)."""
    row = bits.find_repeated_row(1, 65)
    if row < 0:
        return DECODE_ABORT_EARLY
    row_len = bits.bits_per_row[row]
    if row_len > 65 + 8:
        return DECODE_ABORT_EARLY
    pos = bits.search(row, 0, bytes([0x55, 0xAA]), 16)
    if pos + 65 > row_len:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[row])
    chk = (b[7] & 0xF0) >> 4
    if (util.add_nibbles(bytes(b[:7])) & 0x0F) != chk:
        return DECODE_FAIL_MIC
    temperature = b[5] & 0x7F
    if (b[5] & 0x80) >> 7:
        temperature = -temperature
    batt_lvl = (b[6] & 0x30) >> 4
    light_lvl = b[6] & 0x0F
    return [Event.make(
        ("model", "Homelead-HG9901", "Model"),
        ("id", (b[2] << 8) | b[3], "ID", "%04X"),
        ("battery_ok", int(batt_lvl > 1), "Battery"),
        ("battery_pct", 100 * batt_lvl // 3, "Battery level"),
        ("temperature_C", float(temperature), "Temperature", "%.0f C"),
        ("moisture", b[4], "Moisture", "%d %%"),
        ("light_lvl", light_lvl, "Light level"),
        ("light_lux", _HG9901_LUX[light_lvl], "Light", "%d lux"),
        ("sequence", (b[6] & 0xC0) >> 6, "TX Sequence"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("rainpoint_hcs012arf")
def rainpoint_hcs012arf(bits, dev):
    """RainPoint HCS012ARF rain gauge
    (ref src/devices/rainpoint_hcs012arf.c)."""
    row = bits.find_repeated_row(4, 163)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 163:
        return DECODE_ABORT_LENGTH
    msg = BitBuffer()
    bits.manchester_decode(row, 0, msg, 10 * 2 * 8)
    msg.invert()
    b = _ints(util.reflect_bytes(bytes(_ints(msg.bb[0])[:10])))
    if b[0] != 0xA5:
        return DECODE_ABORT_EARLY
    if (util.add_bytes(bytes(b[1:9])) & 0xFF) != b[9]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "RainPoint-HCS012ARF"),
        ("id", (b[4] << 24) | (b[3] << 16) | (b[2] << 8) | b[1], ""),
        ("flags1", b[5] >> 2, "Flags 1", "%02x"),
        ("flags2", b[6], "Flags 2", "%02x"),
        ("battery_ok", int(not ((b[5] & 0x02) >> 1)), "Battery"),
        ("rain_mm", (((b[8] << 8) | b[7])) * 0.1, "Total rainfall",
         "%.1f mm"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

"""Oregon Scientific decoders: v1, v2.1/v3 family, SL109H
(ref src/devices/oregon_scientific.c, oregon_scientific_v1.c,
oregon_scientific_sl109h.c)."""

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


# sensor ids (ref src/devices/oregon_scientific.c:20-50)
ID_THGR122N = 0x1D20
ID_THGR968 = 0x1D30
ID_BTHR918 = 0x5D50
ID_BHTR968 = 0x5D60
ID_RGR968 = 0x2D10
ID_THR228N = 0xEC40
ID_AWR129 = 0xEC41
ID_RTGN318 = 0x0CC3
ID_THGR810 = 0xF024
ID_THGR810a = 0xF8B4
ID_THN802 = 0xC844
ID_PCR800 = 0x2914
ID_PCR800a = 0x2D14
ID_WGR800 = 0x1984
ID_WGR800a = 0x1994
ID_WGR968 = 0x3D00
ID_UV800 = 0xD874
ID_THN129 = 0xCC43
ID_RTHN129 = 0x0CD3
ID_BTHGN129 = 0x5D53
ID_UVR128 = 0xEC70
ID_THGR328N = 0xCC23
ID_RTGR328N = (0xDCC3, 0xCCC3, 0xBCC3, 0xACC3, 0x9CC3)
ID_RTGR328N_67 = (0x8CE3, 0x8AE3)


def _os_temperature(m):
    t = ((m[5] >> 4) * 100 + (m[4] & 0x0F) * 10 + ((m[4] >> 4) & 0x0F)) / 10.0
    t += (m[5] & 0x07) * 100.0
    return -t if m[5] & 0x08 else t


def _os_humidity(m):
    return (m[6] & 0x0F) * 10 + (m[6] >> 4)


def _os_uv(m):
    return (m[4] & 0x0F) * 10 + (m[4] >> 4)


def _os_rain_rate(m):
    return ((m[5] & 0x0F) * 1000 + (m[5] >> 4) * 100
            + (m[4] & 0x0F) * 10 + (m[4] >> 4)) / 100.0


def _os_total_rain(m):
    return ((m[8] & 0x0F) * 100.0 + ((m[8] >> 4) & 0x0F) * 10.0
            + (m[7] & 0x0F) + ((m[7] >> 4) & 0x0F) / 10.0
            + (m[6] & 0x0F) / 100.0 + ((m[6] >> 4) & 0x0F) / 1000.0)


def _swap(b):
    return ((b & 0xF) << 4) | (b >> 4)


def _os_checksum_ok(m, checksum_nibble_idx):
    """Sum-of-nibbles with swapped checksum byte (ref :151-178)."""
    son = 0
    for i in range(0, checksum_nibble_idx - 1, 2):
        v = m[i >> 1]
        son += (v >> 4) + (v & 0x0F)
    if checksum_nibble_idx & 1:
        son += m[checksum_nibble_idx >> 1] >> 4
        checksum = (m[checksum_nibble_idx >> 1] & 0x0F) | \
            (m[(checksum_nibble_idx + 1) >> 1] & 0xF0)
    else:
        checksum = (m[checksum_nibble_idx >> 1] >> 4) | \
            ((m[checksum_nibble_idx >> 1] & 0x0F) << 4)
    return (son & 0xFF) == checksum


def _v2_ok(m, bits_expected, msg_bits, nibbles):
    return bits_expected == msg_bits and _os_checksum_ok(m, nibbles)


def _base_fields(model, device_id, channel, battery_low):
    return [("model", model), ("id", device_id, "House Code"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(not battery_low), "Battery")]


def _v2_1_decode(bits):
    """OS v2.1 (ref src/devices/oregon_scientific.c:196-611)."""
    b = _ints(bits.bb[0])
    if (b[1], b[2]) != (0x55, 0x55) and (b[1], b[2]) != (0xAA, 0xAA):
        return DECODE_ABORT_EARLY
    databits = BitBuffer()
    sync_test_val = (b[3] << 24) | (b[4] << 16) | (b[5] << 8) | b[6]
    for pattern_index in range(8):
        mask = (0xFFFF0000 >> pattern_index) & 0xFFFFFFFF
        pattern = (0x55990000 >> pattern_index)
        pattern2 = (0xAA990000 >> pattern_index)
        if (sync_test_val & mask) != pattern and \
                (sync_test_val & mask) != pattern2:
            continue
        bits.manchester_decode(0, pattern_index + 40, databits, 173)
        arr = databits.bb[0]
        n = (databits.bits_per_row[0] + 7) // 8
        ref = util.reflect_nibbles(arr[:n])
        for i in range(n):
            databits.bb[0][i] = ref[i]
        break
    msg_bits = databits.bits_per_row[0]
    m = _ints(databits.bb[0])
    sensor_id = (m[0] << 8) | m[1]
    channel = (m[2] >> 4) & 0x0F
    device_id = (m[2] & 0x0F) | (m[3] & 0xF0)
    battery_low = (m[3] >> 2) & 0x01
    base = lambda model: _base_fields(model, device_id, channel, battery_low)

    if sensor_id in (ID_THGR122N, ID_THGR968):
        if not _v2_ok(m, 68, msg_bits, 15) and not _v2_ok(m, 76, msg_bits, 15):
            return 0
        if sensor_id == ID_THGR968:
            model = "Oregon-THGR968"
        elif msg_bits == 76:
            model = "Oregon-THGR122N"
        else:
            model = "Oregon-THGR228N"
        return [Event.make(*base(model),
                           ("temperature_C", _os_temperature(m),
                            "Temperature", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"))]
    if sensor_id == ID_WGR968:
        if not _v2_ok(m, 94, msg_bits, 17):
            return 0
        quadrant = (m[4] & 0x0F) * 10 + ((m[4] >> 4) & 0x0F) \
            + ((m[5] >> 4) & 0x0F) * 100
        avg = ((m[7] >> 4) & 0x0F) / 10.0 + (m[7] & 0x0F) \
            + ((m[8] >> 4) & 0x0F) / 10.0
        gust = (m[5] & 0x0F) / 10.0 + ((m[6] >> 4) & 0x0F) \
            + (m[6] & 0x0F) / 10.0
        return [Event.make(*base("Oregon-WGR968"),
                           ("wind_max_m_s", gust, "Gust", "%.1f m/s"),
                           ("wind_avg_m_s", avg, "Average", "%.1f m/s"),
                           ("wind_dir_deg", float(quadrant), "Direction",
                            "%.1f degrees"))]
    if sensor_id == ID_BHTR968:
        if not _v2_ok(m, 92, msg_bits, 19):
            return 0
        pressure = float(((m[7] & 0x0F) | (m[8] & 0xF0)) + 856)
        return [Event.make(*base("Oregon-BHTR968"),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"),
                           ("pressure_hPa", pressure, "Pressure", "%.0f hPa"))]
    if sensor_id == ID_BTHR918:
        if not _v2_ok(m, 84, msg_bits, 19):
            return 0
        pressure = float(((m[7] & 0x0F) | (m[8] & 0xF0)) + 795)
        return [Event.make(*base("Oregon-BTHR918"),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"),
                           ("pressure_hPa", pressure, "Pressure", "%.0f hPa"))]
    if sensor_id == ID_RGR968:
        if not _v2_ok(m, 80, msg_bits, 16):
            return 0
        rain_rate = ((m[4] & 0x0F) * 100 + (m[4] >> 4) * 10
                     + ((m[5] >> 4) & 0x0F)) / 10.0
        total = ((m[7] & 0xF) * 10000 + (m[7] >> 4) * 1000
                 + (m[6] & 0xF) * 100 + (m[6] >> 4) * 10 + (m[5] & 0xF)) / 10.0
        return [Event.make(*base("Oregon-RGR968"),
                           ("rain_rate_mm_h", rain_rate, "Rain Rate",
                            "%.2f mm/h"),
                           ("rain_mm", total, "Total Rain", "%.2f mm"))]
    if sensor_id in (ID_THR228N, ID_AWR129) and msg_bits == 76:
        if not _v2_ok(m, 76, msg_bits, 12):
            return 0
        model = "Oregon-THR228N" if sensor_id == ID_THR228N else "Oregon-AWR129"
        return [Event.make(*base(model),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"))]
    if sensor_id == ID_THR228N and msg_bits == 64:  # THN132N
        if not _v2_ok(m, 64, msg_bits, 12):
            return 0
        if ((m[5] >> 4) & 0x0F) > 9 or (m[4] & 0x0F) > 9 \
                or ((m[4] >> 4) & 0x0F) > 9:
            return DECODE_FAIL_SANITY
        temp_c = _os_temperature(m)
        if temp_c > 70 or temp_c < -50:
            return DECODE_FAIL_SANITY
        return [Event.make(*base("Oregon-THN132N"),
                           ("temperature_C", temp_c, "Celsius", "%.2f C"))]
    if (sensor_id & 0x0FFF) == ID_RTGN318 and msg_bits == 80:
        if not _v2_ok(m, 80, msg_bits, 15):
            return 0
        return [Event.make(*base("Oregon-RTGN129"),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"))]
    if sensor_id in ID_RTGR328N and msg_bits == 173:
        if not _v2_ok(m, 173, msg_bits, 15):
            return 0
        return [Event.make(*base("Oregon-RTGR328N"),
                           ("temperature_C", _os_temperature(m),
                            "Temperature", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"))]
    if sensor_id in ID_RTGR328N_67:
        if not _v2_ok(m, 100, msg_bits, 21):
            return 0
        clock = "%04d-%02d-%02dT%02d:%02d:%02d" % (
            (m[9] & 0x0F) * 10 + ((m[9] & 0xF0) >> 4) + 2000,
            (m[8] & 0xF0) >> 4,
            (m[7] & 0x0F) * 10 + ((m[7] & 0xF0) >> 4),
            (m[6] & 0x0F) * 10 + ((m[6] & 0xF0) >> 4),
            (m[5] & 0x0F) * 10 + ((m[5] & 0xF0) >> 4),
            (m[4] & 0x0F) * 10 + ((m[4] & 0xF0) >> 4))
        return [Event.make(*base("Oregon-RTGR328N"),
                           ("radio_clock", clock, "Radio Clock"))]
    if (sensor_id & 0x0FFF) == ID_RTGN318:
        if msg_bits == 76 and _v2_ok(m, 76, msg_bits, 15):
            return [Event.make(*base("Oregon-RTGN318"),
                               ("temperature_C", _os_temperature(m),
                                "Celsius", "%.2f C"),
                               ("humidity", _os_humidity(m),
                                "Humidity", "%u %%"))]
        return 0
    if sensor_id == ID_THN129 or (sensor_id & 0x0FFF) == ID_RTHN129:
        if _v2_ok(m, 68, msg_bits, 12):
            model = "Oregon-THN129" if sensor_id == ID_THN129 \
                else "Oregon-RTHN129"
            return [Event.make(*base(model),
                               ("temperature_C", _os_temperature(m),
                                "Celsius", "%.2f C"))]
        return 0
    if sensor_id == ID_BTHGN129:
        if not _v2_ok(m, 92, msg_bits, 19):
            return 0
        pressure = float(((m[7] & 0x0F) | (m[8] & 0xF0)) * 2
                         + (m[8] & 0x01) + 600)
        return [Event.make(*base("Oregon-BTHGN129"),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"),
                           ("pressure_hPa", pressure, "Pressure",
                            "%.2f hPa"))]
    if sensor_id == ID_UVR128 and msg_bits == 148:
        if not _v2_ok(m, 148, msg_bits, 12):
            return 0
        if ((m[4] >> 4) & 0x0F) > 9 or (m[4] & 0x0F) > 9:
            return DECODE_FAIL_SANITY
        uvidx = _os_uv(m)
        if uvidx < 0 or uvidx > 25:
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "Oregon-UVR128"),
            ("id", device_id, "House Code"),
            ("uvi", float(uvidx), "UV Index", "%.0f"),
            ("battery_ok", int(not battery_low), "Battery"))]
    if sensor_id == ID_THGR328N:
        if not _v2_ok(m, 173, msg_bits, 15):
            return 0
        return [Event.make(*base("Oregon-THGR328N"),
                           ("temperature_C", _os_temperature(m),
                            "Temperature", "%.2f C"),
                           ("humidity", _os_humidity(m), "Humidity", "%u %%"))]
    return 0


def _v3_decode(bits):
    """OS v3 (ref src/devices/oregon_scientific.c:621-1007)."""
    b = _ints(bits.bb[0])
    n = bits.bits_per_row[0]
    if (((b[0] & 0xF) != 0x0F or b[1] != 0xFF or (b[2] & 0xC0) != 0xC0)
            and ((b[0] & 0xF) != 0x00 or b[1] != 0x00 or (b[2] & 0xC0) != 0)):
        return DECODE_ABORT_EARLY
    os_pos = bits.search(0, 0, bytes([0x00, 0x05]), 16) + 16
    cm180_pos = bits.search(0, 0, bytes([0x00, 0x46]), 16) + 8
    cm180i_pos = bits.search(0, 0, bytes([0x00, 0x4A]), 16) + 8
    cm130_pos = bits.search(0, 0, bytes([0x00, 0x00, 0x00, 0x60]), 32) + 24
    alt_pos = bits.search(0, 0, bytes([0xFF, 0xF5]), 16) + 16
    if n - os_pos >= 56:
        msg_pos, msg_len = os_pos, n - os_pos
    elif n - cm180_pos >= 52:
        msg_pos, msg_len = cm180_pos, n - cm180_pos
    elif n - cm180i_pos >= 84:
        msg_pos, msg_len = cm180i_pos, n - cm180i_pos
    elif n - cm130_pos >= 96:
        msg_pos, msg_len = cm130_pos, n - cm130_pos
    elif n - alt_pos >= 56:
        msg_pos, msg_len = alt_pos, n - alt_pos
    else:
        return DECODE_ABORT_EARLY
    if msg_len > 44 * 8:
        return DECODE_ABORT_EARLY
    raw = bits.extract_bytes(0, msg_pos, msg_len)
    m = [0] * 44
    ref = util.reflect_nibbles(raw)
    for i in range(len(ref)):
        m[i] = int(ref[i])
    sensor_id = (m[0] << 8) | m[1]
    channel = (m[2] >> 4) & 0x0F
    device_id = (m[2] & 0x0F) | (m[3] & 0xF0)
    battery_low = (m[3] >> 2) & 0x01
    base = lambda model: _base_fields(model, device_id, channel, battery_low)

    if (sensor_id & 0xF0FF) == ID_THGR810 or sensor_id == ID_THGR810a:
        if not _os_checksum_ok(m, 15):
            return DECODE_FAIL_MIC
        if any(x > 9 for x in (((m[5] >> 4) & 0xF), m[4] & 0xF,
                               (m[4] >> 4) & 0xF, m[6] & 0xF,
                               (m[6] >> 4) & 0xF)):
            return DECODE_FAIL_SANITY
        temp_c = _os_temperature(m)
        if temp_c > 70 or temp_c < -50:
            return DECODE_FAIL_SANITY
        tx_button = m[0] & 1
        return [Event.make(
            ("model", "Oregon-THGR810"),
            ("id", device_id, "House Code"),
            ("channel", channel, "Channel"),
            ("button", tx_button, "Button") if tx_button else None,
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temp_c, "Celsius", "%.2f C"),
            ("humidity", _os_humidity(m), "Humidity", "%u %%"))]
    if sensor_id == ID_THN802:
        if not _os_checksum_ok(m, 12):
            return DECODE_FAIL_MIC
        return [Event.make(*base("Oregon-THN802"),
                           ("temperature_C", _os_temperature(m),
                            "Celsius", "%.2f C"))]
    if sensor_id == ID_UV800:
        if not _os_checksum_ok(m, 13):
            return DECODE_FAIL_MIC
        return [Event.make(*base("Oregon-UV800"),
                           ("uvi", float(_os_uv(m)), "UV Index", "%.0f"))]
    if sensor_id == ID_PCR800:
        if not _os_checksum_ok(m, 18):
            return DECODE_FAIL_MIC
        if any((m[i] & 0xF) > 9 or ((m[i] >> 4) & 0xF) > 9
               for i in (4, 5, 6, 7, 8)):
            return DECODE_FAIL_SANITY
        return [Event.make(*base("Oregon-PCR800"),
                           ("rain_rate_in_h", _os_rain_rate(m), "Rain Rate",
                            "%5.1f in/h"),
                           ("rain_in", _os_total_rain(m), "Total Rain",
                            "%7.3f in"))]
    if sensor_id == ID_PCR800a:
        if not _os_checksum_ok(m, 18):
            return DECODE_FAIL_MIC
        return [Event.make(*base("Oregon-PCR800a"),
                           ("rain_rate_in_h", _os_rain_rate(m), "Rain Rate",
                            "%.1f in/h"),
                           ("rain_in", _os_total_rain(m), "Total Rain",
                            "%.1f in"))]
    if sensor_id in (ID_WGR800, ID_WGR800a):
        if not _os_checksum_ok(m, 17):
            return DECODE_FAIL_MIC
        if any(x > 9 for x in (m[5] & 0xF, (m[6] >> 4) & 0xF, m[6] & 0xF,
                               (m[7] >> 4) & 0xF, m[7] & 0xF,
                               (m[8] >> 4) & 0xF)):
            return DECODE_FAIL_SANITY
        gust = (m[5] & 0x0F) / 10.0 + ((m[6] >> 4) & 0x0F) \
            + (m[6] & 0x0F) * 10.0
        avg = ((m[7] >> 4) & 0x0F) / 10.0 + (m[7] & 0x0F) \
            + ((m[8] >> 4) & 0x0F) * 10.0
        if gust > 56 or avg > 56:
            return DECODE_FAIL_SANITY
        return [Event.make(*base("Oregon-WGR800"),
                           ("wind_max_m_s", gust, "Gust", "%.1f m/s"),
                           ("wind_avg_m_s", avg, "Average", "%.1f m/s"),
                           ("wind_dir_deg", ((m[4] >> 4) & 0x0F) * 22.5,
                            "Direction", "%.1f degrees"))]
    if m[0] in (0x20, 0x21, 0x22, 0x23, 0x24):  # Owl CM160
        m[0] &= 0x0F
        if not _os_checksum_ok(m, 22):
            return DECODE_FAIL_MIC
        id_ = m[1] & 0x0F
        current_amps = _swap(m[3]) | ((m[4] >> 4) << 8)
        current_watts = current_amps * 0.07 * 230
        total_amps = ((_swap(m[10]) << 36) | (_swap(m[9]) << 28)
                      | (_swap(m[8]) << 20) | (_swap(m[7]) << 12)
                      | (_swap(m[6]) << 4) | (m[5] & 0xF))
        total_kwh = total_amps * 230.0 / 3600.0 / 1000.0 * 1.12
        return [Event.make(
            ("model", "Oregon-CM160"),
            ("id", id_, "House Code"),
            ("power_W", current_watts, "Power", "%7.4f W"),
            ("energy_kWh", total_kwh, "Energy", "%7.4f kWh"))]
    if m[0] == 0x26:  # Owl CM180
        m[0] &= 0x0F
        if not _os_checksum_ok(m, 23):
            return DECODE_FAIL_MIC
        m = [_swap(x) for x in m]
        sequence = m[1] & 0x0F
        id_ = (m[2] << 8) | (m[1] & 0xF0)
        batt_low = m[3] & 0x1
        ipower = int((((m[4] << 8) | (m[3] & 0xF0))) * 1.00625)
        itotal = 0
        if (m[1] & 0x0F) == 0:
            itotal = ((m[10] << 40) | (m[9] << 32) | (m[8] << 24)
                      | (m[7] << 16) | (m[6] << 8) | m[5])
        return [Event.make(
            ("model", "Oregon-CM180"),
            ("id", id_, "House Code"),
            ("battery_ok", int(not batt_low), "Battery"),
            ("power_W", ipower, "Power", "%d W"),
            ("energy_kWh", itotal / 3600.0 / 1000.0, "Energy", "%.2f kWh")
            if itotal != 0 else None,
            ("sequence", sequence, "sequence number"))]
    if m[0] == 0x25:  # Owl CM180i
        m[0] &= 0x0F
        m = [_swap(x) for x in m]
        sequence = m[1] & 0x0F
        id_ = (m[2] << 8) | (m[1] & 0xF0)
        batt_low = 1 if (m[3] & 0x40) else 0
        def cm180i_power(off):
            return int(((m[4 + off * 2] << 8) | (m[3 + off * 2] & 0xF0))
                       * 1.00625)
        itotal = 0
        if msg_len >= 140 and (m[1] & 0x0F) == 0:
            itotal = ((m[14] << 40) | (m[13] << 32) | (m[12] << 24)
                      | (m[11] << 16) | (m[10] << 8) | m[9])
        return [Event.make(
            ("model", "Oregon-CM180i"),
            ("id", id_, "House Code"),
            ("battery_ok", int(not batt_low), "Battery"),
            ("power1_W", cm180i_power(0), "Power1", "%d W"),
            ("power2_W", cm180i_power(1), "Power2", "%d W"),
            ("power3_W", cm180i_power(2), "Power3", "%d W"),
            ("energy_kWh", itotal / 3600.0 / 1000.0, "Energy", "%.2f kWh")
            if itotal != 0 else None,
            ("sequence", sequence, "sequence number"))]
    if m[0] == 0x60:  # Owl CM130
        if util.crc8(bytes(m[1:11]), 10, 0x07, 0x00) != _swap(m[11]):
            return DECODE_FAIL_MIC
        m = [_swap(x) for x in m[:12]]
        power_w = ((m[4] << 8) | m[3]) * 16
        energy_cnt = m[6] | (m[7] << 8) | (m[8] << 16) | (m[9] << 24)
        return [Event.make(
            ("model", "Oregon-CM130"),
            ("id", m[2], "House Code"),
            ("power_W", power_w, "Power", "%d W"),
            ("energy_kWh", energy_cnt / 8192.0, "Energy", "%.2f kWh"),
            ("mic", "CRC", "Integrity"))]
    return DECODE_FAIL_SANITY


@decoder("oregon_scientific")
def oregon_scientific(bits, dev):
    """Oregon Scientific v2.1/v3 dispatcher (ref src/devices/
    oregon_scientific.c:1013-1020)."""
    ret = _v2_1_decode(bits)
    if isinstance(ret, list) and ret:
        return ret
    return _v3_decode(bits)


@decoder("oregon_scientific_v1")
def oregon_scientific_v1(bits, dev):
    """Oregon-v1 (ref src/devices/oregon_scientific_v1.c:27-96)."""
    out = []
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 32:
            continue
        b = _ints(bits.bb[row])
        nibble = []
        raw_cs = 0
        for i in range(4):
            byte = util.reverse8(b[i])
            nibble.append(byte & 0x0F)
            nibble.append(byte >> 4)
            if i < 3:
                raw_cs += nibble[i * 2] + 16 * nibble[i * 2 + 1]
        if b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF and b[3] == 0xFF:
            continue
        checksum = nibble[6] + (nibble[7] << 4)
        cs_fold = (raw_cs & 0xFF) + (raw_cs >> 8)
        cs_alt = (raw_cs + 1 if raw_cs > 0x180 else raw_cs) & 0xFF
        if not checksum or (checksum != cs_fold and checksum != cs_alt):
            continue
        temp_c = nibble[2] * 0.1 + nibble[3] + nibble[4] * 10.0
        if (nibble[5] >> 1) & 0x01:
            temp_c = -temp_c
        out.append(Event.make(
            ("model", "Oregon-v1"),
            ("id", nibble[0], "SID"),
            ("channel", ((nibble[1] >> 2) & 0x03) + 1, "Channel"),
            ("battery_ok", int(not ((nibble[5] >> 3) & 0x01)), "Battery"),
            ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ("mic", "CHECKSUM", "Integrity"),
        ))
    return out


@decoder("oregon_scientific_sl109h")
def oregon_scientific_sl109h(bits, dev):
    """Oregon-SL109H (ref src/devices/oregon_scientific_sl109h.c:30-110)."""
    row = bits.find_repeated_row(2, 38)
    if row < 0 or bits.bits_per_row[row] != 38:
        return DECODE_ABORT_LENGTH
    msg = _ints(bits.bb[row])
    if not msg[0] and not msg[1] and not msg[2] and not msg[3]:
        return DECODE_FAIL_SANITY
    chk = msg[0] >> 4
    b = _ints(bits.extract_bytes(row, 2, 36))
    b[0] &= 0x3F
    if chk == 0 and b[0] == 0 and b[1] == 0 and b[2] == 0:
        return DECODE_FAIL_SANITY
    if (util.add_nibbles(bytes(b[:5]), 5) & 0xF) != chk:
        return DECODE_FAIL_MIC
    channel_code = b[0] >> 4
    if channel_code == 3:
        return DECODE_FAIL_SANITY
    channel = channel_code if channel_code else 3
    hum_tens = b[0] & 0x0F
    hum_ones = b[1] >> 4
    if hum_tens > 9 or hum_ones > 9:
        return DECODE_FAIL_SANITY
    temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
    if temp_c < -20 or temp_c > 60:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Oregon-SL109H", "Model"),
        ("id", ((b[3] & 0x0F) << 4) | (b[4] >> 4), "Id"),
        ("channel", channel, "Channel"),
        ("temperature_C", temp_c, "Celsius", "%.1f C"),
        ("humidity", 10 * hum_tens + hum_ones, "Humidity", "%u %%"),
        ("status", b[3] >> 4, "Status"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

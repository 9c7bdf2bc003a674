"""Classic weather-station decoders (reference files cited per function):
Ambient Weather F007TH, Fine Offset WH1080/WH1050, WT450, LaCrosse WS-2310,
Hideki, Maverick ET-73x, TFA Twin Plus, Inovalley KW9015B, Eurochron,
ThermoPro TX2.
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
    DECODE_FAIL_OTHER,
    decoder,
)


def _ints(b):
    return [int(x) for x in b]


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("ambient_weather")
def ambient_weather(bits, dev):
    """Ambient Weather F007TH (ref src/devices/ambient_weather.c)."""
    def decode_at(row, bitpos):
        b = _ints(bits.extract_bytes(row, bitpos, 48))
        if b[5] != (util.lfsr_digest8(bytes(b[:5]), 5, 0x98, 0x3E) ^ 0x64):
            return DECODE_FAIL_MIC
        temp_raw = ((b[2] & 0x0F) << 8) | b[3]
        temp_f = (temp_raw - 400) * 0.1
        humidity = b[4]
        if humidity > 100:
            return DECODE_FAIL_SANITY
        if temp_f < -40.0 or temp_f >= 344.0:
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "Ambientweather-F007TH"),
            ("id", b[1], "House Code"),
            ("channel", ((b[2] & 0x70) >> 4) + 1, "Channel"),
            ("battery_ok", int(not (b[2] & 0x80)), "Battery"),
            ("temperature_F", temp_f, "Temperature", "%.1f F"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("mic", "CRC", "Integrity"),
        )]

    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        for pattern, pat_len, step in ((bytes([0x01, 0x45]), 12, 16),
                                       (bytes([0xFD, 0x45]), 12, 15)):
            bitpos = 0
            while True:
                bitpos = bits.search(row, bitpos, pattern, pat_len)
                if bitpos + 8 + 6 * 8 > bits.bits_per_row[row]:
                    break
                ret = decode_at(row, bitpos + 8)
                if isinstance(ret, list):
                    return ret
                bitpos += step
    return ret


_WH1080_DIRS = [0, 23, 45, 68, 90, 113, 135, 158,
                180, 203, 225, 248, 270, 293, 315, 338]


def _wh1080_decode(bits, fsk):
    """Fine Offset WH1080/WH3080 (ref src/devices/fineoffset_wh1080.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    nbits = bits.bits_per_row[0]
    preamble_epb = True
    sens_msg = 10
    if fsk:
        fsk_pre = bytes([0xAA, 0x2D, 0xD4])
        off = bits.search(0, 0, fsk_pre, 24) + 24
        if off + 11 * 8 > nbits:
            return DECODE_ABORT_LENGTH
        br = _ints(bits.extract_bytes(0, off - 8, 11 * 8))
        br[0] = 0xFF
    elif 88 <= nbits < 100:
        br = _ints(bits.bb[0])
    elif nbits == 87:
        br = [int(bits.bb[0][0]) >> 1 | 0x80] + _ints(bits.extract_bytes(0, 7, 80))
        preamble_epb = False
    elif nbits == 64:
        sens_msg = 7
        br = _ints(bits.bb[0])
    elif nbits == 63:
        sens_msg = 7
        br = [int(bits.bb[0][0]) >> 1 | 0x80] + _ints(bits.extract_bytes(0, 7, 56))
        preamble_epb = False
    else:
        return DECODE_ABORT_LENGTH
    if br[0] != 0xFF:
        return DECODE_FAIL_SANITY
    if util.crc8(bytes(br[:11 if sens_msg == 10 else 8]),
                 11 if sens_msg == 10 else 8, 0x31, 0xFF):
        return DECODE_FAIL_MIC
    hi = br[1] >> 4
    if hi == 0x0A:
        msg_type = 0
    elif hi == 0x0B:
        msg_type = 1
    elif hi == 0x07:
        msg_type = 2
    else:
        return DECODE_FAIL_SANITY

    device_id = ((br[1] << 4) & 0xF0) | (br[2] >> 4)
    if msg_type == 0:
        if not fsk:
            temp_raw = ((br[2] & 0x03) << 8) | br[3]
            temperature = (temp_raw - 400) * 0.1
        else:
            temp_raw = ((br[2] & 0x0F) << 8) | br[3]
            if temp_raw & 0x800:
                temp_raw = -(temp_raw & 0x7FF)
            temperature = temp_raw * 0.1
        return [Event.make(
            ("model", "Fineoffset-WHx080"),
            ("subtype", 0, "Msg type"),
            ("id", device_id, "Station ID"),
            ("battery_ok", int((br[9] >> 4) != 1), "Battery"),
            ("temperature_C", temperature, "Temperature", "%.1f C"),
            ("humidity", br[4], "Humidity", "%u %%"),
            ("wind_dir_deg", _WH1080_DIRS[br[9] & 0x0F], "Wind Direction"),
            ("wind_avg_km_h", br[5] * 0.34 * 3.6, "Wind avg speed", "%.2f km/h"),
            ("wind_max_km_h", br[6] * 0.34 * 3.6, "Wind gust", "%.2f km/h"),
            ("rain_mm", (((br[7] & 0x0F) << 8) | br[8]) * 0.3,
             "Total rainfall", "%.1f mm"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 1:
        hours = ((br[3] & 0x30) >> 4) * 10 + (br[3] & 0x0F)
        minutes = ((br[4] & 0xF0) >> 4) * 10 + (br[4] & 0x0F)
        seconds = ((br[5] & 0xF0) >> 4) * 10 + (br[5] & 0x0F)
        year = ((br[6] & 0xF0) >> 4) * 10 + (br[6] & 0x0F) + 2000
        month = ((br[7] & 0x10) >> 4) * 10 + (br[7] & 0x0F)
        day = ((br[8] & 0xF0) >> 4) * 10 + (br[8] & 0x0F)
        return [Event.make(
            ("model", "Fineoffset-WHx080"),
            ("subtype", 1, "Msg type"),
            ("id", device_id, "Station ID"),
            ("signal", "DCF77" if (br[2] & 0x0F) == 10 else "WWVB/MSF",
             "Signal Type"),
            ("radio_clock", "%04d-%02d-%02dT%02d:%02d:%02d" % (
                year, month, day, hours, minutes, seconds), "Radio Clock"),
            ("mic", "CRC", "Integrity"),
        )]
    light = (br[4] << 16) | (br[5] << 8) | br[6]
    wm = light / 1265.8 if not preamble_epb else light / 6830.0
    return [Event.make(
        ("model", "Fineoffset-WHx080"),
        ("subtype", 2, "Msg type"),
        ("uv_sensor_id", device_id, "UV Sensor ID"),
        ("uv_status", "OK" if br[3] == 85 else "ERROR", "Sensor Status"),
        ("uv_index", br[2] & 0x0F, "UV Index"),
        ("lux", light * 0.1, "Lux", "%.1f"),
        ("wm", wm, "Watts/m", "%.2f"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("fineoffset_wh1080")
def fineoffset_wh1080(bits, dev):
    """Fine Offset WH1080 OOK (ref src/devices/fineoffset_wh1080.c:330)."""
    return _wh1080_decode(bits, fsk=False)


@decoder("fineoffset_wh1080_fsk")
def fineoffset_wh1080_fsk(bits, dev):
    """Fine Offset WH1080 FSK (ref src/devices/fineoffset_wh1080.c:340)."""
    return _wh1080_decode(bits, fsk=True)


def _wh1050_decode_at(bits, bitpos, fsk):
    br = _ints(bits.extract_bytes(0, bitpos, 9 * 8))
    if util.crc8(bytes(br), 9, 0x31, 0x00):
        return None
    msg_type = br[0] >> 4
    device_id = ((br[0] << 4) & 0xF0) | (br[1] >> 4)
    battery_low = br[1] & 0x04
    model = "TFA-303151" if fsk else "Fineoffset-WH1050"
    if msg_type == 5:
        temp_raw = ((br[1] & 0x03) << 8) | br[2]
        rain_raw = (br[6] << 8) | br[7]
        if not fsk:
            temperature = (temp_raw - 400) * 0.1
            rain = rain_raw * 0.3
        else:
            temperature = temp_raw * 0.1
            rain = rain_raw * 0.5
            if (br[1] & 0x08) >> 3:
                temperature = -temperature
        return Event.make(
            ("model", model),
            ("id", device_id, "Station ID", "%02X"),
            ("msg_type", msg_type, "Msg type"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temperature, "Temperature", "%.1f C"),
            ("humidity", br[3], "Humidity", "%u %%"),
            ("wind_avg_km_h", br[4] * 0.34 * 3.6, "Wind avg speed", "%.2f km/h"),
            ("wind_max_km_h", br[5] * 0.34 * 3.6, "Wind gust", "%.2f km/h "),
            ("rain_mm", rain, "Total rainfall", "%.1f mm"),
            ("mic", "CRC", "Integrity"),
        )
    if msg_type == 6:
        hours = ((br[2] & 0x30) >> 4) * 10 + (br[2] & 0x0F)
        minutes = ((br[3] & 0xF0) >> 4) * 10 + (br[3] & 0x0F)
        seconds = ((br[4] & 0xF0) >> 4) * 10 + (br[4] & 0x0F)
        year = ((br[5] & 0xF0) >> 4) * 10 + (br[5] & 0x0F) + 2000
        month = ((br[6] & 0x10) >> 4) * 10 + (br[6] & 0x0F)
        day = ((br[7] & 0xF0) >> 4) * 10 + (br[7] & 0x0F)
        return Event.make(
            ("model", model),
            ("id", device_id, "Station ID", "%02X"),
            ("msg_type", msg_type, "Msg type"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("radio_clock", "%04d-%02d-%02dT%02d:%02d:%02d" % (
                year, month, day, hours, minutes, seconds), "Radio Clock"),
            ("mic", "CRC", "Integrity"),
        )
    return None


@decoder("fineoffset_wh1050", "tfa_303151")
def fineoffset_wh1050(bits, dev):
    """Fine Offset WH1050 / TFA 30.3151 (ref src/devices/fineoffset_wh1050.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    nbits = bits.bits_per_row[0]
    b0 = int(bits.bb[0][0])
    events = []
    if nbits == 79 and b0 == 0xFE:
        ev = _wh1050_decode_at(bits, 7, fsk=False)
        if ev:
            events.append(ev)
    elif nbits == 80 and b0 == 0xFF:
        ev = _wh1050_decode_at(bits, 8, fsk=False)
        if ev:
            events.append(ev)
    elif 112 < nbits < 760:
        pre = bytes([0xAA, 0x2D, 0xD4])
        bitpos = 0
        while True:
            bitpos = bits.search(0, bitpos, pre, 24)
            if bitpos + 72 > nbits:
                break
            ev = _wh1050_decode_at(bits, bitpos + 24, fsk=True)
            if ev:
                events.append(ev)
            bitpos += 123
    else:
        return DECODE_ABORT_LENGTH
    return events


@decoder("wt450")
def wt450(bits, dev):
    """WT450/WT260H/WT405H (ref src/devices/wt450.c)."""
    if bits.bits_per_row[0] != 36:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if b[0] >> 4 != 0xC:
        return DECODE_ABORT_EARLY
    parity = util.xor_bytes(bytes(b[:5]), 5)
    parity ^= parity >> 4
    parity ^= parity >> 2
    parity &= 0x3
    if parity:
        return DECODE_FAIL_MIC
    humidity = ((b[1] & 0x7) << 4) | (b[2] >> 4)
    temp_whole = ((b[2] << 4) & 0xFF) | (b[3] >> 4)
    temp = (temp_whole - 50.0) + (b[3] & 0xF) / 16.0
    if humidity > 100:
        return DECODE_FAIL_SANITY
    if temp < -35.0 or temp > 75.0:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "WT450-TH"),
        ("id", b[0] & 0xF, "House Code"),
        ("channel", (b[1] >> 6) + 1, "Channel"),
        ("battery_ok", int(not (b[1] & 0x8)), "Battery"),
        ("temperature_C", temp, "Temperature", "%.2f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("seq", b[4] >> 6, "Sequence"),
    )]


@decoder("lacrossews")
def lacrossews(bits, dev):
    """LaCrosse WS-2310/WS-3600 (ref src/devices/lacrossews.c)."""
    events = []
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 52:
            continue
        b = _ints(bits.bb[row])
        if b[0] != 0x09 and b[0] != 0x06:
            continue
        nyb = []
        parity = 0
        for i in range(52):
            bit = (b[i // 8] >> (7 - i % 8)) & 1
            if i % 4 == 0:
                nyb.append(0)
            nyb[-1] |= bit << (3 - i % 4)
            if i == 9 or 27 <= i <= 39:
                parity += bit
        checksum = sum(nyb[:12]) & 0x0F
        if not (nyb[7] == (nyb[10] ^ 0xF) and nyb[8] == (nyb[11] ^ 0xF)
                and (parity & 1) == 1 and checksum == nyb[12]):
            continue
        ws_id = (nyb[0] << 4) + nyb[1]
        msg_type = ((nyb[2] >> 1) & 0x4) + (nyb[2] & 0x3)
        sensor_id = (nyb[3] << 4) + nyb[4]
        bcd = nyb[7] * 100 + nyb[8] * 10 + nyb[9]
        bcd2 = nyb[7] * 10 + nyb[8]
        binv = nyb[7] * 256 + nyb[8] * 16 + nyb[9]
        model = "LaCrosse-WS3600" if ws_id == 0x6 else "LaCrosse-WS2310"
        if msg_type == 0:
            temp_c = (bcd - (400 if ws_id == 0x6 else 300)) * 0.1
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ))
        elif msg_type == 1:
            if nyb[7] == 0xA and nyb[8] == 0xA:
                continue
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("humidity", bcd2, "Humidity"),
            ))
        elif msg_type == 2:
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("rain_mm", 0.5180 * binv, "Rainfall", "%.2f mm"),
            ))
        elif msg_type in (3, 7):
            if nyb[7] == 0xF and nyb[8] == 0xE:
                continue
            wind_spd = (nyb[7] * 16 + nyb[8]) * 0.1
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("wind_avg_m_s", wind_spd, "Wind speed", "%.1f m/s")
                if msg_type == 3 else None,
                ("wind_max_m_s", wind_spd, "Gust speed", "%.1f m/s")
                if msg_type != 3 else None,
                ("wind_dir_deg", nyb[9] * 22.5, "Direction"),
            ))
    return events


@decoder("hideki_ts04")
def hideki_ts04(bits, dev):
    """Hideki TS04/Wind/Rain sensors (ref src/devices/hideki.c)."""
    ret = DECODE_FAIL_OTHER
    for row in range(bits.num_rows):
        unstuffed_len = (bits.bits_per_row[row] + 4) // 9
        if unstuffed_len == 14:
            sensortype = "wind"
        elif unstuffed_len == 10:
            sensortype = "ts04"
        elif unstuffed_len == 9:
            sensortype = "rain"
        elif unstuffed_len == 8:
            sensortype = "temp"
        else:
            ret = DECODE_ABORT_LENGTH
            continue
        unstuffed_len -= 1
        b = _ints(bits.bb[row])
        sync = (b[0] << 1) | (b[1] >> 7)
        startpos = -1
        for i in range(4):
            if sync == 0x0D:
                startpos = 9 - i
                break
            sync >>= 1
        if startpos < 0:
            ret = DECODE_ABORT_EARLY
            continue
        bits.invert()  # (the reference inverts the shared buffer mid-loop)
        b = _ints(bits.bb[row]) + [0, 0]  # the reference reads a padded array
        packet = []
        unstuff_error = 0
        for i in range(unstuffed_len):
            off = startpos + i * 9
            byte = ((b[off // 8] << (off % 8))
                    | (b[off // 8 + 1] >> (8 - off % 8))) & 0xFF
            packet.append(byte)
            par = (b[off // 8 + 1] >> (7 - off % 8)) & 1
            if par != util.parity8(byte):
                ret = DECODE_FAIL_MIC
                unstuff_error = i
                break
        if unstuff_error:
            continue
        packet = packet + [0] * (unstuffed_len - len(packet))
        if util.xor_bytes(bytes(packet[:unstuffed_len - 1]),
                          unstuffed_len - 1):
            ret = DECODE_FAIL_MIC
            continue
        if util.crc8(bytes(packet[:unstuffed_len]), unstuffed_len, 0x07, 0x00):
            ret = DECODE_FAIL_MIC
            continue
        packet = [util.reverse8(x) for x in packet]
        pkt_len = (packet[1] >> 1) & 0x1F
        if pkt_len + 2 != unstuffed_len:
            ret = DECODE_ABORT_LENGTH
            continue
        channel = (packet[0] >> 5) & 0x0F
        if channel >= 5:
            channel -= 1
        rc = packet[0] & 0x0F
        temp = ((packet[4] & 0x0F) * 100 + ((packet[3] & 0xF0) >> 4) * 10
                + (packet[3] & 0x0F))
        if ((packet[4] >> 7) & 1) == 0:
            temp = -temp
        battery_ok = (packet[4] >> 6) & 1
        if sensortype == "ts04":
            humidity = ((packet[5] & 0xF0) >> 4) * 10 + (packet[5] & 0x0F)
            return [Event.make(
                ("model", "Hideki-TS04"),
                ("id", rc, "Rolling Code"),
                ("channel", channel, "Channel"),
                ("battery_ok", battery_ok, "Battery"),
                ("temperature_C", temp / 10.0, "Temperature", "%.1f C"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("mic", "CRC", "Integrity"),
            )]
        if sensortype == "wind":
            wd = [0, 15, 13, 14, 9, 10, 12, 11, 1, 2, 4, 3, 8, 7, 5, 6]
            wind_direction = wd[(packet[10] & 0xF0) >> 4] * 225
            wind_speed = ((packet[8] & 0x0F) * 100 + (packet[7] >> 4) * 10
                          + (packet[7] & 0x0F))
            gust_speed = ((packet[9] >> 4) * 100 + (packet[9] & 0x0F) * 10
                          + (packet[8] >> 4))
            ad = [0, 1, -1, 2]
            return [Event.make(
                ("model", "Hideki-Wind"),
                ("id", rc, "Rolling Code"),
                ("channel", channel, "Channel"),
                ("battery_ok", battery_ok, "Battery"),
                ("temperature_C", temp * 0.1, "Temperature", "%.1f C"),
                ("wind_avg_mi_h", wind_speed * 0.1, "Wind Speed", "%.2f mi/h"),
                ("wind_max_mi_h", gust_speed * 0.1, "Gust Speed", "%.2f mi/h"),
                ("wind_approach", ad[(packet[10] >> 2) & 0x03], "Wind Approach"),
                ("wind_dir_deg", wind_direction * 0.1, "Wind Direction", "%.1f"),
                ("mic", "CRC", "Integrity"),
            )]
        if sensortype == "temp":
            return [Event.make(
                ("model", "Hideki-Temperature"),
                ("id", rc, "Rolling Code"),
                ("channel", channel, "Channel"),
                ("battery_ok", battery_ok, "Battery"),
                ("temperature_C", temp * 0.1, "Temperature", "%.1f C"),
                ("mic", "CRC", "Integrity"),
            )]
        if sensortype == "rain":
            rain_units = (packet[4] << 8) | packet[3]
            return [Event.make(
                ("model", "Hideki-Rain"),
                ("id", rc, "Rolling Code"),
                ("channel", channel, "Channel"),
                ("battery_ok", (packet[1] >> 6) & 1, "Battery"),
                ("rain_mm", rain_units * 0.7, "Rain", "%.1f mm"),
                ("mic", "CRC", "Integrity"),
            )]
    return ret


@decoder("maverick_et73x")
def maverick_et73x(bits, dev):
    """Maverick ET-732/733 BBQ (ref src/devices/maverick_et73x.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 104:
        return DECODE_ABORT_LENGTH
    b0 = _ints(bits.bb[0])
    if b0[0] != 0x55 or b0[1] != 0x66 or b0[2] != 0x6A:
        return DECODE_ABORT_EARLY
    mc = BitBuffer()
    bits.manchester_decode(0, 0, mc, 104)
    if mc.bits_per_row[0] < 52:
        return DECODE_FAIL_SANITY
    b = _ints(mc.bb[0])
    flags = b[1] & 0x0F
    temp1 = (b[2] << 2) | ((b[3] & 0xC0) >> 6)
    temp2 = ((b[3] & 0x3F) << 4) | ((b[4] & 0xF0) >> 4)
    digest = ((b[4] & 0x0F) << 12) | (b[5] << 4) | (b[6] >> 4)
    status = "default" if flags == 2 else ("init" if flags == 7 else "unknown")
    chk = _ints(mc.extract_bytes(0, 12, 24))
    dev_id = util.lfsr_digest16(bytes(chk), 3, 0x8810, 0xDD38) ^ digest
    return [Event.make(
        ("model", "Maverick-ET73x"),
        ("id", dev_id, "Session_ID"),
        ("status", status, "Status"),
        ("temperature_1_C", temp1 - 532.0, "TemperatureSensor1", "%.2f C"),
        ("temperature_2_C", temp2 - 532.0, "TemperatureSensor2", "%.2f C"),
    )]


@decoder("tfa_twin_plus_303049")
def tfa_twin_plus_303049(bits, dev):
    """TFA Twin Plus 30.3049 / Conrad KW9010 (ref
    src/devices/tfa_twin_plus_30.3049.c)."""
    row = bits.find_repeated_row(2, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 36:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if not any(b[:5]):
        return DECODE_ABORT_EARLY
    rb = [util.reverse8(x) for x in b[:5]]
    sum_nibbles = sum((x >> 4) + (x & 0xF) for x in rb[:4])
    if (rb[4] & 0x0F) != (sum_nibbles & 0xF):
        return DECODE_FAIL_MIC
    negative_sign = b[2] & 7
    temp = ((rb[2] & 0x1F) << 4) | (rb[1] >> 4)
    temp_c = (-(512 - temp) if negative_sign else temp) * 0.1
    return [Event.make(
        ("model", "TFA-TwinPlus"),
        ("id", (rb[0] & 0x0F) | ((rb[0] & 0xC0) >> 2), "Id"),
        ("channel", (b[0] >> 2) & 3, "Channel"),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", (rb[3] & 0x7F) - 28, "Humidity", "%u %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("kw9015b")
def kw9015b(bits, dev):
    """Inovalley KW9015B rain/temperature (ref
    src/devices/inovalley-kw9015b.c)."""
    row = bits.find_repeated_row(3, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 36:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    r = [util.reverse8(x) for x in b[:5]]
    temp_raw = _s16((r[2] << 8) | (r[1] & 0xF0))
    rain = ((r[0] & 0xC0) << 4) | ((r[1] & 0x06) << 7) | r[3]
    chksum = sum((r[i] >> 4) + (r[i] & 0x0F) for i in range(4))
    if (chksum & 0x0F) != (r[4] & 0x0F):
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Inovalley-kw9015b"),
        ("id", r[0] & 0x0F),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature", "%.1f C"),
        ("rain", rain, "Rain Count"),
        ("rain_mm", rain * 0.45, "Rain total", "%.1f mm"),
    )]


@decoder("eurochron")
def eurochron(bits, dev):
    """Eurochron TH sensor (ref src/devices/eurochron.c)."""
    row = bits.find_repeated_row(3, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 36:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[1] & 0x0F:
        return DECODE_FAIL_SANITY
    temp_raw = _s16((b[3] << 8) | (b[4] & 0xF0))
    return [Event.make(
        ("model", "Eurochron-TH"),
        ("id", b[0]),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[2], "Humidity"),
        ("button", (b[1] & 0x10) >> 4, "Button"),
    )]


@decoder("thermopro_tx2")
def thermopro_tx2(bits, dev):
    """ThermoPro TX2 (Prologue variant) (ref src/devices/thermopro_tx2.c)."""
    if bits.bits_per_row[0] <= 8 and bits.bits_per_row[0] != 0:
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(4, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[r] > 37:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if (b[0] & 0xF0) != 0x90 and (b[0] & 0xF0) != 0x50:
        return DECODE_FAIL_SANITY
    temp_raw = _s16((b[2] << 8) | (b[3] & 0xF0)) >> 4
    humidity = ((b[3] & 0x0F) << 4) | (b[4] >> 4)
    return [Event.make(
        ("model", "Thermopro-TX2"),
        ("subtype", b[0] >> 4),
        ("id", ((b[0] & 0x0F) << 4) | ((b[1] & 0xF0) >> 4)),
        ("channel", (b[1] & 0x03) + 1, "Channel"),
        ("battery_ok", int(not (b[1] & 0x08)), "Battery"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.2f C"),
        ("humidity", humidity, "Humidity", "%u %%")
        if humidity != 0xCC else None,
        ("button", (b[1] & 0x04) >> 2, "Button"),
    )]

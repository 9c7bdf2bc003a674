"""Misc decoder batch B (reference files cited per function)."""

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


def _s32(v):
    """The reference passes ints through C `int` (DATA_INT), so 32-bit
    values wrap to signed."""
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("tfa_30_3221")
def tfa_30_3221(bits, dev):
    """TFA-303221 (ref src/devices/tfa_30_3221.c)."""
    row = bits.find_repeated_row(4 if bits.num_rows > 4 else 2, 40)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 41:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[row])
    if b[0] == 0:
        return DECODE_FAIL_SANITY
    if b[4] != util.lfsr_digest8_reflect(bytes(b[:4]), 4, 0x31, 0xF4):
        return DECODE_FAIL_MIC
    temp_c = ((((b[1] & 0x0F) << 8) | b[2]) - 500) * 0.1
    return [Event.make(
        ("model", "TFA-303221"),
        ("id", b[0], "Sensor ID"),
        ("channel", ((b[1] >> 4) & 3) + 1, "Channel"),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
        ("humidity", b[3], "Humidity", "%u %%"),
        ("sendmode", (b[1] >> 6) & 1, "Test mode"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("esun_en2053")
def esun_en2053(bits, dev):
    """Esun-EN2053 BBQ (ref src/devices/esun_en2053.c)."""
    row = bits.find_repeated_row(2, 40)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 40:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if b[0] != 0xC0:
        return DECODE_FAIL_SANITY
    chk = (b[0] + b[1] + b[2] + b[3]) & 0x07
    for i in range(4):
        chk |= (1 ^ util.parity8(b[i])) << (4 + i)
    if chk != b[4]:
        return DECODE_FAIL_MIC
    temp1_raw = (b[1] << 4) | (b[2] >> 4)
    temp2_raw = ((b[2] & 0x0F) << 8) | b[3]
    return [Event.make(
        ("model", "Esun-EN2053"),
        ("temperature_1_F", temp1_raw, "Temperature 1", "%d F")
        if temp1_raw != 0xFD6 else None,
        ("temperature_2_F", temp2_raw, "Temperature 2", "%d F")
        if temp2_raw != 0xFD6 else None,
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("rosstech_dcu706")
def rosstech_dcu706(bits, dev):
    """Rosstech-Spa DCU-706 (ref src/devices/rosstech_dcu706.c)."""
    n = bits.bits_per_row[0]
    if bits.num_rows != 1 or n < 55 or n > 300:
        return DECODE_ABORT_EARLY
    start_pos = bits.search(0, 0, bytes([0xDD, 0x40]), 11)
    if start_pos == n:
        start_pos = bits.search(0, 0, bytes([0xCD, 0x00]), 11)
        if start_pos == n:
            return DECODE_ABORT_LENGTH
    if start_pos + 55 > n:
        return DECODE_ABORT_LENGTH
    msg = bytes(_ints(bits.extract_bytes(0, start_pos, 56)))
    b = util.extract_bytes_uart_8o1(msg, 0, 55)
    if len(b) != 5:
        return DECODE_ABORT_LENGTH
    b = _ints(b)
    if (0xFF ^ util.xor_bytes(bytes(b[:4]), 4)) != b[4]:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Rosstech-Spa", "Model"),
        ("id", (b[1] << 8) | b[2], "ID", "%04x"),
        ("msg_type", "Data" if b[0] == 0xBA else "Bond", "Transmission Type"),
        ("temperature_F", b[3], "Temperature", "%d F"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("esic_emt7110")
def esic_emt7110(bits, dev):
    """ESIC-EMT7110 power meter (ref src/devices/esic_emt7110.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    n = bits.bits_per_row[0]
    if n < 120 or n > 140:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4]), 24) + 24
    if offset > n:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, offset, 96))
    b = (b + [0] * 12)[:12]
    if sum(b) & 0xFF:
        return DECODE_FAIL_MIC
    id_ = _s32((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3])
    power_w = (((b[4] & 0x3F) << 8) | b[5]) * 0.5
    current_a = ((b[6] << 8) | b[7]) * 0.001
    voltage_v = (b[8] + 256) * 0.5
    energy_kwh = (((b[9] & 0x3F) << 8) | b[10]) * 0.01
    return [Event.make(
        ("model", "ESIC-EMT7110"),
        ("id", id_, "Sensor ID", "%08x"),
        ("power_W", power_w, "Power", "%.1f W"),
        ("current_A", current_a, "Current", "%.3f A"),
        ("voltage_V", voltage_v, "Voltage", "%.1f V"),
        ("energy_kWh", energy_kwh, "Energy", "%.2f kWh"),
        ("pairing", (b[4] & 0x80) >> 7, "Pairing?"),
        ("connected", (b[4] & 0x40) >> 6, "Connected?"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("baldr_hcs528arf")
def baldr_hcs528arf(bits, dev):
    """Baldr-HCS528ARF (ref src/devices/baldr_hcs528arf.c): inverted
    reflected Manchester, additive checksum."""
    row = bits.find_repeated_row(4, 179)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] > 179:
        return DECODE_ABORT_LENGTH
    decoded = BitBuffer()
    bits.manchester_decode(row, 0, decoded, 11 * 2 * 8)
    decoded.invert()
    b = [util.reverse8(x) for x in _ints(decoded.bb[0])[:11]]
    b = (b + [0] * 11)[:11]
    if b[0] != 0xA5:
        return DECODE_ABORT_EARLY
    if (sum(b[1:10]) & 0xFF) != b[10]:
        return DECODE_FAIL_MIC
    id_ = _s32((b[4] << 24) | (b[3] << 16) | (b[2] << 8) | b[1])
    temp_raw = ((b[8] & 0x0F) << 8) | b[7]
    return [Event.make(
        ("model", "Baldr-HCS528ARF"),
        ("id", id_, "", "%08x"),
        ("battery_ok", int(not ((b[5] & 0x02) >> 1)), "Battery"),
        ("temperature_F", temp_raw * 0.1, "Temperature", "%.1f F"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("baldr_therm")
def baldr_therm(bits, dev):
    """Baldr-E0666TH (ref src/devices/baldr_therm.c)."""
    r = bits.find_repeated_row(8, 64)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[r])
    if bits.bits_per_row[r] > 65:
        return DECODE_ABORT_LENGTH
    if (b[1] & 0x40) != 0x00 or (b[3] & 0xF0) != 0xF0 \
            or (b[4] & 0x0F) != 0x00 or b[5] != 0x00 or (b[6] & 0xF7) != 0x00:
        return DECODE_ABORT_EARLY
    temp_c = (_s16((b[1] << 12) | (b[2] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Baldr-E0666TH"),
        ("id", (b[0] << 8) | b[7], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int(bool(b[1] & 0x80)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", ((b[3] << 4) | (b[4] >> 4)) & 0xFF, "Humidity", "%u %%"),
        ("startup", int(bool(b[6] & 0x08)), "Startup"),
    )]


@decoder("maverick_et73")
def maverick_et73(bits, dev):
    """Maverick-ET73 (ref src/devices/maverick_et73.c)."""
    row = bits.find_repeated_row(3, 48)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    if (not b[0] and not b[1] and not b[2] and not b[3]) or \
            (b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF and b[3] == 0xFF):
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 48:
        return DECODE_ABORT_LENGTH
    temp1_c = (_s16((b[1] << 8) | (b[2] & 0xF0)) >> 4) * 0.1
    temp2_c = (_s16(((b[2] & 0x0F) << 12) | (b[3] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Maverick-ET73"),
        ("id", b[0], "Random Id"),
        ("temperature_1_C", temp1_c, "Temperature 1", "%.1f C"),
        ("temperature_2_C", temp2_c, "Temperature 2", "%.1f C"),
    )]


def _atech_pwm_decode(row_bytes, bit_len, out_len_bits=32):
    """ref src/devices/atech_ws308.c:48-80: 10->0, 1110->1."""
    out = [0] * ((out_len_bits + 7) // 8)
    pos = 0
    cnt = 0
    for i in range(bit_len):
        if row_bytes[i // 8] & (1 << (7 - i % 8)):
            cnt += 1
        else:
            if cnt == 1:
                pos += 1
            elif cnt == 3:
                out[pos // 8] |= 1 << (7 - pos % 8)
                pos += 1
            else:
                break
            if pos >= out_len_bits:
                break
            cnt = 0
    return out, pos


@decoder("atech_ws308")
def atech_ws308(bits, dev):
    """Atech-WS308 (ref src/devices/atech_ws308.c)."""
    if bits.num_rows != 2:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[1] < 58:
        return DECODE_ABORT_LENGTH
    b, length = _atech_pwm_decode(_ints(bits.bb[1]), bits.bits_per_row[1])
    if length < 28:
        return DECODE_ABORT_LENGTH
    chk = util.xor_bytes(bytes(b[:3]), 3)
    chk = ((chk ^ b[3]) >> 4) ^ (chk & 0xF)
    if chk != 0:
        return DECODE_FAIL_MIC
    temp_raw = (b[1] & 0xF) * 100 + (b[2] >> 4) * 10 + (b[2] & 0xF)
    sign = -1 if (b[1] & 0x20) else 1
    return [Event.make(
        ("model", "Atech-WS308"),
        ("id", b[0], "Fixed ID"),
        ("temperature_C", sign * temp_raw * 0.1, "Temperature", "%.1f C"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("thermor_a6n_132tx")
def thermor_a6n_132tx(bits, dev):
    """Thermor-A6N132TX (ref src/devices/thermor_a6n_132tx.c)."""
    if bits.num_rows < 5:
        return DECODE_ABORT_LENGTH
    row = bits.find_repeated_row(5, 32)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 32:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    temp_raw = (b[1] << 8) | b[2]
    if temp_raw > 2500:
        return DECODE_FAIL_SANITY
    lo_sum = (b[0] & 0x0F) + (b[1] & 0x0F) + (b[2] & 0x0F)
    overflow = lo_sum >> 4
    if (lo_sum & 0x0F) != (b[3] & 0x0F):
        return DECODE_FAIL_MIC
    id_ = (b[0] >> 4) & 0x0F
    hi_sum = (b[0] >> 4) + (b[1] >> 4) + (b[2] >> 4)
    chk_hi = b[3] >> 4
    if id_ == 4:
        if chk_hi != ((hi_sum + overflow) & 1):
            return DECODE_FAIL_MIC
    else:
        chk_hi_msb = util.parity8(b[0] & 0x0F) ^ util.parity8(b[1] & 0x0F) \
            ^ util.parity8(b[2])
        chk_hi_low = (2 + (hi_sum & 1)) ^ overflow
        if chk_hi != ((chk_hi_msb << 3) | chk_hi_low):
            return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "Thermor-A6N132TX"),
        ("id", id_, "ID"),
        ("channel", (b[0] >> 2) & 0x03, "Channel"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("simplisafe_gen3")
def simplisafe_gen3(bits, dev):
    """SimpliSafe-Gen3 (ref src/devices/simplisafe_gen3.c)."""
    bitpos = bits.search(0, 0, bytes([0x93, 0x0B, 0x51, 0xDE]), 32) + 32
    if bitpos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bitpos + 24 * 8 > bits.bits_per_row[0]:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, bitpos, 27 * 8))
    b = (b + [0] * 27)[:27]
    if b[0] not in (0x15, 0x16, 0x18):
        return DECODE_ABORT_EARLY
    length = b[0]
    if util.crc16(bytes(b[:length + 3]), length + 3, 0x8005, 0xFFFF):
        return DECODE_FAIL_MIC
    id_ = _s32((b[2] << 24) | (b[3] << 16) | (b[4] << 8) | b[5])
    ctr = (b[8] << 16) | (b[7] << 8) | b[6]
    cmac = _s32((b[9] << 24) | (b[10] << 16) | (b[11] << 8) | b[12])
    encr = "".join("%02x" % x for x in b[13:13 + (length - 12)])
    return [Event.make(
        ("model", "SimpliSafe-Gen3"),
        ("id", id_, "ID", "%08x"),
        ("msg_type", b[1], "Type", "%02x"),
        ("ctr", ctr, "Counter", "%06x"),
        ("cmac", cmac, "CMAC", "%08x"),
        ("encr", encr, "Encrypted"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("mueller_hotrod")
def mueller_hotrod(bits, dev):
    """Mueller-HotRod water meter (ref src/devices/mueller_hotrod.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 96:
        return DECODE_ABORT_LENGTH
    pos = bits.search(0, 0, bytes([0xFE, 0xB1, 0x00]), 24)
    if pos + 72 >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, pos + 24, 72))
    if (util.crc8(bytes(b[:8]), 8, 0x07, 0x00) ^ 0x55) != b[8]:
        return 0
    volume = (((b[4] & 0xF0) >> 4) * 1000000 + (b[4] & 0x0F) * 100000
              + ((b[5] & 0xF0) >> 4) * 10000 + (b[5] & 0x0F) * 1000
              + ((b[6] & 0xF0) >> 4) * 100 + (b[6] & 0x0F) * 10
              + ((b[7] & 0xF0) >> 4))
    return [Event.make(
        ("model", "Mueller-HotRod"),
        ("id", "%02x%02x%02x%02x" % tuple(b[:4])),
        ("volume_gal", volume, "Volume", "%u gal"),
        ("flag", b[7] & 0x0F, "Flag", "%x"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ecowitt")
def ecowitt(bits, dev):
    """Ecowitt-WH53 (ref src/devices/ecowitt.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    pos = bits.search(0, 0, bytes([0xF5, 0x30]), 12)
    if pos >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] - pos < 52:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, pos + 4, 48))
    if util.crc8(bytes(b[:6]), 6, 0x31, 0):
        return DECODE_FAIL_MIC
    channel = (b[2] >> 4) + 1
    if channel > 3:
        return DECODE_FAIL_SANITY
    if (b[2] & 0x0C) != 0:
        return DECODE_ABORT_EARLY
    if b[4] != 0xFF:
        return DECODE_ABORT_EARLY
    temp_c = ((((b[2] & 0x3) << 8) | b[3]) - 400) * 0.1
    return [Event.make(
        ("model", "Ecowitt-WH53"),
        ("id", b[1], "Id"),
        ("channel", channel, "Channel"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("tfa_303196")
def tfa_303196(bits, dev):
    """TFA-303196 (ref src/devices/tfa_30_3196.c)."""
    row = bits.find_repeated_row(2, 48 * 2 + 12)
    if row < 0:
        return DECODE_ABORT_EARLY
    start_pos = bits.search(row, 0, bytes([0x55, 0x56]), 16) + 12
    if bits.bits_per_row[row] - start_pos < 96:
        return DECODE_ABORT_LENGTH
    databits = BitBuffer()
    bits.manchester_decode(row, start_pos, databits, 48)
    if databits.bits_per_row[0] < 48:
        return DECODE_ABORT_LENGTH
    b = _ints(databits.bb[0])
    if b[0] != 0xA8:
        return DECODE_FAIL_SANITY
    digest = (b[4] << 8) | b[5]
    chk = util.lfsr_digest16(bytes(b[:4]), 4, 0x8810, 0x22D0) ^ digest
    temp_c = ((((b[1] & 0x0F) << 8) | b[2]) - 400) * 0.1
    return [Event.make(
        ("model", "TFA-303196"),
        ("id", chk),
        ("channel", (b[1] >> 4) + 1, "Channel"),
        ("battery_ok", int(not (b[3] >> 7)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", b[3] & 0x7F, "Humidity", "%u %%"),
        ("mic", "missing", "Integrity"),
    )]


@decoder("oil_watchman")
def oil_watchman(bits, dev):
    """Oil-SonicSmart / Watchman Sonic (ref src/devices/oil_watchman.c)."""
    out = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, bytes([0xE0]), 6)
        if bitpos + 136 > bits.bits_per_row[0]:
            break
        bitpos += 6
        databits = BitBuffer()
        bitpos = bits.manchester_decode(0, bitpos, databits, 64)
        if databits.bits_per_row[0] != 64:
            continue
        b = _ints(databits.bb[0])
        post = bytes([0x00 if (b[7] & 1) == 0 else 0xC0])
        if bits.search(0, bitpos, post, 2) != bitpos:
            continue
        if b[7] != util.crc8le(bytes(b[:7]), 7, 0x31, 0):
            continue
        unit_id = _s32((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3])
        flags = b[4]
        maybetemp = b[5] >> 2
        temperature = (145.0 - 5.0 * maybetemp) / 3.0
        depth = 0
        binding_countdown = 0
        if flags & 1:
            binding_countdown = b[6]
        else:
            depth = ((b[5] & 3) << 8) | b[6]
        out.append(Event.make(
            ("model", "Oil-SonicSmart"),
            ("id", unit_id, "", "%06x"),
            ("flags", flags, "", "%02x"),
            ("maybetemp", maybetemp),
            ("temperature_C", temperature, "", "%.1f C"),
            ("binding_countdown", binding_countdown),
            ("depth_cm", depth),
        ))
    return out


@decoder("efergy_e2_classic")
def efergy_e2_classic(bits, dev):
    """Efergy-e2CT (ref src/devices/efergy_e2_classic.c)."""
    n = bits.bits_per_row[0]
    b = _ints(bits.bb[0])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if n < 64 or n > 65:
        return DECODE_ABORT_LENGTH
    if (b[0] & 0xF0) != 0xF0 and (b[0] & 0xF0) != 0x00:
        return DECODE_ABORT_EARLY
    if b[0] & 0xF0:
        b = [~x & 0xFF for x in b]
    if sum(1 for i in range(8) if b[i] == 0) > 5:
        return DECODE_FAIL_SANITY
    checksum = sum(b[:7])
    if checksum == 0:
        return DECODE_FAIL_SANITY
    if (checksum & 0xFF) != b[7]:
        return DECODE_FAIL_MIC
    fact = (-(b[6] if b[6] < 128 else b[6] - 256) + 15) & 0xFF
    if fact < 7 or fact > 23:
        return DECODE_FAIL_SANITY
    current_adc = ((b[4] << 8) | b[5]) / (1 << fact)
    return [Event.make(
        ("model", "Efergy-e2CT"),
        ("id", (b[2] << 8) | b[1], "Transmitter ID"),
        ("battery_ok", int(bool((b[3] & 0x40) >> 6)), "Battery"),
        ("current", current_adc, "Current", "%.2f A"),
        ("interval", (((b[3] & 0x30) >> 4) + 1) * 6, "Interval", "%ds"),
        ("learn", "YES" if (b[3] & 0x80) else "NO", "Learning"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("maverick_xr30")
def maverick_xr30(bits, dev):
    """Maverick-XR30 BBQ (ref src/devices/maverick_xr30.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 104:
        return DECODE_ABORT_LENGTH
    first = int(bits.bb[0][0])
    if first == 0x55:
        b = _ints(bits.extract_bytes(0, 7, 96))
    elif first == 0xAA:
        b = _ints(bits.extract_bytes(0, 8, 96))
    else:
        return DECODE_ABORT_EARLY
    if b[0] != 0xAA or b[1] != 0xAA or b[2] != 0xAA or b[3] != 0xD3 \
            or b[4] != 0x91 or b[5] != 0xD3 or b[6] != 0x91:
        return DECODE_ABORT_EARLY
    flags = (b[7] & 0xF0) >> 4
    temp1 = ((b[7] & 0x0F) << 6) | ((b[8] & 0xFC) >> 2)
    temp2 = ((b[8] & 0x03) << 8) | b[9]
    digest = (b[10] << 8) | b[11]
    status = {0: "default", 5: "init"}.get(flags, "unknown")
    id_ = util.lfsr_digest16(bytes(b[7:10]), 3, 0x8810, 0x0D42) ^ digest
    return [Event.make(
        ("model", "Maverick-XR30"),
        ("id", id_, "Session_ID"),
        ("status", status, "Status"),
        ("temperature_1_C", temp1 - 532.0, "TemperatureSensor1", "%.2f C"),
        ("temperature_2_C", temp2 - 532.0, "TemperatureSensor2", "%.2f C"),
    )]


@decoder("fineoffset_wh55")
def fineoffset_wh55(bits, dev):
    """Fineoffset-WH55 water leak (ref src/devices/fineoffset_wh55.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    bitpos = bits.search(0, 0, bytes([0xAA, 0x2D, 0xD4, 0x55]), 32) + 24
    if bitpos + 72 > bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, bitpos, 96))
    b = (b + [0] * 12)[:12]
    if util.crc8(bytes(b[:9]), 9, 0x31, 0x00):
        return 0
    return [Event.make(
        ("model", "Fineoffset-WH55"),
        ("id", (b[2] << 8) | b[3], "ID", "%05X"),
        ("channel", (b[1] >> 4) + 1, "Channel"),
        ("battery_ok", b[4] * 0.2, "Battery level"),
        ("raw_value", (b[5] << 8) | b[6], "Raw Value"),
        ("sensitivity", (b[7] >> 7) & 1, "Sensitivity"),
        ("alarm", (b[7] >> 6) & 1, "Alarm"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("lacrosse_tx34")
def lacrosse_tx34(bits, dev):
    """LaCrosse-TX34IT rain gauge (ref src/devices/lacrosse_tx34.c)."""
    out = []
    for row in range(bits.num_rows):
        start_pos = bits.search(row, 0, bytes([0xA2, 0xDD, 0x40]), 20) + 20
        if start_pos + 40 > bits.bits_per_row[row]:
            continue
        b = _ints(bits.extract_bytes(row, start_pos, 40))
        if b[4] != util.crc8(bytes(b[:4]), 4, 0x31, 0x00):
            continue
        if ((b[0] & 0xF0) >> 4) != 5:
            continue
        rain_tick = (b[2] << 8) | b[3]
        out.append(Event.make(
            ("model", "LaCrosse-TX34IT"),
            ("id", ((b[0] & 0x0F) << 2) | (b[1] >> 6)),
            ("battery_ok", int(not ((b[1] & 0x10) >> 4)), "Battery"),
            ("newbattery", (b[1] & 0x20) >> 5, "New battery"),
            ("rain_mm", rain_tick * 0.222, "Total rain", "%.1f mm"),
            ("rain_raw", rain_tick, "Raw rain"),
            ("mic", "CRC", "Integrity"),
        ))
    return out


@decoder("cardin")
def cardin(bits, dev):
    """Cardin-S466 gate remote (ref src/devices/cardin.c)."""
    if bits.bits_per_row[0] != 24:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    if (b[2] & 0x3F) not in (0x03, 0x09, 0x0C, 0x06):
        return DECODE_ABORT_EARLY
    for mask in (8, 16, 32, 64, 128, 1, 2, 4):
        if (b[0] & mask) == 0 and (b[1] & mask) != 0:
            return DECODE_ABORT_EARLY
    if (b[2] & 128) == 0 and (b[2] & 64) != 0:
        return DECODE_ABORT_EARLY
    button = ["11R", "10R", "01R", "00L?"][((b[2] & 0x0F) // 3) - 1]
    dip = list("---------")
    order = [8, 16, 32, 64, 128]
    for i, mask in enumerate(order):
        if b[0] & mask:
            dip[i] = "+" if (b[1] & mask) else "o"
    if b[2] & 128:
        dip[5] = "+" if (b[2] & 64) else "o"
    for i, mask in enumerate((1, 2, 4)):
        if b[0] & mask:
            dip[6 + i] = "+" if (b[1] & mask) else "o"
    return [Event.make(
        ("model", "Cardin-S466"),
        ("dipswitch", "".join(dip), "dipswitch"),
        ("rbutton", button, "right button switches"),
    )]

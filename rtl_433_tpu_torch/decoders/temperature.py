"""OOK PPM temperature/humidity sensor decoders (batch 1).

Each decoder reproduces the field layout, integrity check and output
contract of the corresponding reference decoder (cited per function).
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _ints(b):
    return [int(x) for x in b]


@decoder("gt_wt_02")
def gt_wt_02(bits, dev):
    """GT-WT-02 (ref src/devices/gt_wt_02.c:44-141): 37-bit rows (or 39 with
    2 lead bits), nibble-sum-mod-64 checksum, first decodable row wins."""
    if bits.num_rows < 2:
        return DECODE_ABORT_LENGTH
    for row in range(bits.num_rows):
        n = bits.bits_per_row[row]
        if n == 39:
            b = _ints(bits.extract_bytes(row, 2, 37))
        elif n == 37:
            b = _ints(bits.bb[row])
        else:
            continue
        if not any(b[:5]):
            continue
        sum_nibbles = ((b[0] >> 4) + (b[0] & 0xF) + (b[1] >> 4) + (b[1] & 0xF)
                       + (b[2] >> 4) + (b[2] & 0xF) + (b[3] >> 4)
                       + (b[3] & 0xE))
        checksum = ((b[3] & 1) << 5) + (b[4] >> 3)
        if (sum_nibbles & 0x3F) != checksum:
            continue
        sensor_id = b[0]
        battery_low = (b[1] >> 7) & 1
        button = (b[1] >> 6) & 1
        channel = (b[1] >> 4) & 3
        temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
        if channel > 2:
            continue
        if temp_c < -20.0 or temp_c > 60.0:
            continue
        hum_raw = b[3] >> 1
        if hum_raw != 10 and hum_raw != 110 and (hum_raw < 20 or hum_raw > 90):
            continue
        humidity = 0 if hum_raw == 10 else (100 if hum_raw == 110 else hum_raw)
        return [Event.make(
            ("model", "GT-WT02"),
            ("id", sensor_id, "ID Code"),
            ("channel", channel + 1, "Channel"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temp_c, "Temperature", "%.1f C"),
            ("humidity", float(humidity), "Humidity", "%.0f %%"),
            ("button", button, "Button "),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return 0


def _crc4_xor_check(b):
    """CRC-4 poly 0x3 init 0 over 4 bytes, XOR next nibble (shared by
    s3318p/kedsum/esperanza, ref src/devices/s3318p.c:85-88)."""
    return (util.crc4(bytes(b[:4]), 4, 0x3, 0x0) ^ (b[4] >> 4)) == (b[4] & 0xF)


@decoder("s3318p")
def s3318p(bits, dev):
    """Conrad S3318P (ref src/devices/s3318p.c:60-116): 42-bit rows x4,
    2 lead bits, CRC-4, temperature in tenth-degrees F offset 90."""
    if bits.bits_per_row[0] == 0 and bits.num_rows > 1 \
            and bits.bits_per_row[1] == 0:
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(4, 42)
    if r < 0 or bits.bits_per_row[r] != 42:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(r, 2, 40))
    if not any(b[:4]):
        return DECODE_FAIL_SANITY
    if not _crc4_xor_check(b):
        return DECODE_FAIL_MIC
    temp_raw = ((b[2] & 0x0F) << 8) | (b[2] & 0xF0) | (b[1] & 0x0F)
    humidity = ((b[3] & 0x0F) << 4) | ((b[3] & 0xF0) >> 4)
    return [Event.make(
        ("model", "Conrad-S3318P"),
        ("id", b[0], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int(not ((b[4] & 0x40) >> 6)), "Battery"),
        ("temperature_F", (temp_raw - 900) * 0.1, "Temperature", "%.2f F"),
        ("humidity", humidity, "Humidity", "%u %%") if humidity != 0 else None,
        ("button", b[4] >> 7, "Button"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("kedsum")
def kedsum(bits, dev):
    """Kedsum-TH (ref src/devices/kedsum.c:36-95): 5 leading empty sync
    rows, 42-bit rows x4, CRC-4, battery level 0/10/100%."""
    if bits.num_rows < 5 or any(bits.bits_per_row[i] != 0 for i in range(5)):
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(4, 42)
    if r < 0 or bits.bits_per_row[r] != 42:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(r, 2, 40))
    if not _crc4_xor_check(b):
        return DECODE_FAIL_MIC
    battery = b[1] >> 6
    battery = 100 if battery == 2 else battery * 10
    temp_raw = ((b[2] & 0x0F) << 8) | (b[2] & 0xF0) | (b[1] & 0x0F)
    flags = (b[1] & 0xC0) | (b[4] >> 4)
    return [Event.make(
        ("model", "Kedsum-TH"),
        ("id", b[0], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", battery * 0.01, "Battery level"),
        ("flags", flags, "Flags2"),
        ("temperature_F", (temp_raw - 900) * 0.1, "Temperature", "%.2f F"),
        ("humidity", ((b[3] & 0x0F) << 4) | ((b[3] & 0xF0) >> 4),
         "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("esperanza_ews")
def esperanza_ews(bits, dev):
    """Esperanza EWS (ref src/devices/esperanza_ews.c:62-110): exactly 14
    rows alternating empty/42-bit, identical payloads, CRC-4."""
    if bits.bits_per_row[0] != 0 or bits.num_rows < 2 \
            or bits.bits_per_row[1] != 0:
        return DECODE_FAIL_SANITY
    if bits.num_rows != 14:
        return DECODE_ABORT_LENGTH
    for row in range(2, bits.num_rows - 3, 2):
        if bits.bits_per_row[row] != 42 \
                or not (bits.bb[row] == bits.bb[row + 2]).all():
            return DECODE_FAIL_SANITY
    b = _ints(bits.extract_bytes(2, 2, 40))
    if not _crc4_xor_check(b):
        return DECODE_FAIL_MIC
    temp_raw = ((b[2] & 0x0F) << 8) | (b[2] & 0xF0) | (b[1] & 0x0F)
    return [Event.make(
        ("model", "Esperanza-EWS"),
        ("id", b[0], "ID"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int((b[4] & 0x40) != 0x40), "Battery"),
        ("temperature_F", (temp_raw - 900) * 0.1, "Temperature", "%.2f F"),
        ("humidity", ((b[3] & 0x0F) << 4) | ((b[3] & 0xF0) >> 4),
         "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("solight_te44")
def solight_te44(bits, dev):
    """Solight TE44 (ref src/devices/solight_te44.c:41-91): Rubicson layout
    with battery unused; 37-bit rows x3, CRC-8 poly 0x31 init 0x6c."""
    r = bits.find_repeated_row(3, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[r])
    if bits.bits_per_row[r] != 37:
        return DECODE_ABORT_LENGTH
    if (b[3] & 0xF0) != 0xF0:
        return DECODE_ABORT_EARLY
    tmp = bytes([b[0], b[1], b[2], b[3] & 0xF0,
                 ((b[3] & 0x0F) << 4) | ((b[4] & 0xF0) >> 4)])
    if util.crc8(tmp, 5, 0x31, 0x6C):
        return DECODE_FAIL_MIC
    temp_c = (_s16((b[1] << 12) | (b[2] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Solight-TE44"),
        ("id", b[0], "Id"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("auriol_afw2a1")
def auriol_afw2a1(bits, dev):
    """Auriol AFW2A1 (ref src/devices/auriol_afw2a1.c:55-115): 36-bit rows
    x12, fixed 0xa nibble, range sanity only (no MIC)."""
    row = bits.find_repeated_row(12, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
    if (b[3] >> 4) != 0xA:
        return DECODE_FAIL_SANITY
    humidity = ((b[3] & 0x0F) << 4) | (b[4] >> 4)
    if humidity > 0x64 or temp_c < -51.1 or temp_c > 76.7:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Auriol-AFW2A1"),
        ("id", b[0]),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", b[1] >> 7, "Battery"),
        ("button", (b[1] & 0x40) >> 6, "Button"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", float(humidity), "Humidity", "%.0f %%"),
    )]


@decoder("auriol_ahfl")
def auriol_ahfl(bits, dev):
    """Auriol AHFL (ref src/devices/auriol_ahfl.c:30-100): 42-bit rows x2,
    fixed 0x4 nibble, 6-bit nibble-sum checksum."""
    row = bits.find_repeated_row(2, 42)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 42:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if (b[4] & 0xF0) != 0x40 or (b[3] & 0x1) != 0x0:
        return DECODE_FAIL_SANITY
    nibble_sum = sum((b[i] & 0xF) + (b[i] >> 4) for i in range(4)) + (b[4] >> 4)
    checksum = ((b[4] & 0xF) << 2) | ((b[5] & 0xC0) >> 6)
    if (nibble_sum & 0x3F) != checksum:
        return DECODE_FAIL_MIC
    temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
    return [Event.make(
        ("model", "Auriol-AHFL"),
        ("id", b[0]),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", b[1] >> 7, "Battery"),
        ("button", (b[1] & 0x40) >> 6, "Button"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("humidity", b[3] >> 1, "Humidity", "%d %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("infactory")
def infactory(bits, dev):
    """inFactory-TH (ref src/devices/infactory.c:55-116): 40/41/42-bit row 0,
    CRC-4 poly 0x13 with channel/CRC nibble swap, BCD humidity."""
    if bits.bits_per_row[0] not in (40, 41, 42):
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    channel = b[4] & 0x03
    if not channel:
        return DECODE_ABORT_EARLY
    msg = bytes([b[0], (b[1] & 0x0F) | ((b[4] & 0x0F) << 4), b[2], b[3]])
    crc = util.crc4(msg, 4, 0x13, 0) ^ (b[4] >> 4)
    if crc != (b[1] >> 4):
        return DECODE_FAIL_MIC
    humidity = (b[3] & 0x0F) * 10 + (b[4] >> 4)
    if humidity > 100:
        return DECODE_FAIL_SANITY
    temp_raw = (b[2] << 4) | (b[3] >> 4)
    return [Event.make(
        ("model", "inFactory-TH"),
        ("id", b[0], "ID"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(not ((b[1] >> 2) & 1)), "Battery"),
        ("button", (b[1] >> 3) & 1, "Button"),
        ("temperature_F", (temp_raw - 900) * 0.1, "Temperature", "%.2f F"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("springfield")
def springfield(bits, dev):
    """Springfield-Soil (ref src/devices/springfield.c:33-107): 36/37-bit
    rows x3, XOR-nibble checksum, temperature + moisture level."""
    row = bits.find_repeated_row(3, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] not in (36, 37):
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    word = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    if word in (0xFFFFFFFF, 0):
        return DECODE_ABORT_EARLY
    chk = util.xor_bytes(bytes(b[:4]), 4)
    if ((chk >> 4) ^ (chk & 0x0F)) != 0:
        return DECODE_FAIL_MIC
    battery = (b[1] >> 7) & 1
    button = (b[1] >> 6) & 1
    temp_c = (_s16(((b[1] & 0x0F) << 12) | (b[2] << 4)) >> 4) * 0.1
    moisture = (b[3] >> 4) * 10
    if temp_c < -30 or temp_c > 70:
        return DECODE_FAIL_SANITY
    if moisture > 100:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Springfield-Soil"),
        ("id", b[0], "SID"),
        ("channel", ((b[1] >> 4) & 0x03) + 1, "Channel"),
        ("battery_ok", int(not battery), "Battery"),
        ("transmit", "MANUAL" if button else "AUTO", "Transmit"),
        ("temperature_C", temp_c, "Temperature", "%.1f C"),
        ("moisture", moisture, "Moisture", "%d %%"),
        ("button", button, "Button"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("tfa_pool_thermometer")
def tfa_pool_thermometer(bits, dev):
    """TFA-Pool (ref src/devices/tfa_pool_thermometer.c:30-80): 28-bit rows
    x7, nibble-sum-minus-1 checksum in the first nibble."""
    row = bits.find_repeated_row(7, 28)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 28:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    checksum_rx = (b[0] & 0xF0) >> 4
    checksum = ((b[0] & 0x0F) + (b[1] >> 4) + (b[1] & 0x0F)
                + (b[2] >> 4) + (b[2] & 0x0F) + (b[3] >> 4) - 1)
    if checksum_rx != (checksum & 0x0F):
        return DECODE_FAIL_MIC
    device = ((b[0] & 0x0F) << 4) | ((b[1] & 0xF0) >> 4)
    temp_raw = ((b[1] & 0x0F) << 8) | b[2]
    temp_f = (temp_raw - 4096 if temp_raw > 2048 else temp_raw) * 0.1
    return [Event.make(
        ("model", "TFA-Pool"),
        ("id", device, "Id"),
        ("channel", (b[3] & 0xC0) >> 6, "Channel"),
        ("battery_ok", (b[3] & 0x20) >> 5, "Battery"),
        ("temperature_C", temp_f, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("thermopro_tp11")
def thermopro_tp11(bits, dev):
    """Thermopro-TP11 (ref src/devices/thermopro_tp11.c:22-60): 32/33-bit
    rows x2, reflected LFSR-8 digest gen 0x51 key 0x04."""
    row = bits.find_repeated_row(2, 32)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    if bits.bits_per_row[row] > 33:
        return DECODE_ABORT_LENGTH
    if util.lfsr_digest8_reflect(bytes(b[:3]), 3, 0x51, 0x04) != b[3]:
        return DECODE_FAIL_MIC
    if all(x == 0 for x in b[:4]) or all(x == 0xFF for x in b[:4]):
        return DECODE_FAIL_SANITY
    device = (b[0] << 4) | (b[1] >> 4)
    temp_raw = ((b[1] & 0x0F) << 8) | b[2]
    return [Event.make(
        ("model", "Thermopro-TP11"),
        ("id", device, "Id"),
        ("temperature_C", (temp_raw - 200) * 0.1, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("thermopro_tp12")
def thermopro_tp12(bits, dev):
    """Thermopro-TP12 (ref src/devices/thermopro_tp12.c:46-106): 41-bit
    repeated-prefix rows, reflected LFSR-8 digest, two probe channels."""
    row = bits.find_repeated_prefix(5 if bits.num_rows > 5 else 2, 40)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    if not any(b[:4]):
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 41:
        return DECODE_ABORT_LENGTH
    if util.lfsr_digest8_reflect(bytes(b[:4]), 4, 0x51, 0x04) != b[4]:
        return DECODE_FAIL_MIC
    temp1_raw = ((b[2] & 0xF0) << 4) | b[1]
    temp2_raw = ((b[2] & 0x0F) << 8) | b[3]
    return [Event.make(
        ("model", "Thermopro-TP12"),
        ("id", b[0], "Id"),
        ("temperature_1_C", (temp1_raw - 200) * 0.1,
         "Temperature 1 (Food)", "%.1f C"),
        ("temperature_2_C", (temp2_raw - 200) * 0.1,
         "Temperature 2 (Barbecue)", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("wssensor")
def wssensor(bits, dev):
    """Hyundai-WS (ref src/devices/wssensor.c:30-92): 24-bit rows x4,
    no MIC, signed temperature in the first 12 bits."""
    r = bits.find_repeated_row(4, 23)
    if r < 0 or bits.bits_per_row[r] != 24:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if all(x == 0 for x in b[:3]) or all(x == 0xFF for x in b[:3]):
        return DECODE_FAIL_SANITY
    temp_c = (_s16((b[0] << 8) | (b[1] & 0xF0)) >> 4) * 0.1
    return [Event.make(
        ("model", "Hyundai-WS"),
        ("id", b[2], "House Code"),
        ("channel", (b[1] & 0x03) + 1, "Channel"),
        ("battery_ok", (b[1] & 0x08) >> 3, "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
        ("button", (b[1] & 0x04) >> 2, "Button"),
    )]


@decoder("generic_temperature_sensor")
def generic_temperature_sensor(bits, dev):
    """Generic-Temperature (ref src/devices/generic_temperature_sensor.c:
    22-62): rows 1-9 must be 24 bits, no MIC."""
    for i in range(1, 10):
        if i >= bits.num_rows or bits.bits_per_row[i] != 24:
            return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[1])
    if all(x == 0 for x in b[:3]) or all(x == 0xFF for x in b[:3]):
        return DECODE_ABORT_EARLY
    temp_raw = _s16(((b[1] & 0x3F) << 10) | (b[2] << 2))
    return [Event.make(
        ("model", "Generic-Temperature"),
        ("id", b[0], "Id"),
        ("battery_ok", (b[1] & 0xC0) >> 6, "Battery?"),
        ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature", "%.2f C"),
    )]

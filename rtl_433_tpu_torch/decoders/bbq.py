"""BBQ / meat-thermometer family decoders (reference files cited per
function): ThermoPro TX-2C/TP28b/TP828B/TP829B/TX-7B/TP86xB/TP211B,
Burnhard BBQ, Maverick XR-50, Typhur Sync Gold.
"""

from __future__ import annotations

from ..bits import util
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


@decoder("thermopro_tx2c")
def thermopro_tx2c(bits, dev):
    """ThermoPro TX-2C thermo/hygro (ref src/devices/thermopro_tx2c.c)."""
    row = bits.find_repeated_row(4, 36)
    if row < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[row])
    if bits.bits_per_row[row] > 45:
        return DECODE_ABORT_LENGTH
    if (b[0] == 0 and b[1] == 0 and b[2] == 0 and b[3] == 0) or (
            b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF and b[3] == 0xFF):
        return DECODE_FAIL_SANITY
    if (b[4] & 0x0F) != 0x00 or b[5] != 0x00:
        return DECODE_FAIL_SANITY
    temp_raw = _s16((b[2] << 8) | b[3])
    humidity = ((b[3] & 0xF) << 4) | (b[4] >> 4)
    return [Event.make(
        ("model", "Thermopro-TX2C"),
        ("id", ((b[0] & 0xF) << 4) | (b[1] >> 4), "Id"),
        ("channel", (b[1] & 0x03) + 1, "Channel"),
        ("battery_ok", int(not ((b[1] & 0x08) >> 3)), "Battery"),
        ("temperature_C", (temp_raw >> 4) * 0.1, "Temperature", "%.1f C"),
        ("humidity", humidity, "Humidity", "%u %%") if humidity != 0x0A
        else None,
        ("button", (b[1] & 0x04) >> 2, "Button"),
    )]


def _bcd2float(lo, hi):
    return (((hi & 0xF0) >> 4) * 100.0 + (hi & 0x0F) * 10.0
            + ((lo & 0xF0) >> 4) * 1.0 + (lo & 0x0F) * 0.1)


@decoder("thermopro_tp28b")
def thermopro_tp28b(bits, dev):
    """ThermoPro TP28b meat thermometer (ref src/devices/thermopro_tp28b.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len < 240 or msg_len > 451:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xD2, 0xAA, 0x2D, 0xD4]), 32)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    b = _ints(bits.extract_bytes(0, offset + 32, 18 * 8))
    if ((util.add_bytes(bytes(b[:16])) & 0xFF) - b[16]) != 0:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "ThermoPro-TP28b"),
        ("id", b[15] | (b[14] << 8), "", "%04x"),
        ("temperature_1_C", _bcd2float(b[0], b[1]), "Temperature 1",
         "%.1f C"),
        ("alarm_high_1_C", _bcd2float(b[2], b[3]),
         "Temperature 1 alarm high", "%.1f C"),
        ("alarm_low_1_C", _bcd2float(b[4], b[5]),
         "Temperature 1 alarm low", "%.1f C"),
        ("temperature_2_C", _bcd2float(b[6], b[7]), "Temperature 2",
         "%.1f C"),
        ("alarm_high_2_C", _bcd2float(b[8], b[9]),
         "Temperature 2 alarm high", "%.1f C"),
        ("alarm_low_2_C", _bcd2float(b[10], b[11]),
         "Temperature 2 alarm low", "%.1f C"),
        ("flags", b[13] | (b[12] << 8), "Status flags", "%04x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("thermopro_tp828b")
def thermopro_tp828b(bits, dev):
    """ThermoPro TP828B 2-probe BBQ (ref src/devices/thermopro_tp82xb.c:61)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len > 280:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0x55, 0x2D, 0xD4]), 24)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    if msg_len - offset < 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset + 24, 12 * 8))
    checksum = util.lfsr_digest8(bytes(b[10::-1]), 11, 0x98, 0x16) ^ 0xAC
    if checksum != b[11]:
        return DECODE_FAIL_MIC
    display_u = (b[1] & 0xF0) >> 4
    p1_raw = (b[2] << 4) | ((b[3] & 0xF0) >> 4)
    p1_lo_raw = ((b[3] & 0x0F) << 8) | b[4]
    p1_hi_raw = (b[5] << 4) | ((b[6] & 0xF0) >> 4)
    p2_raw = ((b[6] & 0x0F) << 8) | b[7]
    p2_lo_raw = (b[8] << 4) | ((b[9] & 0xF0) >> 4)
    p2_hi_raw = ((b[9] & 0x0F) << 8) | b[10]
    return [Event.make(
        ("model", "ThermoPro-TP828b"),
        ("id", b[0], "", "%02x"),
        ("display_u", "Fahrenheit", "Display Unit") if display_u == 0x2
        else (("display_u", "Celsius", "Display Unit") if display_u == 0x0
              else None),
        ("temperature_1_C", (p1_raw - 500) * 0.1, "Temperature 1", "%.1f C")
        if p1_raw != 0xEDD else None,
        ("temperature_1_LO_C", (p1_lo_raw - 500) * 0.1, "Temperature 1 LO",
         "%.1f C") if p1_lo_raw != 0xEAA else None,
        ("temperature_1_HI_C", (p1_hi_raw - 500) * 0.1, "Temperature 1 HI",
         "%.1f C"),
        ("temperature_2_C", (p2_raw - 500) * 0.1, "Temperature 2", "%.1f C")
        if p2_raw != 0xEDD else None,
        ("temperature_2_LO_C", (p2_lo_raw - 500) * 0.1, "Temperature 2 LO",
         "%.1f C") if p2_lo_raw != 0xEAA else None,
        ("temperature_2_HI_C", (p2_hi_raw - 500) * 0.1, "Temperature 2 HI",
         "%.1f C"),
        ("flags", b[1] & 0xF, "Flags", "%01x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("thermopro_tp829b")
def thermopro_tp829b(bits, dev):
    """ThermoPro TP829B 4-probe BBQ (ref src/devices/thermopro_tp82xb.c:186)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len > 260:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0x55, 0x2D, 0xD4]), 24)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    if msg_len - offset < 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset + 24, 9 * 8))
    # exclude conflict with ThermoPro TX-7B (ref upstream rtl_433 #3306)
    if b[5] == 0xAA and b[6] == 0x55 and b[7] == 0xAA and b[8] == 0:
        return DECODE_ABORT_EARLY
    if util.lfsr_digest8(bytes(b[7::-1]), 8, 0x98, 0x55) != b[8]:
        return DECODE_FAIL_MIC
    display_u = (b[1] & 0xF0) >> 4
    raws = [(b[2] << 4) | ((b[3] & 0xF0) >> 4),
            ((b[3] & 0x0F) << 8) | b[4],
            (b[5] << 4) | ((b[6] & 0xF0) >> 4),
            ((b[6] & 0x0F) << 8) | b[7]]
    return [Event.make(
        ("model", "ThermoPro-TP829b"),
        ("id", b[0], "", "%02x"),
        ("display_u", "Fahrenheit", "Display Unit") if display_u == 0x2
        else (("display_u", "Celsius", "Display Unit") if display_u == 0x0
              else None),
        *[(f"temperature_{i + 1}_C", (raws[i] - 500) * 0.1,
           f"Temperature {i + 1}", "%.1f C") if raws[i] != 0xEDD else None
          for i in range(4)],
        ("flags", b[1] & 0xF, "Flags", "%01x"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("thermopro_tx7b")
def thermopro_tx7b(bits, dev):
    """ThermoPro TX-7B thermo/hygro (ref src/devices/thermopro_tx7b.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len > 260:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0x55, 0x2D, 0xD4]), 24)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    if msg_len - offset < 96:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset + 24, 9 * 8))
    if util.lfsr_digest8_reverse(bytes(b[:8]), 8, 0x98, 0x25) != b[8]:
        return DECODE_FAIL_MIC
    temp_raw = (b[2] << 4) | ((b[3] & 0xF0) >> 4)
    return [Event.make(
        ("model", "ThermoPro-TX7B"),
        ("id", b[0], "", "%02x"),
        ("battery_ok", int(not (b[1] >> 7)), "Battery"),
        ("button", (b[1] & 0x40) >> 6, "Button"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("flags", b[1] & 0xF, "Flags", "%04b"),
        ("temperature_C", (temp_raw - 400) * 0.1, "Temperature", "%.1f C"),
        ("humidity", b[4], "Humidity", "%d %%"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


@decoder("thermopro_tp86xb")
def thermopro_tp86xb(bits, dev):
    """ThermoPro TempSpike XR TP862b/TP863b
    (ref src/devices/thermopro_tp86xb.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len < 165 or msg_len > 173:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, bytes([0xD2, 0x55, 0x2D, 0xD4]), 32)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    offset += 32
    if msg_len - offset < 72:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset, 9 * 8))
    if (b[7] & b[8]) != 0:
        return DECODE_FAIL_MIC
    if (util.crc8(bytes(b[:7]), 7, 0x07, 0x00) ^ 0xDB) != b[7]:
        return DECODE_FAIL_MIC
    internal_raw = (b[2] << 4) | (b[3] >> 4)
    ambient_raw = ((b[3] & 0x0F) << 8) | b[4]
    is_probe = int((b[6] & 0x0C) == 0x0C)
    is_booster = int((b[5] & 0xC0) == 0xC0)
    is_docked = (b[1] & 0x40) >> 6
    return [Event.make(
        ("model", "ThermoPro-TempSpikeXR"),
        ("id", b[0], "", "%02x"),
        ("color", "white" if (b[1] & 0x10) else "black", "Color"),
        ("is_docked", is_docked, "Is Docked") if is_docked else None,
        ("temperature_int_C", (internal_raw - 500) * 0.1, "Internal",
         "%.1f C"),
        ("temperature_amb_C", (ambient_raw - 500) * 0.1, "Ambient",
         "%.1f C"),
        ("is_probe", is_probe, "Is Probe") if is_probe else None,
        ("is_booster", is_booster, "Is Booster") if is_booster else None,
        ("probe_batery", (b[6] & 0x30) >> 4, "Probe Battery")
        if is_probe else None,
        ("booster_battery", b[6] & 0x03, "Booster Battery")
        if is_booster else None,
        ("mic", "CRC", "Integrity"),
    )]


_TP211B_XOR = [
    0xC881, 0xC441, 0xC221, 0xC111, 0xC089, 0xC045, 0xC023, 0xC010,
    0xC01F, 0xC00E, 0x6007, 0x9002, 0x4801, 0x8401, 0xE201, 0xD101,
    0xDE01, 0xCF01, 0xC781, 0xC3C1, 0xC1E1, 0xC0F1, 0xC079, 0xC03D,
    0xC029, 0xC015, 0xC00B, 0xC004, 0x6002, 0x3001, 0xB801, 0xFC01,
    0xE801, 0xD401, 0xCA01, 0xC501, 0xC281, 0xC141, 0xC0A1, 0xC051,
    0xC061, 0xC031, 0xC019, 0xC00D, 0xC007, 0xC002, 0x6001, 0x9001,
]


def _tp211b_checksum(b):
    checksum = 0x411B
    for n in range(6):
        for i in range(8):
            if (b[n] << (i + 1)) & 0x100:
                checksum ^= _TP211B_XOR[n * 8 + i]
    return checksum


@decoder("thermopro_tp211b")
def thermopro_tp211b(bits, dev):
    """ThermoPro TP211B thermometer (ref src/devices/thermopro_tp211b.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    offset = bits.search(0, 0, bytes([0x55, 0x2D, 0xD4]), 24)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    if msg_len - offset < 64:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, offset + 24, 8 * 8))
    if b[5] != 0xAA:
        return DECODE_FAIL_SANITY
    if all(x == 0 for x in b[:5]) or all(x == 0xFF for x in b[:5]):
        return DECODE_FAIL_SANITY
    if ((b[6] << 8) | b[7]) != _tp211b_checksum(b):
        return DECODE_FAIL_MIC
    temp_raw = ((b[3] & 0x0F) << 8) | b[4]
    return [Event.make(
        ("model", "ThermoPro-TP211B"),
        ("id", (b[0] << 16) | (b[1] << 8) | b[2], "Id", "%06x"),
        ("battery_ok", int(not ((b[3] & 0x80) >> 7)), "Battery"),
        ("temperature_C", (temp_raw - 500) * 0.1, "Temperature", "%.1f C"),
        ("mic", "CHECKSUM", "Integrity"),
    )]


_BURNHARD_MEAT = ["free", "beef", "veal", "pork", "chicken", "lamb", "fish",
                  "ham"]
_BURNHARD_TASTE = ["rare", "medium rare", "medium", "medium well",
                   "well done"]


@decoder("burnhardbbq")
def burnhardbbq(bits, dev):
    """Burnhard BBQ thermometer (ref src/devices/burnhardbbq.c)."""
    bits.invert()
    ret = 0
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] < 80 or bits.bits_per_row[i] > 81:
            ret = DECODE_ABORT_LENGTH
            continue
        b = _ints(bits.bb[i])
        if b[0] == 0 and b[9] == 0:
            ret = DECODE_ABORT_EARLY
            continue
        if util.lfsr_digest8_reflect(bytes(b[:9]), 9, 0x31, 0xF4) != b[9]:
            ret = DECODE_FAIL_MIC
            continue
        setpoint_raw = ((b[7] & 0x0F) << 8) | b[6]
        temp_raw = ((b[7] & 0xF0) << 4) | b[8]
        meat = _BURNHARD_MEAT[b[5] >> 4] if (b[5] >> 4) < 8 else ""
        taste = (_BURNHARD_TASTE[b[5] & 0x0F] if (b[5] & 0x0F) < 5 else "")
        return [Event.make(
            ("model", "BurnhardBBQ"),
            ("id", b[0], "ID"),
            ("channel", b[1] & 0x07, "Channel"),
            ("temperature_C", (temp_raw - 500) * 0.1, "Temperature",
             "%.1f C") if temp_raw != 0 else None,
            ("setpoint_C", (setpoint_raw - 500) * 0.1,
             "Temperature setpoint", "%.0f C"),
            ("temperature_alarm", int((b[1] & 0x80) > 7),
             "Temperature alarm"),
            ("timer", "%02x:%02x" % (b[3], b[4] & 0x7F), "Timer"),
            ("timer_active", int((b[1] & 0x10) > 4), "Timer active"),
            ("timer_alarm", int((b[1] & 0x40) > 6), "Timer alarm"),
            ("meat", meat, "Meat") if meat else None,
            ("taste", taste, "Taste") if taste else None,
        )]
    return ret


@decoder("maverick_xr50")
def maverick_xr50(bits, dev):
    """Maverick XR-50 BBQ sensor (ref src/devices/maverick_xr50.c)."""
    if bits.num_rows > 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    start = bits.search(0, 0, bytes([0xD2, 0xAA, 0x2D, 0xD4]), 32)
    if start >= msg_len:
        return DECODE_ABORT_LENGTH
    if msg_len - start < 184:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, start + 32, 23 * 8))
    if util.crc8(bytes(b), 23, 0x31, 0x00):
        return DECODE_FAIL_MIC
    items = [
        ("model", "Maverick-XR50"),
        ("id", (b[0] << 8) | b[1], "", "%04x"),
    ]
    for p in range(4):
        o = 2 + p * 5
        flags = (b[o] & 0xF0) >> 4
        temp_raw = ((b[o] & 0x0F) << 8) | b[o + 1]
        high_raw = (b[o + 2] << 4) | ((b[o + 3] & 0xF0) >> 4)
        low_raw = ((b[o + 3] & 0x0F) << 8) | b[o + 4]
        items += [
            (f"probe_{p + 1}_flags", flags, f"Flags Probe {p + 1}", "%1x"),
            (f"temperature_{p + 1}_C", (temp_raw - 500) * 0.1,
             f"Temperature {p + 1}", "%.1f C") if temp_raw != 0 else None,
            (f"setpoint_high_{p + 1}_C", (high_raw - 500) * 0.1,
             f"Setpoint {p + 1} high", "%.1f C"),
            (f"setpoint_low_{p + 1}_C", (low_raw - 500) * 0.1,
             f"Setpoint {p + 1} low", "%.1f C"),
        ]
    items.append(("mic", "CRC", "Integrity"))
    return [Event.make(*items)]


@decoder("typhur_sync_gold")
def typhur_sync_gold(bits, dev):
    """Typhur Sync Gold meat thermometer probe
    (ref src/devices/typhur_sync_gold.c)."""
    for row in range(bits.num_rows):
        pos = bits.search(row, 0, bytes([0x57, 0x54]), 16)
        if pos >= bits.bits_per_row[row]:
            continue
        pos += 16
        if bits.bits_per_row[row] - pos < 24 * 8:
            continue
        b = _ints(bits.extract_bytes(row, pos, 24 * 8))
        if util.crc16(bytes(b[:22]), 22, 0x8005, 0x0000) != (
                (b[22] << 8) | b[23]):
            continue
        return [Event.make(
            ("model", "Typhur-SyncGold"),
            ("id", (b[0] << 16) | (b[1] << 8) | b[2], "", "%06x"),
            ("in_base", int((b[4] & 0x08) != 0), "In base"),
            ("counter", b[20] | (b[21] << 8), "Counter"),
            ("battery_V", (b[18] | (b[19] << 8)) * 0.01, "Battery",
             "%.2f V"),
            ("temperature_1_C", (b[6] | (b[7] << 8)) * 0.01, "Probe 1",
             "%.2f C"),
            ("temperature_2_C", (b[8] | (b[9] << 8)) * 0.01, "Probe 2",
             "%.2f C"),
            ("temperature_3_C", (b[10] | (b[11] << 8)) * 0.01, "Probe 3",
             "%.2f C"),
            ("temperature_4_C", (b[12] | (b[13] << 8)) * 0.01, "Probe 4",
             "%.2f C"),
            ("temperature_5_C", (b[14] | (b[15] << 8)) * 0.01, "Probe 5",
             "%.2f C"),
            ("ambient_C", (b[16] | (b[17] << 8)) * 0.1, "Ambient",
             "%.1f C"),
            ("mic", "CRC", "Integrity"),
        )]
    return DECODE_FAIL_MIC

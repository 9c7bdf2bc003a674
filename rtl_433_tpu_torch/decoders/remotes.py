"""OOK remote-control / switch / security decoders (batch 2).

Each decoder reproduces the corresponding reference decoder's behavior
(cited per function).
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


def _s16(v):
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


def _ints(b):
    return [int(x) for x in b]


def _alecto_checksum(b):
    """ref src/devices/alecto.c:79-92."""
    csum = 0
    for i in range(4):
        tmp = util.reverse8(b[i])
        csum += (tmp & 0xF) + ((tmp & 0xF0) >> 4)
    csum = (csum + 0x7) if (b[1] & 0x7F) == 0x6C else (0xF - csum)
    csum = util.reverse8((csum & 0xF) << 4)
    return csum == (b[4] >> 4)


@decoder("alectov1")
def alectov1(bits, dev):
    """AlectoV1 weather sensor family (ref src/devices/alecto.c:99-213):
    36-bit rows; temperature/humidity, rain, or wind messages."""
    if bits.bits_per_row[1] != 36:
        return DECODE_ABORT_LENGTH
    bb = [_ints(bits.bb[i]) for i in range(min(bits.num_rows, 10))]
    while len(bb) < 10:
        bb.append([0] * len(bb[0]))
    b = bb[1]
    if bb[1][0] != bb[5][0] or bb[2][0] != bb[6][0] \
            or (bb[1][4] & 0xF) != 0 or (bb[5][4] & 0xF) != 0 \
            or bb[5][0] == 0 or bb[5][1] == 0:
        return DECODE_ABORT_EARLY
    if not _alecto_checksum(bb[1]) or not _alecto_checksum(bb[5]):
        return DECODE_FAIL_MIC
    battery_low = (b[1] & 0x80) >> 7
    msg_type = (b[1] & 0x60) >> 5
    msg_rain = (b[1] & 0x0F) == 0x0C
    channel = (b[0] & 0xC) >> 2
    sensor_id = util.reverse8(b[0])
    if msg_type == 0x3 and not msg_rain:
        skip = -1
        if (b[1] & 0xE) == 0x8 and b[2] == 0:
            skip = 0
        elif (b[1] & 0xE) == 0xE:
            skip = 4
        if skip >= 0:
            speed = util.reverse8(bb[1 + skip][3])
            gust = util.reverse8(bb[5 + skip][3])
            direction = (util.reverse8(bb[5 + skip][2]) << 1) | (bb[5 + skip][1] & 0x1)
            return [Event.make(
                ("model", "AlectoV1-Wind"),
                ("id", sensor_id, "House Code"),
                ("channel", channel, "Channel"),
                ("battery_ok", int(not battery_low), "Battery"),
                ("wind_avg_m_s", speed * 0.2, "Wind speed", "%.2f m/s"),
                ("wind_max_m_s", gust * 0.2, "Wind gust", "%.2f m/s"),
                ("wind_dir_deg", direction, "Wind Direction"),
                ("mic", "CHECKSUM", "Integrity"),
            )]
    elif msg_type == 0x3 and msg_rain:
        rain_mm = ((util.reverse8(b[3]) << 8) | util.reverse8(b[2])) * 0.25
        return [Event.make(
            ("model", "AlectoV1-Rain"),
            ("id", sensor_id, "House Code"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("rain_mm", rain_mm, "Total Rain", "%.2f mm"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    elif msg_type != 0x3 \
            and bb[2][0] == bb[3][0] and bb[3][0] == bb[4][0] \
            and bb[4][0] == bb[5][0] and bb[5][0] == bb[6][0] \
            and (bb[3][4] & 0xF) == 0 and (bb[5][4] & 0xF) == 0:
        temp_raw = _s16((util.reverse8(b[1]) & 0xF0) | (util.reverse8(b[2]) << 8))
        temp_c = (temp_raw >> 4) * 0.1
        rev3 = util.reverse8(b[3])
        humidity = ((rev3 & 0xF0) >> 4) * 10 + (rev3 & 0x0F)
        if humidity > 100:
            return DECODE_FAIL_SANITY
        return [Event.make(
            ("model", "AlectoV1-Temperature"),
            ("id", sensor_id, "House Code"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(not battery_low), "Battery"),
            ("temperature_C", temp_c, "Temperature", "%.2f C"),
            ("humidity", humidity, "Humidity", "%u %%"),
            ("mic", "CHECKSUM", "Integrity"),
        )]
    return DECODE_FAIL_SANITY


@decoder("mebus433")
def mebus433(bits, dev):
    """Mebus-433 (ref src/devices/mebus.c:15-63): undocumented layout,
    row-consistency checks only."""
    if bits.num_rows < 13:
        return DECODE_ABORT_EARLY
    bb = [_ints(bits.bb[i]) for i in range(13)]
    if not (bb[0][0] == 0 and bb[1][4] != 0 and (bb[1][0] & 0x60)
            and bb[1][3] == bb[5][3] and bb[1][4] == bb[12][4]):
        return DECODE_ABORT_EARLY
    b = bb[1]
    temp = _s16((b[1] << 12) | (b[2] << 4)) >> 4
    # the reference stores humidity in an int8_t (ref src/devices/mebus.c:21)
    hum = ((b[3] << 4) | (b[4] >> 4)) & 0xFF
    if hum > 127:
        hum -= 256
    return [Event.make(
        ("model", "Mebus-433"),
        ("id", b[0] & 0x1F, "Address"),
        ("channel", ((b[1] & 0x30) >> 4) + 1, "Channel"),
        ("battery_ok", int(bool(b[1] & 0x80)), "Battery"),
        ("unknown1", (b[1] & 0x40) >> 6, "Unknown 1"),
        ("unknown2", (b[3] & 0xF0) >> 4, "Unknown 2"),
        ("temperature_C", temp * 0.1, "Temperature", "%.2f C"),
        ("humidity", hum, "Humidity", "%u %%"),
    )]


@decoder("intertechno")
def intertechno(bits, dev):
    """Intertechno-Remote (ref src/devices/intertechno.c:20-45)."""
    if bits.num_rows < 2:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[1])
    if int(bits.bb[0][0]) != 0 or (b[0] != 0x56 and b[0] != 0x69):
        return DECODE_ABORT_EARLY
    id_str = "%02x%02x%02x%02x%02x" % tuple(b[:5])
    return [Event.make(
        ("model", "Intertechno-Remote"),
        ("id", id_str),
        ("slave", b[7] & 0x0F),
        ("master", (b[7] & 0xF0) >> 4),
        ("command", b[6] & 0x07),
    )]


def _kaku_like(bits, model, with_channel, dim: bool):
    """Shared Proove/Nexa/KAKU x1527 ternary layout (ref
    src/devices/newkaku.c:28-78, proove.c:47-95, nexa.c:27-74)."""
    if bits.syncs_before_row[0] != 1:
        return DECODE_ABORT_EARLY
    n = bits.bits_per_row[0]
    if dim:
        if n != 64 and n != 72:
            return DECODE_ABORT_LENGTH
        dim_cmd = (int(bits.bb[0][6]) & 0x03) == 0x03
        if dim_cmd:
            bits.bb[0][6] = int(bits.bb[0][6]) & 0xFE
    else:
        if model == "Nexa-Security":
            if n != 64 and n != 72:
                return DECODE_ABORT_LENGTH
        elif n != 64:
            return DECODE_ABORT_LENGTH
        dim_cmd = False
    databits = BitBuffer()
    pos = bits.manchester_decode(0, 0, databits, 80)
    databits.invert()
    if dim or model == "Nexa-Security":
        if pos != 64 and pos != 72:
            return DECODE_ABORT_LENGTH
    elif databits.bits_per_row[0] < 32:
        return DECODE_ABORT_LENGTH
    b = _ints(databits.bb[0])
    id_ = (b[0] << 18) | (b[1] << 10) | (b[2] << 2) | (b[3] >> 6)
    group_cmd = (b[3] >> 5) & 1
    on_bit = (b[3] >> 4) & 1
    if dim:
        return [Event.make(
            ("model", model),
            ("id", id_),
            ("unit", b[3] & 0x0F, "Unit"),
            ("group_call", "Yes" if group_cmd else "No", "Group Call"),
            ("command", "On" if on_bit else "Off", "Command"),
            ("dim", "Yes" if dim_cmd else "No", "Dim"),
            ("dim_value", b[4] >> 4, "Dim Value"),
        )]
    channel = ((b[3] >> 2) & 0x03) ^ 0x03
    unit = (b[3] & 0x03) ^ 0x03
    return [Event.make(
        ("model", model),
        ("id", id_, "House Code"),
        ("channel", channel, "Channel"),
        ("state", "ON" if on_bit else "OFF", "State"),
        ("unit", unit, "Unit"),
        ("group", group_cmd, "Group"),
    )]


@decoder("newkaku")
def newkaku(bits, dev):
    return _kaku_like(bits, "KlikAanKlikUit-Switch", False, dim=True)


@decoder("proove")
def proove(bits, dev):
    return _kaku_like(bits, "Proove-Security", True, dim=False)


@decoder("nexa")
def nexa(bits, dev):
    return _kaku_like(bits, "Nexa-Security", True, dim=False)


@decoder("kerui")
def kerui(bits, dev):
    """Kerui-Security (ref src/devices/kerui.c:25-80): 25-bit x1527 rows
    x9, command nibble mapped to state."""
    r = bits.find_repeated_row(9, 25)
    if r < 0 or bits.bits_per_row[r] != 25:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    if not b[0] and not b[1] and not b[2]:
        return DECODE_FAIL_SANITY
    b = [~x & 0xFF for x in b]
    id_ = (b[0] << 12) | (b[1] << 4) | (b[2] >> 4)
    cmd = b[2] & 0x0F
    cmd_str = {0xA: "motion", 0xE: "open", 0x7: "close", 0xB: "tamper",
               0x5: "water", 0xF: "battery"}.get(cmd)
    if not cmd_str:
        return DECODE_ABORT_EARLY
    return [Event.make(
        ("model", "Kerui-Security"),
        ("id", id_, "ID (20bit)", "0x%x"),
        ("cmd", cmd, "Command (4bit)", "0x%x"),
        ("motion", 1) if cmd == 0xA else None,
        ("opened", 1) if cmd == 0xE else None,
        ("opened", 0) if cmd == 0x7 else None,
        ("tamper", 1) if cmd == 0xB else None,
        ("water", 1) if cmd == 0x5 else None,
        ("battery_ok", 0, "Battery") if cmd == 0xF else None,
        ("state", cmd_str, "State"),
    )]


_TRISTATE = {0x00: "0", 0x01: "Z", 0x02: "X", 0x03: "1"}


@decoder("generic_remote")
def generic_remote(bits, dev):
    """Generic-Remote SC226x/EV1527 (ref src/devices/generic_remote.c:
    17-63): 25-bit rows, tristate code output."""
    b = _ints(bits.bb[0])
    b[0] = ~b[0] & 0xFF
    b[1] = ~b[1] & 0xFF
    b[2] = ~b[2] & 0xFF
    n = bits.bits_per_row[0]
    if (n != 25 or (int(bits.bb[0][3]) & 0x80) == 0
            or (b[0] == 0 and b[1] == 0) or b[2] == 0):
        return DECODE_ABORT_LENGTH
    full = (b[0] << 16) | (b[1] << 8) | b[2]
    tristate = "".join(_TRISTATE[(full >> i) & 0x03]
                       for i in range(22, -1, -2))
    return [Event.make(
        ("model", "Generic-Remote"),
        ("id", (b[0] << 8) | b[1], "House Code"),
        ("cmd", b[2], "Command"),
        ("tristate", tristate, "Tri-State"),
    )]


@decoder("generic_motion")
def generic_motion(bits, dev):
    """Generic-Motion (ref src/devices/generic_motion.c:33-60): 20-bit
    rows repeated >=4 times, no checksum."""
    for i in range(bits.num_rows):
        b = _ints(bits.bb[i])
        if (bits.bits_per_row[i] != 20
                or (b[1] == 0 and b[2] == 0)
                or (b[1] == 0xFF and b[2] == 0xF0)
                or bits.count_repeats(i) < 3):
            continue
        code = (b[0] << 12) | (b[1] << 4) | (b[2] >> 4)
        return [Event.make(
            ("model", "Generic-Motion"),
            ("code", f"{code:05x}"),
        )]
    return DECODE_ABORT_EARLY


@decoder("ht680")
def ht680(bits, dev):
    """HT680-Remote (ref src/devices/ht680.c:16-80): 41-bit rows with
    10101 sync, tristate address + buttons."""
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 41 \
                or (int(bits.bb[row][0]) & 0xF8) != 0xA8:
            continue
        b = _ints(bits.extract_bytes(row, 5, 36))
        if ((b[1] & 0xF0) != 0xA0 or (b[2] & 0x0C) != 0x08
                or (b[3] & 0x30) != 0x20 or (b[4] & 0xF0) != 0xA0):
            continue
        # note: HT680 maps 01->'X' (invalid), 10->'Z' — the opposite of
        # generic_remote (ref src/devices/ht680.c:44-48)
        tri = []
        for byte in range(5):
            for bit in range(7, 0, -2):
                tri.append("0XZ1"[(b[byte] >> (bit - 1)) & 0x03])
        tristate = "".join(tri[:-2])
        address = (b[0] << 12) | (b[1] << 4) | (b[2] >> 4)
        return [Event.make(
            ("model", "HT680-Remote"),
            ("id", address, "Address", "0x%06X"),
            ("button1", "PRESSED" if (b[3] & 0x03) == 3 else "", "Button 1"),
            ("button2", "PRESSED" if ((b[3] >> 2) & 0x03) == 3 else "", "Button 2"),
            ("button3", "PRESSED" if ((b[3] >> 6) & 0x03) == 3 else "", "Button 3"),
            ("button4", "PRESSED" if (b[2] & 0x03) == 3 else "", "Button 4"),
            ("tristate", tristate, "Tristate code"),
        )]
    return 0


@decoder("quhwa")
def quhwa(bits, dev):
    """Quhwa-Doorbell (ref src/devices/quhwa.c:16-48)."""
    r = bits.find_repeated_row(5, 18)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = _ints(bits.bb[r])
    if not b[0] and not b[1] and not b[2]:
        return DECODE_FAIL_SANITY
    b = [~x & 0xFF for x in b]
    if (bits.bits_per_row[r] != 18 or (b[1] & 0x03) != 0x03
            or (b[2] & 0xC0) != 0xC0):
        return DECODE_ABORT_LENGTH
    return [Event.make(
        ("model", "Quhwa-Doorbell"),
        ("id", (b[0] << 8) | b[1], "ID"),
    )]


@decoder("akhan_100F14")
def akhan_100F14(bits, dev):
    """Akhan-100F14 RKE (ref src/devices/akhan_100F14.c:19-59)."""
    if bits.bits_per_row[0] != 25:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0])
    b = [~x & 0xFF for x in b]
    id_ = (b[0] << 12) | (b[1] << 4) | (b[2] >> 4)
    cmd = b[2] & 0x0F
    cmd_str = {0x1: "0x1 (Lock)", 0x2: "0x2 (Unlock)",
               0x4: "0x4 (Mute)", 0x8: "0x8 (Alarm)"}.get(cmd)
    if not cmd_str:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Akhan-100F14"),
        ("id", id_, "ID (20bit)", "0x%x"),
        ("data", cmd_str, "Data (4bit)"),
    )]


@decoder("blyss")
def blyss(bits, dev):
    """Blyss-DC5ukwh (ref src/devices/blyss.c:18-48): fixed 33-bit codes."""
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] != 33:
            continue
        b = _ints(bits.bb[i])
        if (b[:5] != [0xCE, 0x8E, 0x2A, 0x6C, 0x80]
                and b[:5] != [0xE7, 0x37, 0x7A, 0x2C, 0x80]):
            continue
        return [Event.make(
            ("model", "Blyss-DC5ukwh"),
            ("id", "%02x%02x%02x%02x" % tuple(b[:4])),
        )]
    return DECODE_FAIL_SANITY


@decoder("elro_db286a")
def elro_db286a(bits, dev):
    """Elro-DB286A doorbell (ref src/devices/elro_db286a.c:20-40)."""
    row = bits.find_repeated_row(5, 33)
    if row < 0 or bits.bits_per_row[row] != 33:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    return [Event.make(
        ("model", "Elro-DB286A"),
        ("id", "%02x%02x%02x%02x" % tuple(b[:4]), "ID"),
    )]


@decoder("smoke_gs558")
def smoke_gs558(bits, dev):
    """Smoke-GS558 (ref src/devices/smoke_gs558.c:45-105): inverted 24-bit
    reversed id/unit, learn-pattern counting."""
    if bits.num_rows < 3:
        return DECODE_ABORT_EARLY
    bits.invert()
    learn = 0
    for r in range(bits.num_rows):
        b = _ints(bits.bb[r])
        if bits.bits_per_row[r] >= 24 \
                and b[0] == 0x55 and b[1] == 0x55 and b[2] == 0x55:
            learn += 1
            bits.bits_per_row[r] = 0
        if bits.bits_per_row[r] in (26, 27) and b[3] == 0:
            bits.bits_per_row[r] = 24
    r = bits.find_repeated_row(3, 24)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[r] > 32:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[r])
    b0 = util.reverse8(b[0])
    b1 = util.reverse8(b[1])
    b2 = util.reverse8(b[2])
    unit = b0 & 0x1F
    id_ = ((b2 & 0x0F) << 11) | (b1 << 3) | (b0 >> 5)
    if id_ == 0 or id_ == 0x7FFF:
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Smoke-GS558"),
        ("id", id_),
        ("unit", unit),
        ("learn", int(learn > 1)),
        ("code", "%02x%02x%02x" % (b2, b1, b0), "Raw Code"),
    )]

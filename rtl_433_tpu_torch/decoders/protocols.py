"""Protocol decoders (first families).

Each decoder re-implements the field layout and integrity checks of the
corresponding reference decoder (cited per function); the bit-level helpers
come from the package's ``bits``. Output field order matches the reference
data_make calls so JSON events diff clean against rtl_433.
"""

from __future__ import annotations

import numpy as np

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
    """Reinterpret a 16-bit value as signed."""
    return ((int(v) & 0xFFFF) ^ 0x8000) - 0x8000


@decoder("silvercrest")
def silvercrest(bits, dev):
    """Silvercrest remote (ref src/devices/silvercrest.c:19-49): row 1 is
    33 bits 0x7c 0x26 prefix; button nibble validated via a lookup."""
    cmd_lu_tab = [2, 3, 0, 1, 4, 5, 7, 6, 0xC, 0xD, 0xF, 0xE, 8, 9, 0xB, 0xA]
    if bits.bits_per_row[1] != 33:
        return DECODE_ABORT_LENGTH
    b = bits.bb[1]
    if b[0] == 0x7C and b[1] == 0x26:
        cmd = int(b[2]) & 0xF
        if (int(b[3]) & 0xF) != cmd_lu_tab[cmd]:
            return DECODE_ABORT_EARLY
        return [Event.make(
            ("model", "Silvercrest-Remote"),
            ("button", cmd),
        )]
    return DECODE_ABORT_EARLY


@decoder("rubicson")
def rubicson(bits, dev):
    """Rubicson temperature sensor (ref src/devices/rubicson.c): 36-bit rows
    repeated 3x, nibble-7/8 CRC-8 poly 0x31 init 0x6c over restructured bytes."""
    r = bits.find_repeated_row(3, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = bits.bb[r]
    if not (36 <= bits.bits_per_row[r] <= 38):
        return DECODE_ABORT_LENGTH
    if (int(b[3]) & 0xF0) != 0xF0:
        return DECODE_ABORT_EARLY
    tmp = bytes([int(b[0]), int(b[1]), int(b[2]), int(b[3]) & 0xF0,
                 ((int(b[3]) & 0x0F) << 4) | ((int(b[4]) & 0xF0) >> 4)])
    if util.crc8(tmp, 5, 0x31, 0x6C):
        return DECODE_FAIL_MIC
    id_ = int(b[0])
    battery = int(b[1]) & 0x80
    channel = ((int(b[1]) & 0x30) >> 4) + 1
    temp_raw = _s16((int(b[1]) << 12) | (int(b[2]) << 4)) >> 4
    return [Event.make(
        ("model", "Rubicson-Temperature"),
        ("id", id_, "House Code"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(bool(battery)), "Battery"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.1f C"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("prologue")
def prologue(bits, dev):
    """Prologue/ThermoPro-TX2 sensor (ref src/devices/prologue.c)."""
    if 0 < bits.bits_per_row[0] <= 8:
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(4, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[r] > 37:
        return DECODE_ABORT_LENGTH
    b = bits.bb[r]
    if (int(b[0]) & 0xF0) != 0x90 and (int(b[0]) & 0xF0) != 0x50:
        return DECODE_FAIL_SANITY
    type_ = int(b[0]) >> 4
    id_ = ((int(b[0]) & 0x0F) << 4) | ((int(b[1]) & 0xF0) >> 4)
    battery = int(b[1]) & 0x08
    button = (int(b[1]) & 0x04) >> 2
    channel = (int(b[1]) & 0x03) + 1
    temp_raw = _s16((int(b[2]) << 8) | (int(b[3]) & 0xF0)) >> 4
    humidity = ((int(b[3]) & 0x0F) << 4) | (int(b[4]) >> 4)
    return [Event.make(
        ("model", "Prologue-TH"),
        ("subtype", type_),
        ("id", id_),
        ("channel", channel, "Channel"),
        ("battery_ok", int(bool(battery)), "Battery"),
        ("temperature_C", temp_raw * 0.1, "Temperature", "%.2f C"),
        ("humidity", humidity, "Humidity", "%u %%") if humidity != 0xCC else None,
        ("button", button, "Button"),
    )]


def _nexus_like(bits, model_th, model_t):
    """Shared Nexus layout (ref src/devices/nexus.c:44-140)."""
    r = bits.find_repeated_row(3, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = bits.bb[r]
    if bits.bits_per_row[r] > 37:
        return DECODE_ABORT_LENGTH
    if (int(b[3]) & 0xF0) != 0xF0:
        return DECODE_ABORT_EARLY
    if ((b[0] == 0 and b[2] == 0 and b[3] == 0)
            or (b[0] == 0xFF and b[2] == 0xFF and b[3] == 0xFF)):
        return DECODE_ABORT_EARLY
    if (int(b[1]) & 0x30) == 0x30:
        return DECODE_ABORT_EARLY
    # reject Rubicson-family CRC coincidence (ref src/devices/nexus.c:77-88)
    crc_in = bytes([int(b[0]), int(b[1]), int(b[2]), int(b[3]) & 0xF0,
                    ((int(b[3]) & 0x0F) << 4) | ((int(b[4]) & 0xF0) >> 4)])
    if util.crc8(crc_in, 5, 0x31, 0x6C) == 0:
        return DECODE_FAIL_SANITY
    id_ = int(b[0])
    battery = int(b[1]) & 0x80
    testmode = int(b[1]) & 0x40
    channel = ((int(b[1]) & 0x30) >> 4) + 1
    temp_raw = _s16((int(b[1]) << 12) | (int(b[2]) << 4)) >> 4
    temp_c = temp_raw * 0.1
    humidity = ((int(b[3]) & 0x0F) << 4) | (int(b[4]) >> 4)
    if humidity != 0x00 and humidity > 100:
        return DECODE_FAIL_SANITY
    if humidity == 0x00:
        return [Event.make(
            ("model", model_t),
            ("id", id_, "House Code"),
            ("channel", channel, "Channel"),
            ("battery_ok", int(bool(battery)), "Battery"),
            ("temperature_C", temp_c, "Temperature", "%.2f C"),
            ("test", int(bool(testmode)), "Test?") if testmode else None,
        )]
    return [Event.make(
        ("model", model_th),
        ("id", id_, "House Code"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(bool(battery)), "Battery"),
        ("temperature_C", temp_c, "Temperature", "%.2f C"),
        ("humidity", humidity, "Humidity", "%u %%"),
        ("test", int(bool(testmode)), "Test?") if testmode else None,
    )]


@decoder("nexus")
def nexus(bits, dev):
    """Nexus-TH/T sensor (ref src/devices/nexus.c:44-140)."""
    return _nexus_like(bits, "Nexus-TH", "Nexus-T")


@decoder("nexus_sauna")
def nexus_sauna(bits, dev):
    """Nexus sauna variant (ref src/devices/nexus.c:161-207): channel fixed
    to 4, const nibble in byte 1, 16-bit signed temperature."""
    r = bits.find_repeated_row(3, 36)
    if r < 0:
        return DECODE_ABORT_EARLY
    b = bits.bb[r]
    if bits.bits_per_row[r] > 37:
        return DECODE_ABORT_LENGTH
    if (int(b[1]) & 0x0F) != 0x0F:
        return DECODE_ABORT_EARLY
    if (b[0] == 0 or (int(b[4]) & 0x10) != 0x10
            or (b[0] == 0xFF and b[2] == 0xFF and b[3] == 0xFF)):
        return DECODE_ABORT_EARLY
    if (int(b[1]) & 0x30) != 0x30:
        return DECODE_ABORT_EARLY
    id_ = int(b[0])
    battery = int(b[1]) & 0x80
    testmode = int(b[1]) & 0x40
    channel = ((int(b[1]) & 0x30) >> 4) + 1
    temp_raw = _s16((int(b[2]) << 8) | int(b[3]))
    temp_c = temp_raw * np.float32(0.1)
    return [Event.make(
        ("model", "Nexus-Sauna"),
        ("id", id_, "House Code"),
        ("channel", channel, "Channel"),
        ("battery_ok", int(bool(battery)), "Battery"),
        ("temperature_C", float(temp_c), "Temperature", "%.1f C"),
        ("test", int(bool(testmode)), "Test?") if testmode else None,
    )]


def _lacrosse_it(bits, model29: bool):
    """LaCrosse TX29/TX35 IT sensors (ref src/devices/lacrosse_tx35.c:76-180).

    FSK PCM; preamble a2dd49 (sync 2dd4, model 9), 5 payload bytes with
    CRC-8 poly 0x31.
    """
    NOHUMID = 106
    PROBE = 125
    events = []
    preamble = bytes([0xA2, 0xDD, 0x49])
    for row in range(bits.num_rows):
        start = bits.search(row, 0, preamble, 24)
        if start >= bits.bits_per_row[row]:
            continue
        b = bits.extract_bytes(row, start + 20, 40)
        if int(b[4]) != util.crc8(b, 4, 0x31, 0x00):
            continue
        sensor_id = ((int(b[0]) & 0x0F) << 2) | (int(b[1]) >> 6)
        temp_c = (10 * (int(b[1]) & 0x0F) + ((int(b[2]) >> 4) & 0x0F)
                  + 0.1 * (int(b[2]) & 0x0F) - 40.0)
        new_batt = (int(b[1]) >> 5) & 1
        battery_low = int(b[3]) >> 7
        humidity = int(b[3]) & 0x7F
        model = "LaCrosse-TX29IT" if model29 else "LaCrosse-TX35DTHIT"
        if humidity in (NOHUMID, PROBE):
            if humidity == PROBE:
                sensor_id += 0x40
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("battery_ok", int(not battery_low), "Battery"),
                ("newbattery", new_batt, "NewBattery"),
                ("temperature_C", temp_c, "Temperature", "%.1f C"),
                ("mic", "CRC", "Integrity"),
            ))
        else:
            events.append(Event.make(
                ("model", model),
                ("id", sensor_id),
                ("battery_ok", int(not battery_low), "Battery"),
                ("newbattery", new_batt, "NewBattery"),
                ("temperature_C", temp_c, "Temperature", "%.1f C"),
                ("humidity", humidity, "Humidity", "%u %%"),
                ("mic", "CRC", "Integrity"),
            ))
    return events if events else DECODE_ABORT_EARLY


@decoder("lacrosse_tx35")
def lacrosse_tx35(bits, dev):
    return _lacrosse_it(bits, model29=False)


@decoder("lacrosse_tx29")
def lacrosse_tx29(bits, dev):
    return _lacrosse_it(bits, model29=True)


@decoder("tpms_toyota")
def tpms_toyota(bits, dev):
    """Toyota TPMS (ref src/devices/tpms_toyota.c:31-124): differential
    Manchester after a 12-bit preamble, CRC-8 poly 0x07 init 0x80."""
    preamble = bytes([0xA9, 0xE0])  # 12 bits
    events = 0
    ret = 0
    out = []
    bitpos = 0
    while True:
        bitpos = bits.search(0, bitpos, preamble, 12)
        if bitpos + 156 > bits.bits_per_row[0]:
            break
        pos = bitpos + 11
        packet = BitBuffer()
        start_pos = bits.differential_manchester_decode(0, pos, packet, 80)
        bitpos += 2
        if start_pos - pos < 144:
            continue
        b = packet.bb[0]
        if util.crc8(b, 8, 0x07, 0x80) != int(b[8]):
            continue
        id_ = (int(b[0]) << 24) | (int(b[1]) << 16) | (int(b[2]) << 8) | int(b[3])
        status = (int(b[4]) & 0x80) | (int(b[6]) & 0x7F)
        pressure1 = ((int(b[4]) & 0x7F) << 1) | (int(b[5]) >> 7)
        temp = ((int(b[5]) & 0x7F) << 1) | (int(b[6]) >> 7)
        pressure2 = int(b[7]) ^ 0xFF
        if pressure1 != pressure2:
            continue
        out.append(Event.make(
            ("model", "Toyota"),
            ("type", "TPMS"),
            ("id", f"{id_:08x}"),
            ("status", status),
            ("pressure_PSI", pressure1 * 0.25 - 7.0),
            ("temperature_C", temp - 40.0, "", "%.0f C"),
            ("mic", "CRC", "Integrity"),
        ))
        events += 1
    return out if out else ret


@decoder("waveman")
def waveman(bits, dev):
    """Waveman switch transmitter (ref src/devices/waveman.c:26-85): 25-bit
    row, every even bit set, pair-coded nibbles, state 0xe=ON/0x6=OFF."""
    if bits.bits_per_row[0] != 25:
        return DECODE_ABORT_LENGTH
    b = bits.bb[0]
    if b[0] == 0xFF and b[1] == 0xFF and b[2] == 0xFF:
        return DECODE_ABORT_EARLY
    if ((int(b[0]) & 0xAA) != 0xAA or (int(b[1]) & 0xAA) != 0xAA
            or (int(b[2]) & 0xAA) != 0xAA):
        return DECODE_FAIL_SANITY
    nb = []
    for i in range(3):
        v = int(b[i])
        nb.append((0 if v & 0x40 else 1) | (0 if v & 0x10 else 2)
                  | (0 if v & 0x04 else 4) | (0 if v & 0x01 else 8))
    if nb[2] not in (0xE, 0x6):
        return DECODE_FAIL_SANITY
    return [Event.make(
        ("model", "Waveman-Switch"),
        ("id", chr(ord('A') + nb[0])),
        ("channel", (nb[1] >> 2) + 1),
        ("button", (nb[1] & 3) + 1),
        ("state", "ON" if nb[2] == 0xE else "OFF"),
    )]

"""Security / home-automation decoders: Honeywell, DSC, X10, Interlogix,
Govee, Honeywell ActivLink (reference files cited per function)."""

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


@decoder("honeywell")
def honeywell(bits, dev):
    """Honeywell-Security door/window (ref src/devices/honeywell.c)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 120:
        return DECODE_ABORT_LENGTH
    raw_len = bits.bits_per_row[0]
    preamble = bytes([0x55, 0x55, 0x56])
    raw_pos = 0
    found = None
    while True:
        raw_pos = bits.search(0, raw_pos, preamble, 24)
        if raw_pos + 24 >= raw_len:
            break
        decoded = BitBuffer()
        bits.manchester_decode(0, raw_pos + 24, decoded, 96)
        raw_pos += 1
        if decoded.bits_per_row[0] < 48:
            continue
        b = _ints(decoded.bb[0])[:10]
        b = (b + [0] * 10)[:10]
        channel = b[0] >> 4
        device_id = ((b[0] & 0xF) << 16) | (b[1] << 8) | b[2]
        crc = (b[4] << 8) | b[5]
        if device_id == 0 and crc == 0:
            continue
        if channel in (0x2, 0x4, 0x9, 0xA, 0xC):
            crc_calc = util.crc16(bytes(b[:4]), 4, 0x8050, 0)
        else:
            crc_calc = util.crc16(bytes(b[:4]), 4, 0x8005, 0)
        if crc == crc_calc:
            found = (b, channel, device_id)
            break
    if found is None:
        return DECODE_FAIL_MIC
    b, channel, device_id = found
    event = b[3]
    contact = (event & 0x80) >> 7
    return [Event.make(
        ("model", "Honeywell-Security"),
        ("id", device_id, "", "%05x"),
        ("channel", channel),
        ("event", event, "", "%02x"),
        ("state", "open" if contact else "closed"),
        ("contact_open", contact),
        ("reed_open", (event & 0x20) >> 5),
        ("alarm", (event & 0x10) >> 4),
        ("tamper", (event & 0x40) >> 6),
        ("battery_ok", int(not ((event & 0x08) >> 3)), "Battery"),
        ("heartbeat", (event & 0x04) >> 2),
        ("mic", "CRC", "Integrity"),
    )]


def _dsc_decode(bits):
    """DSC-Security contacts (ref src/devices/dsc.c:110-230)."""
    out = []
    result = 0
    for row in range(bits.num_rows):
        n = bits.bits_per_row[row]
        if n < 48 or n > 70:
            result = DECODE_ABORT_EARLY
            continue
        b = _ints(bits.bb[row])
        b = (b + [0] * 6)[:6]
        if not ((b[0] & 0xF0) and (b[1] & 0x08) and (b[2] & 0x04)
                and (b[3] & 0x02) and (b[4] & 0x01)):
            result = DECODE_ABORT_EARLY
            continue
        by = [((b[0] & 0x0F) << 4) | ((b[1] & 0xF0) >> 4),
              ((b[1] & 0x07) << 5) | ((b[2] & 0xF8) >> 3),
              ((b[2] & 0x03) << 6) | ((b[3] & 0xFC) >> 2),
              ((b[3] & 0x01) << 7) | ((b[4] & 0xFE) >> 1),
              b[5]]
        if by[0] == 0xFF and by[1] == 0xFF and by[2] == 0xFF \
                and by[3] == 0xFF:
            result = DECODE_FAIL_SANITY
            continue
        status = by[0]
        esn = (by[1] << 16) | (by[2] << 8) | by[3]
        if util.crc8le(bytes(by), 5, 0xF5, 0x3D) != 0:
            result = DECODE_FAIL_MIC
            continue
        out.append(Event.make(
            ("model", "DSC-Security"),
            ("id", esn),
            ("closed", int((status & 0x02) == 0x02)),
            ("event", int((status & 0x40) != 0x40)),
            ("tamper", int(((status & 0x01) != 0x01)
                           or ((status & 0x10) == 0x10))),
            ("battery_ok", int(not ((status & 0x08) == 0x08)), "Battery"),
            ("xactivity", int((status & 0x20) == 0x20)),
            ("xtamper1", int((status & 0x01) != 0x01)),
            ("xtamper2", int((status & 0x10) == 0x10)),
            ("exception", int(((status & 0x80) != 0x80)
                              or ((status & 0x04) == 0x04))),
            ("esn", "%06x" % esn),
            ("status", status),
            ("status_hex", "%02x" % status),
            ("mic", "CRC", "Integrity"),
        ))
    return out if out else result


@decoder("dsc_security")
def dsc_security(bits, dev):
    return _dsc_decode(bits)


@decoder("dsc_security_ws4945")
def dsc_security_ws4945(bits, dev):
    return _dsc_decode(bits)


@decoder("X10_RF")
def x10_rf(bits, dev):
    """X10-RF (ref src/devices/x10_rf.c)."""
    if bits.num_rows < 2 or bits.bits_per_row[1] != 32:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[1])
    if (b[0] ^ b[1]) != 0xFF or (b[2] ^ b[3]) != 0xFF:
        return DECODE_FAIL_SANITY
    masks = [0x0B, 0x0B, 0x07, 0x07]
    values = [0x00, 0x0B, 0x00, 0x07]
    for i in range(4):
        if (masks[i] & b[i]) != values[i]:
            return DECODE_FAIL_SANITY
    code = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    h = [(b[0] >> 7) & 1, (b[0] >> 6) & 1, (b[0] >> 5) & 1, (b[0] >> 4) & 1]
    house = ((~(h[0] ^ h[1]) & 1) << 3) | ((~h[1] & 1) << 2) \
        | (((h[1] ^ h[2]) & 1) << 1) | (h[3] & 1)
    device = ((b[0] & 0x04) << 1) | ((b[2] & 0x40) >> 4) \
        | ((b[2] & 0x08) >> 2) | ((b[2] & 0x10) >> 4)
    device += 1
    state = (b[2] & 0x20) == 0x00
    if (b[2] & 0x80) == 0x80:
        device = 0
        event_str = {0x98: "DIM", 0x88: "BRI", 0x90: "ALL LTS ON",
                     0x80: "ALL OFF"}.get(b[2], "UNKNOWN")
    else:
        event_str = "ON" if state else "OFF"
    return [Event.make(
        ("model", "X10-RF"),
        ("id", device),
        ("channel", chr(house + ord("A"))),
        ("state", event_str, "State"),
        ("data", code, "Data", "%08x"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("interlogix")
def interlogix(bits, dev):
    """Interlogix-Security (ref src/devices/interlogix.c)."""
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] < 57 or bits.bits_per_row[0] > 64:
        return DECODE_ABORT_LENGTH
    bit_offset = bits.search(0, 0, bytes([0x01]), 8)
    if bit_offset == bits.bits_per_row[0]:
        return DECODE_FAIL_SANITY
    bit_offset += 8
    m = _ints(bits.extract_bytes(0, bit_offset, 46))
    m = (m + [0] * 6)[:6]
    if (m[0] == 0 and m[1] == 0 and m[2] == 0) \
            or (m[0] == 0xFF and m[1] == 0xFF and m[2] == 0xFF) \
            or (m[3] == 0 and m[4] == 0 and m[5] == 0) \
            or (m[3] == 0xFF and m[4] == 0xFF and m[5] == 0xFF):
        return DECODE_FAIL_SANITY
    parity = m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4]
    parity = (parity >> 4) ^ (parity & 0xF)
    parity = (parity >> 2) ^ (parity & 0x3)
    parity ^= m[5] >> 6
    if parity ^ 0x3:
        return DECODE_FAIL_MIC
    dt = util.reverse8(m[2]) >> 4
    device_type = {0xA: "contact", 0xF: "keyfob", 0x4: "motion",
                   0x6: "heat", 0x9: "glass", 0xD: "glass", 0xE: "freeze",
                   0x2: "smoke", 0x3: "panic"}.get(dt, "unknown")
    if device_type == "unknown":
        return DECODE_FAIL_SANITY
    serial = "%02x%02x%02x" % (util.reverse8(m[2]), util.reverse8(m[1]),
                               util.reverse8(m[0]))
    if dt == 0xF:
        low_battery = 0
        latch = [(m[3] & 0xE) == v for v in (0x4, 0x8, 0xC, 0x2, 0xA)]
        states = ["CLOSED" if x else "OPEN" for x in latch]
    else:
        low_battery = 1 if (m[3] & 0x10) else 0
        flags = [m[3] & 0x04, m[3] & 0x01, m[4] & 0x40, m[4] & 0x10,
                 m[4] & 0x04]
        states = ["OPEN" if x else "CLOSED" for x in flags]
    return [Event.make(
        ("model", "Interlogix-Security", "Model"),
        ("subtype", device_type, "Device Type"),
        ("id", serial, "ID"),
        ("battery_ok", int(not low_battery), "Battery"),
        ("switch1", states[0], "Switch1 State"),
        ("switch2", states[1], "Switch2 State"),
        ("switch3", states[2], "Switch3 State"),
        ("switch4", states[3], "Switch4 State"),
        ("switch5", states[4], "Switch5 State"),
        ("raw_message", "%02x%02x%02x" % (m[3], m[4], m[5]), "Raw Message"),
    )]


@decoder("govee")
def govee(bits, dev):
    """Govee-Water H5054 / Govee-Contact B5023 (ref src/devices/
    govee.c:138-262); raw code captured pre-invert."""
    if bits.num_rows < 3:
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(3, 48)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[r] > 48:
        return DECODE_ABORT_LENGTH
    code_str = "".join("%02x" % int(x) for x in _ints(bits.bb[r])[:6])
    bits.invert()
    b = _ints(bits.bb[r])
    id_ = (b[0] << 8) | b[1]
    if id_ == 0xFFFF:
        return DECODE_ABORT_EARLY
    if b[5] == 0:
        return DECODE_ABORT_EARLY
    event_type = b[2] & 0x0F
    event = (b[2] << 8) | b[3]
    if event == 0xFFFF:
        return DECODE_ABORT_EARLY
    parity = (b[5] >> 1) & 0x0F
    chk = util.xor_bytes(bytes(b[:5]), 5)
    chk = (chk >> 4) ^ (chk & 0xF)
    if chk != parity:
        return DECODE_FAIL_MIC
    battery = b[3] if event_type == 0xC else 0
    event &= 0x0FFF
    model = "Govee-Water"
    wet = -1
    if event == 0xAFA:
        event_str = "Button Press"
        wet = 0
    elif event == 0xBFB:
        event_str = "Water Leak"
        wet = 1
    elif event_type == 0xC:
        event_str = "Battery Report"
    elif event == 0xDFD:
        event_str = "Heartbeat"
    elif event == 0xE7F:
        model = "Govee-Contact"
        event_str = "Open"
    else:
        event_str = "Unknown"
    return [Event.make(
        ("model", model),
        ("id", id_),
        ("battery_ok", battery * 0.01, "Battery level") if battery else None,
        ("battery_mV", 1800 + 12 * battery, "Battery", "%d mV")
        if battery else None,
        ("detect_wet", wet) if wet >= 0 else None,
        ("event", event_str),
        ("code", code_str, "Raw Code"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("govee_h5054")
def govee_h5054(bits, dev):
    """Govee-Water H5054 new fw (ref src/devices/govee.c:320-415)."""
    if bits.num_rows < 3:
        return DECODE_ABORT_EARLY
    r = bits.find_repeated_row(3, 48)
    if r < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[r] > 48:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[r])
    code_str = "".join("%02x" % x for x in b[:6])
    if util.crc16(bytes(b[:6]), 6, 0x1021, 0x1D0F) != 0:
        return DECODE_FAIL_MIC
    id_ = (b[0] << 8) | b[1]
    event = b[2] & 0xF
    event_data = b[3]
    wet = -1
    leak_num = -1
    battery = -1
    if event == 0x0:
        event_str = "Button Press"
        wet = 0
    elif event == 0x1:
        event_str = "Battery Report"
        battery = event_data
    elif event == 0x2:
        event_str = "Water Leak"
        wet = 1
        leak_num = event_data
    else:
        event_str = "Unknown"
    return [Event.make(
        ("model", "Govee-Water"),
        ("id", id_),
        ("battery_ok", battery * 0.01, "Battery level")
        if battery >= 0 else None,
        ("battery_mV", 1800 + 12 * battery, "Battery", "%d mV")
        if battery >= 0 else None,
        ("event", event_str),
        ("detect_wet", wet) if wet >= 0 else None,
        ("leak_num", leak_num, "Leak Num") if leak_num >= 0 else None,
        ("code", code_str, "Raw Code"),
        ("mic", "CRC", "Integrity"),
    )]


def _honeywell_wdb(bits):
    """Honeywell-ActivLink doorbell (ref src/devices/honeywell_wdb.c)."""
    row = bits.find_repeated_row(4, 48)
    if row < 0:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[row] != 48:
        return DECODE_ABORT_LENGTH
    bits.invert()
    b = _ints(bits.bb[row])
    parity = 0
    for x in b[:6]:
        parity ^= x
    parity = util.parity8(parity)
    if (not b[0] and not b[2] and not b[4] and not b[5]) \
            or (b[0] == 0xFF and b[2] == 0xFF and b[4] == 0xFF
                and b[5] == 0xFF):
        return DECODE_FAIL_SANITY
    if parity:
        return DECODE_FAIL_MIC
    device = (b[0] << 12) | (b[1] << 4) | (b[2] >> 4)
    type_ = (b[3] & 0x70) >> 4
    class_ = {0x1: "PIR-Motion", 0x2: "Doorbell",
              0x5: "Contact"}.get(type_, "Unknown")
    alert = {0x0: "Normal", 0x1: "High", 0x2: "High",
             0x3: "Full"}.get(b[4] & 0x3, "Unknown")
    secret_knock = (b[5] & 0x10) >> 4
    tampered = secret_knock
    if type_ == 0x5:
        secret_knock = 0
    else:
        tampered = 0
    opened = (b[5] & 0x20) >> 5
    closed = (b[5] & 0x40) >> 6
    if opened and not closed:
        open_ = 1
    elif not opened and closed:
        open_ = 0
    else:
        open_ = -1
    return [Event.make(
        ("model", "Honeywell-ActivLink"),
        ("subtype", class_, "Class"),
        ("id", device, "Id", "%x"),
        ("battery_ok", int(not ((b[5] & 0x2) >> 1)), "Battery"),
        ("alert", alert, "Alert"),
        ("secret_knock", secret_knock, "Secret Knock", "%d"),
        ("open", open_, "Open", "%d"),
        ("tampered", tampered, "Tampered", "%d"),
        ("relay", (b[5] & 0x8) >> 3, "Relay", "%d"),
        ("mic", "PARITY", "Integrity"),
    )]


@decoder("honeywell_wdb")
def honeywell_wdb(bits, dev):
    return _honeywell_wdb(bits)


@decoder("honeywell_wdb_fsk")
def honeywell_wdb_fsk(bits, dev):
    return _honeywell_wdb(bits)

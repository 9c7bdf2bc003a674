"""Misc decoders batch P (reference files cited per function):
Insteon RF, DeltaDore X3D.
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


_INSTEON_MSG = ["Direct Message", "ACK of Direct Message",
                "Group Cleanup Direct Message",
                "ACK of Group Cleanup Direct Message", "Broadcast Message",
                "NAK of Direct Message", "Group Broadcast Message",
                "NAK of Group Cleanup Direct Message"]


def _insteon_ext_crc(dat):
    """Extended packet checksum (ref src/devices/insteon.c:83)."""
    r = 0
    for i in range(7, 22):
        r += dat[i]
    return (~r + 1) & 0xFF


def _insteon_crc(dat):
    """Standard packet checksum (ref src/devices/insteon.c:104)."""
    r = 0
    for i in range(9):
        r ^= dat[i]
        r = (r ^ (((r ^ (r << 1)) & 0x0F) << 4)) & 0xFF
    return r


@decoder("insteon")
def insteon(bits, dev):
    """Insteon RF (ref src/devices/insteon.c:378)."""
    bits.invert()
    min_bitlen = 10 * 28 + 2
    events = []
    fail_value = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] < min_bitlen:
            fail_value = DECODE_ABORT_LENGTH
            continue
        bit_index = 0
        while True:
            if bits.bits_per_row[row] - bit_index < min_bitlen:
                break
            search_index = bits.search(row, bit_index,
                                       bytes([0xCE, 0xAA]), 16)
            if search_index >= bits.bits_per_row[row]:
                break
            ret = _insteon_parse_full(bits, row, search_index)
            if isinstance(ret, list):
                events += ret
                bit_index = search_index + min_bitlen
            else:
                if ret < 0:
                    fail_value = ret
                bit_index = search_index + 16
    if events:
        return events
    return fail_value


def _insteon_parse_full(bits, row, start):
    """Parse + payload fix-up (payload hex covers all decoded bytes,
    ref src/devices/insteon.c:293)."""
    start_pos = start + 7
    # first block
    i_bits = BitBuffer()
    d_bits = BitBuffer()
    next_pos = bits.manchester_decode(row, start_pos, i_bits, 5)
    next_pos = bits.manchester_decode(row, next_pos, d_bits, 8)
    # the reference keeps partial manchester decodes here (no length
    # check on the first block, ref src/devices/insteon.c:160-167)
    pkt_i = util.reverse8(int(i_bits.bb[0][0]))
    pkt_d = util.reverse8(int(d_bits.bb[0][0]))
    results = [pkt_d]
    if pkt_i != 31:
        return DECODE_ABORT_EARLY
    delim = int(bits.extract_bytes(row, start_pos + 26, 2)[0])
    if delim != 0xC0:
        return DECODE_FAIL_SANITY
    extended = 1 if (results[0] & 0x10) else 0
    max_pkt_len = 32 if extended else 13
    min_pkt_len = 23 if extended else 10
    prev_i = 33
    for _ in range(1, max_pkt_len):
        start_pos += 28
        i_bits = BitBuffer()
        d_bits = BitBuffer()
        mid = bits.manchester_decode(row, start_pos, i_bits, 5)
        next_pos = bits.manchester_decode(row, mid, d_bits, 8)
        if next_pos - start_pos != 26:
            break
        pkt_i = util.reverse8(int(i_bits.bb[0][0]))
        pkt_d = util.reverse8(int(d_bits.bb[0][0]))
        results.append(pkt_d)
        if pkt_i < prev_i:
            prev_i = pkt_i
        else:
            return DECODE_ABORT_EARLY
    results_len = len(results)
    if results_len < min_pkt_len:
        return 0
    padded = results + [0] * (35 - results_len)
    crc_val = _insteon_ext_crc(padded) if extended else _insteon_crc(padded)
    if results[min_pkt_len - 1] != crc_val:
        return DECODE_FAIL_MIC
    to_addr = "%02X%02X%02X" % (results[3], results[2], results[1])
    from_addr = "%02X%02X%02X" % (results[6], results[5], results[4])
    cmd_array = [results[j] for j in range(7, min_pkt_len - 1)]
    cmd_str = "".join("%02X " % x for x in cmd_array)
    payload = "".join("%02X" % x for x in results)
    formatted = "%02X : %s : %s : %s %02X" % (
        results[0], to_addr, from_addr, cmd_str, results[min_pkt_len - 1])
    pkt_type = (results[0] >> 5) & 0x07
    return [Event.make(
        ("model", "Insteon"),
        ("from_id", from_addr, "From_Addr"),
        ("to_id", to_addr, "To_Addr"),
        ("msg_type", pkt_type, "Message_Type"),
        ("msg_str", _INSTEON_MSG[pkt_type], "Message_Str"),
        ("extended", extended, "Extended"),
        ("hopsmax", results[0] & 0x03, "Hops_Max"),
        ("hopsleft", (results[0] >> 2) & 0x03, "Hops_Left"),
        ("formatted", formatted, "Packet"),
        ("mic", "CRC", "Integrity"),
        ("payload", payload, "Payload"),
        ("cmd_dat", cmd_array, "CMD_Data"),
    )]


_X3D_CLASS = {0x00: "Sensor", 0x01: "Standard", 0x02: "Pairing",
              0x03: "Beacon"}


@decoder("deltadore_x3d")
def deltadore_x3d(bits, dev):
    """DeltaDore X3D (ref src/devices/deltadore_x3d.c:252)."""
    pre = bytes([0xAA, 0xAA, 0x81, 0x69, 0x96, 0x7E])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    start = bits.search(0, 0, pre, 48)
    if start >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    start += 48
    if bits.bits_per_row[0] < 80:
        return DECODE_ABORT_LENGTH
    length = int(util.ccitt_whitening(
        bytes([int(bits.extract_bytes(0, start, 8)[0])]))[0])
    if length > 64:
        return DECODE_ABORT_LENGTH
    frame = _ints(util.ccitt_whitening(bytes(
        _ints(bits.extract_bytes(0, start, length * 8))[:length])))
    frame += [0] * (65 - len(frame))
    crc = util.crc16(bytes(frame[:length - 2]), length - 2, 0x1021, 0x0000)
    if ((frame[length - 2] << 8) | frame[length - 1]) != crc:
        return DECODE_FAIL_MIC
    # header (ref src/devices/deltadore_x3d.c:211)
    pos = 2
    number = frame[pos]; pos += 1
    mtype = frame[pos]; pos += 1
    header_flags = frame[pos] & 0xE0; pos += 1
    device_id = frame[pos] | (frame[pos + 1] << 8) | (frame[pos + 2] << 16)
    pos += 3
    network = frame[pos]; pos += 1
    pos += 2  # unknown_header_flags1, skip to flags2
    flags2 = frame[pos - 1]
    flags3 = frame[pos]; pos += 1
    temp_type_v = 0
    temperature = 0
    if flags3 == 0x01:
        pos += 1
    elif flags3 == 0x08:
        temp_type_v = frame[pos]; pos += 1
        temperature = frame[pos] | (frame[pos + 1] << 8)
        if temperature & 0x8000:
            temperature -= 0x10000
        pos += 2
    message_id = frame[pos] | (frame[pos + 1] << 8); pos += 2
    pos += 2  # header_check (big-endian, not validated)
    klass = _X3D_CLASS.get(mtype, "Unknown")
    wnd_stat = {0x01: "Closed", 0x41: "Opened"}.get(flags2, "")
    temp_type = {0x00: "indoor", 0x01: "outdoor"}.get(temp_type_v, "")
    items = [
        ("model", "DeltaDore-X3D"),
        ("id", device_id, ""),
        ("network", network, "Net"),
        ("subtype", klass, "Class", "%s"),
        ("msg_id", message_id, "Message Id"),
        ("msg_no", number, "Message No."),
        ("mic", "CRC", "Integrity"),
    ]
    if flags3 == 0x08:
        items.append(("temperature_C", temperature / 100.0, "Temperature",
                      "%.1f C"))
        items.append(("temperature_type", temp_type, "Temp Type"))
    if header_flags & 0x20:
        if wnd_stat:
            items.append(("wnd_stat", wnd_stat, "Window Status"))
    else:
        retry = frame[pos]; pos += 1
        transfer = frame[pos] | (frame[pos + 1] << 8); pos += 2
        transfer_ack = frame[pos] | (frame[pos + 1] << 8); pos += 2
        target = frame[pos] | (frame[pos + 1] << 8); pos += 2
        action = frame[pos]; pos += 1
        register_high = frame[pos]; pos += 1
        register_low = frame[pos]; pos += 1
        target_ack = frame[pos] | (frame[pos + 1] << 8); pos += 2
        raw_msg = "".join("%02x" % x
                          for x in frame[pos:pos + max(0, length - pos - 2)])
        items += [
            ("retry", retry, "Retry"),
            ("transfer", transfer, "Transfer"),
            ("transfer_ack", transfer_ack, "Transfer Ack"),
            ("target", target, "Target"),
            ("target_ack", target_ack, "Target Ack"),
            ("action", action, "Action"),
            ("register_high", register_high, "Reg High"),
            ("register_low", register_low, "Reg Low"),
            ("raw_msg", raw_msg, "Raw Register Data"),
        ]
    return [Event.make(*items)]


def _cm921_next(bb, ipos, num_bytes):
    """Byte reader with end quirk: reading the final byte yields 0xFC
    (DECODE_FAIL_SANITY truncated to uint8),
    ref src/devices/honeywell_cm921.c:97."""
    p = ipos[0]
    out = 0
    for i in range(8):
        q = p + i
        byte = bb[q >> 3] if (q >> 3) < len(bb) else 0
        out = (out << 1) | ((byte >> (7 - (q & 7))) & 1)
    ipos[0] += 8
    if ipos[0] >= num_bytes * 8:
        return 0xFC
    return out


@decoder("honeywell_cm921")
def honeywell_cm921(bits, dev):
    """Honeywell CM921 thermostat (ref src/devices/honeywell_cm921.c:162)."""
    if bits.num_rows != 1 or bits.bits_per_row[0] < 60:
        return DECODE_ABORT_LENGTH
    pre_start = bits.search(0, 0, bytes([0x55, 0x5F, 0xF0, 0x04]), 30)
    start = pre_start + 30
    length = bits.bits_per_row[0] - start
    if length < 8:
        return DECODE_ABORT_LENGTH
    end = start + length
    row = _ints(bits.bb[0])

    def bit_at(p):
        if (p >> 3) >= len(row):
            return 0
        return (row[p >> 3] >> (7 - (p & 7))) & 1

    stream = []  # bit list of the de-framed stream (LSB-reversed bytes)
    pos = start
    while pos < end:
        if pos + 10 > end or bit_at(pos) != 0 or bit_at(pos + 9) != 1:
            break
        byte = 0
        for i in range(8):
            byte = (byte << 1) | bit_at(pos + 1 + i)
        for i in range(8):
            stream.append((byte >> i) & 1)
        pos += 10
    nbits = len(stream)
    sby = [0] * ((nbits + 7) // 8 + 2)
    for i, b in enumerate(stream):
        if b:
            sby[i >> 3] |= 0x80 >> (i & 7)
    if sby[0] != 0x33 or sby[1] != 0x55 or sby[2] != 0x53:
        return DECODE_FAIL_SANITY
    fi = nbits - 8
    seen_aa = False
    while fi >= 0 and sby[fi >> 3] == 0x55:
        seen_aa = True
        fi -= 8
    if not seen_aa or fi < 0 or sby[fi >> 3] != 0x35:
        return DECODE_FAIL_SANITY
    first_byte = 24
    num_bits = fi - first_byte
    sbuf = BitBuffer()
    for bit in stream:
        sbuf.add_bit(bit)
    packet = BitBuffer()
    fpos = sbuf.manchester_decode(0, first_byte, packet, num_bits)
    man_errors = num_bits - (fpos - first_byte - 2)
    if man_errors != 0:
        return DECODE_FAIL_SANITY
    # parse (ref src/devices/honeywell_cm921.c:107)
    pbits = packet.bits_per_row[0]
    if pbits < 8:
        return DECODE_ABORT_LENGTH
    num_bytes = pbits // 8
    pb = _ints(packet.bb[0])
    if util.add_bytes(bytes(pb[:num_bytes]), num_bytes) & 0xFF:
        return DECODE_FAIL_MIC
    ipos = [0]
    header = _cm921_next(pb, ipos, num_bytes)
    num_ids = {0x14: 1, 0x18: 2, 0x1C: 2, 0x10: 2,
               0x3C: 2}.get(header, (header >> 2) & 0x03)
    ids = []
    for _ in range(num_ids):
        ids.append("%02x%02x%02x" % tuple(
            _cm921_next(pb, ipos, num_bytes) for _ in range(3)))
    command = (_cm921_next(pb, ipos, num_bytes) << 8) \
        | _cm921_next(pb, ipos, num_bytes)
    payload_length = _cm921_next(pb, ipos, num_bytes)
    payload = [_cm921_next(pb, ipos, num_bytes)
               for _ in range(payload_length)]
    payload += [0] * (256 - len(payload))
    items = [("model", "Honeywell-CM921"), ("ids", " ".join(ids),
                                            "Device IDs")]
    unknown = [("unknown", command, "", "%04x")]
    if command == 0x1030:
        if payload_length != 16:
            items += unknown
        else:
            items.append(("zone_idx", payload[0], "", "%02x"))
            names = {0xC8: "max_flow_temp", 0xC9: "pump_run_time",
                     0xCA: "actuator_run_time", 0xCB: "min_flow_temp"}
            for i in range(5):
                p = payload[1 + 3 * i]
                value = payload[1 + 3 * i + 2]
                if p in names:
                    items.append((names[p], value, ""))
    elif command == 0x313F:
        if payload_length == 1:
            items.append(("time_request", payload[0], ""))
        elif payload_length == 9:
            items.append(("datetime", "%02d:%02d:%02d %02d-%02d-%04d" % (
                payload[4] & 0x1F, payload[3], payload[2], payload[5],
                payload[6], (payload[7] << 8) | payload[8]), ""))
        else:
            items += unknown
    elif command == 0x0008:
        if payload_length != 2:
            items += unknown
        else:
            items.append(("domain_id", payload[0], ""))
            items.append(("demand", payload[1] / 200.0, ""))
    elif command == 0x3EF0:
        if payload_length == 3:
            items.append(("status", payload[1] / 200.0, ""))
        elif payload_length == 6:
            items.append(("boiler_modulation_level", payload[1] / 200.0,
                          ""))
            items.append(("flame_status", payload[3], ""))
        else:
            items += unknown
    elif command == 0x2309:
        if payload_length != 3:
            items += unknown
        else:
            items.append(("zone", payload[0], ""))
            items.append(("setpoint",
                          ((payload[1] << 8) | payload[2]) / 100.0, ""))
    elif command == 0x1100:
        if payload_length not in (5, 8):
            items += unknown
        else:
            items.append(("domain_id", payload[0], ""))
            items.append(("cycle_rate", payload[1] / 4.0, ""))
            items.append(("minimum_on_time", payload[2] / 4.0, ""))
            items.append(("minimum_off_time", payload[3] / 4.0, ""))
            if payload_length == 8:
                items.append(("proportional_band_width",
                              ((payload[5] << 8) | payload[6]) / 100.0,
                              ""))
    elif command == 0x0009:
        if payload_length != 3:
            items += unknown
        else:
            items.append(("device_number", payload[0], ""))
            items.append(("failsafe_mode",
                          {0: "off", 1: "20-80"}.get(payload[1],
                                                     "unknown"), ""))
    elif command == 0x3B00:
        if payload_length != 2:
            items += unknown
        else:
            items.append(("domain_id", payload[0], ""))
            items.append(("state", payload[1] / 200.0, ""))
    elif command == 0x30C9:
        for i in range(payload_length // 3):
            temp = (payload[3 * i + 1] << 8) | payload[3 * i + 2]
            if temp & 0x8000:
                temp -= 0x10000
            items.append(("temperature (zone %u)" % payload[3 * i],
                          temp / 100.0, ""))
    elif command == 0x1FD4:
        items.append(("ticker", (payload[1] << 8) | payload[2], ""))
    elif command == 0x3150:
        items.append(("zone", payload[0], ""))
        items.append(("heat_demand", payload[1], ""))
    else:
        items += unknown
    items.append(("mic", "CHECKSUM", "Integrity"))
    return [Event.make(*items)]

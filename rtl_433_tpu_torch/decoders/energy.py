"""Energy / utility-meter decoders (reference files cited per function):
CurrentCost, emonTx, Efergy Optical, ESA/Gira, IKEA Sparsnäs, SCM+,
ERT IDM/NetIDM, Blueline PowerCost, RFXMeter.
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


def _s32(v):
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


@decoder("current_cost")
def current_cost(bits, dev):
    """CurrentCost TX/EnviR sensors (ref src/devices/current_cost.c)."""
    bits.invert()
    init_classic = bytes([0xCC, 0xCC, 0xCC, 0xCE, 0x91, 0x5D])
    init_envir = bytes([0x55, 0x55, 0x55, 0x55, 0xA4, 0x57])
    is_envir = 0
    start = bits.search(0, 0, init_envir, 48)
    if start + 47 + 112 <= bits.bits_per_row[0]:
        is_envir = 1
        start += 47
    else:
        start = bits.search(0, 0, init_classic, 45)
        if start + 45 + 112 > bits.bits_per_row[0]:
            return DECODE_ABORT_EARLY
        start += 45
    packet = BitBuffer()
    bits.manchester_decode(0, start, packet, 0)
    if packet.bits_per_row[0] < 64:
        return DECODE_ABORT_EARLY
    b = _ints(packet.bb[0])
    if (b[0] & 0xF0) == 0:
        device_id = ((b[0] & 0x0F) << 8) | b[1]
        watt0 = ((b[2] & 0x7F) << 8) | b[3] if (b[2] & 0x80) == 128 else 0
        watt1 = ((b[4] & 0x7F) << 8) | b[5] if (b[4] & 0x80) == 128 else 0
        watt2 = ((b[6] & 0x7F) << 8) | b[7] if (b[6] & 0x80) == 128 else 0
        return [Event.make(
            ("model", "CurrentCost-EnviR" if is_envir else "CurrentCost-TX"),
            ("id", device_id, "Device Id", "%d"),
            ("power0_W", watt0, "Power 0", "%d W"),
            ("power1_W", watt1, "Power 1", "%d W"),
            ("power2_W", watt2, "Power 2", "%d W"),
        )]
    if (b[0] & 0xF0) == 64:
        device_id = ((b[0] & 0x0F) << 8) | b[1]
        c_impulse = (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]
        return [Event.make(
            ("model", "CurrentCost-EnviRCounter" if is_envir
             else "CurrentCost-Counter"),
            ("subtype", b[3], "Sensor Id", "%d"),
            ("id", device_id, "Device Id", "%d"),
            ("power0", _s32(c_impulse), "Counter", "%d"),
        )]
    return DECODE_FAIL_OTHER


@decoder("emontx")
def emontx(bits, dev):
    """emonTx OpenEnergyMonitor (JeeLibs RF12) (ref src/devices/emontx.c)."""
    preamble = bytes([0xAA, 0xAA, 0xAA])
    pkt_hdr = bytes([0x2D, 0xD2, 0x00])
    pkt_hdr_inv = bytes([0xD2, 0x2D, 0xC0])
    pkt_bytes = 33  # syn group node len + 14 LE words + postamble
    events = []
    bitpos = 0
    nbits = bits.bits_per_row[0]
    while True:
        bitpos = bits.search(0, bitpos, preamble, 22)
        if bitpos >= nbits:
            break
        inverted = 0
        bitpos += 22
        while bits.search(0, bitpos, preamble, 2) == bitpos:
            bitpos += 2
        bitpos -= 1
        pkt_pos = bits.search(0, bitpos, pkt_hdr, 11)
        if pkt_pos > bitpos + 5:
            pkt_pos = bits.search(0, bitpos, pkt_hdr_inv, 11)
            if pkt_pos > bitpos + 5:
                continue
            inverted = 1
        if pkt_pos + pkt_bytes * 8 > nbits:
            break
        pkt = _ints(bits.extract_bytes(0, pkt_pos, pkt_bytes * 8))
        if inverted:
            pkt = [x ^ 0xFF for x in pkt]
        # struct: syn group node len, 14 LE words, postamble
        if pkt[3] != 0x1A or pkt[32] != 0xAA:
            continue
        crc = util.crc16lsb(bytes(pkt[1:1 + 0x1D]), 0x1D, 0xA001, 0xFFFF)
        words = [pkt[4 + i * 2] | (pkt[5 + i * 2] << 8) for i in range(14)]
        if crc != words[13]:
            continue
        events.append(Event.make(
            ("model", "emonTx-Energy"),
            ("node", pkt[2] & 0x1F, "", "%02x"),
            ("ct1", _s16(words[0]), "", "%d"),
            ("ct2", _s16(words[1]), "", "%d"),
            ("ct3", _s16(words[2]), "", "%d"),
            ("ct4", _s16(words[3]), "", "%d"),
            ("batt_Vrms", words[4] / 100.0, "", "%.2f"),
            ("pulse", _s32(words[11] | (words[12] << 16)), "", "%u"),
            ("temp1_C", words[5] * 0.1, "", "%.1f") if words[5] != 3000 else None,
            ("temp2_C", words[6] * 0.1, "", "%.1f") if words[6] != 3000 else None,
            ("temp3_C", words[7] * 0.1, "", "%.1f") if words[7] != 3000 else None,
            ("temp4_C", words[8] * 0.1, "", "%.1f") if words[8] != 3000 else None,
            ("temp5_C", words[9] * 0.1, "", "%.1f") if words[9] != 3000 else None,
            ("temp6_C", words[10] * 0.1, "", "%.1f") if words[10] != 3000 else None,
            ("mic", "CRC", "Integrity"),
        ))
    return events


@decoder("efergy_optical")
def efergy_optical(bits, dev):
    """Efergy IR Optical meter (ref src/devices/efergy_optical.c)."""
    num_bits = bits.bits_per_row[0]
    if num_bits < 96 or num_bits > 100:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[0]) + [0, 0]
    while (b[0] & 0xF0) != 0xF0 and (b[0] & 0xF0) != 0x00:
        num_bits -= 1
        if num_bits < 96:
            return DECODE_ABORT_EARLY
        for i in range((num_bits + 7) // 8):
            b[i] = ((b[i] << 1) & 0xFF) | ((b[i + 1] & 0x80) >> 7)
    if b[0] & 0xF0:
        for i in range(12):
            b[i] = ~b[i] & 0xFF
    if b[8] == 0 and b[9] == 0 and b[10] == 0 and b[11] == 0:
        return DECODE_FAIL_SANITY
    csum1 = (b[10] << 8) | b[11]
    if util.crc16(bytes(b[:10]), 10, 0x1021, 0x0000) != csum1:
        return DECODE_FAIL_MIC
    dev_id = (b[0] << 16) | (b[1] << 8) | b[2]
    seconds = (((b[3] & 0x30) >> 4) + 1) * 30.0
    pulsecount = b[8]
    events = []
    for imp in (4000, 3200, 2000, 1000, 500):
        energy = (pulsecount / imp) * (3600 / seconds)
        events.append(Event.make(
            ("model", "Efergy-Optical", "Model"),
            ("id", dev_id),
            ("pulses", imp, "Pulse-rate"),
            ("pulsecount", pulsecount, "Pulse-count"),
            ("energy_kWh", energy, "Energy", "%.3f kWh"),
            ("mic", "CRC", "Integrity"),
        ))
    return events


def _esa_decrypt(b, blen):
    """ESA rolling-xor decrypt + additive check (ref src/devices/esa.c:18-37)."""
    salt = 0x89
    crc = 0
    for i in range(blen - 3):
        byte = b[i]
        crc = (crc + byte) & 0xFFFF
        b[i] ^= salt
        salt = (byte + 0x24) & 0xFF
    crc = (crc + b[blen - 3]) & 0xFFFF
    b[blen - 3] ^= 0xFF
    return (((b[blen - 2] << 8) | b[blen - 1]) - crc) & 0xFFFF


@decoder("esa_energy")
def esa_energy(bits, dev):
    """ELV ESA 1000/2000 / Gira EHZ energy counter (ref src/devices/esa.c)."""
    length = bits.bits_per_row[0]
    if length not in (176, 160) or bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, 16, length - 16))
    crc = _esa_decrypt(b, length // 8 - 2)
    if crc == 0xF00F:
        deviceid = (b[1] << 8) | b[2]
        impulses_val = (b[9] << 8) | b[10]
        impulses_total = (b[5] << 24) | (b[6] << 16) | (b[7] << 8) | b[8]
        impulse_constant = ((b[14] << 8) | b[15]) ^ b[1]
        model = {0x01: "ESAx000WZ", 0x03: "ESA1000Z"}.get(b[3], "ESA-unknown")
        return [Event.make(
            ("model", model, "Model"),
            ("id", deviceid, "Id"),
            ("impulses", impulses_val, "Impulses"),
            ("impulses_total", _s32(impulses_total), "Impulses Total"),
            ("impulse_constant", impulse_constant, "Impulse Constant"),
            ("total_kWh", impulses_total / impulse_constant
             if impulse_constant else float("inf"), "Energy Total"),
            ("impulse_kWh", impulses_val / impulse_constant
             if impulse_constant else float("inf"), "Energy Impulse"),
            ("sequence_id", b[0] & 0x7F, "Sequence ID"),
            ("is_retry", b[0] >> 7, "Is Retry"),
            ("mic", "CRC", "Integrity"),
        )]
    if crc == 0xEE11:
        deviceid = (b[1] << 8) | b[2]
        impulses_val = (b[11] << 8) | b[12]
        impulses_total = (b[8] << 16) | (b[9] << 8) | b[10]
        impulse_constant = (b[16] << 8) | (b[17] ^ b[1])
        return [Event.make(
            ("model", "Gira-EHZ", "Model"),
            ("id", deviceid, "Id"),
            ("impulses", impulses_val, "Impulses"),
            ("impulses_total", impulses_total, "Impulses Total"),
            ("impulse_constant", impulse_constant, "Impulse Constant"),
            ("total_kWh", impulses_total / impulse_constant
             if impulse_constant else float("inf"), "Energy Total"),
            ("impulse_kWh", impulses_val / impulse_constant
             if impulse_constant else float("inf"), "Energy Impulse"),
            ("sequence_id", b[0] & 0x3F, "Sequence ID"),
            ("is_retry", (b[0] >> 6) & 1, "Is Retry"),
            ("status", (b[3] << 8) | b[4], "Status/Type"),
            ("power", (b[6] << 8) | b[7], "Power"),
            ("mic", "CRC", "Integrity"),
        )]
    return DECODE_FAIL_MIC


_SPARSNAS_KEY_SUB = 0x5D38E8CB
_SPARSNAS_PULSES_PER_KWH = 1000


def _sparsnas_brute_force(buf):
    """Brute-force the sender id from one packet (ref
    src/devices/ikea_sparsnas.c:80-117)."""
    b5, b6, b7, b8 = buf[5], buf[6], buf[7], buf[8]
    battery_enc = buf[17]
    d3 = b8 ^ 0x47
    for k0 in range(0xFF):
        d0 = b5 ^ k0
        if d0 > 0x0F:
            continue
        for k1 in range(0xFF):
            d1 = b6 ^ k1
            for k2 in range(0xFF):
                d2 = b7 ^ k2
                battery_dec = battery_enc ^ k2
                dec_id = (d0 << 24) | (d1 << 16) | (d2 << 8) | d3
                if dec_id > 999999:
                    continue
                for k4 in range(0xFF):
                    key_id = (((k0 << 24) | (k4 << 16) | (k2 << 8) | k1)
                              + _SPARSNAS_KEY_SUB) & 0xFFFFFFFF
                    if dec_id == key_id and battery_dec <= 100:
                        return dec_id
    return 0


@decoder("ikea_sparsnas")
def ikea_sparsnas(bits, dev):
    """IKEA Sparsnäs energy monitor (ref src/devices/ikea_sparsnas.c).

    Stateful: the sensor id is brute-forced from the first good packet
    and cached on the device."""
    if bits.bits_per_row[0] < 160 or bits.bits_per_row[0] > 260:
        return DECODE_ABORT_LENGTH
    preamble = bytes([0xAA, 0xAA, 0xD2, 0x01])
    bitpos = bits.search(0, 0, preamble, 32)
    if bitpos == bits.bits_per_row[0] or bitpos + 160 > bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    buf = _ints(bits.extract_bytes(0, bitpos + 32, 160))
    crc_calc = util.crc16(bytes(buf[:18]), 18, 0x8005, 0xFFFF)
    if ((buf[18] << 8) | buf[19]) != crc_calc:
        return DECODE_FAIL_MIC
    sensor_id = getattr(dev, "_sparsnas_sensor_id", 0)
    if not sensor_id:
        sensor_id = _sparsnas_brute_force(buf)
        dev._sparsnas_sensor_id = sensor_id
    sub = (sensor_id - _SPARSNAS_KEY_SUB) & 0xFFFFFFFF
    key = [(sub >> 24) & 0xFF, sub & 0xFF, (sub >> 8) & 0xFF, 0x47,
           (sub >> 16) & 0xFF]
    decrypted = buf[:5] + [buf[5 + i] ^ key[i % 5] for i in range(13)]
    rcv_id = ((decrypted[5] << 24) | (decrypted[6] << 16)
              | (decrypted[7] << 8) | decrypted[8])
    if not sensor_id or rcv_id != sensor_id:
        return [Event.make(
            ("model", "Ikea-Sparsnas", "Model"),
            ("id", sensor_id, "Sensor ID"),
            ("mic", "CRC", "Integrity"),
        )]
    if decrypted[0] != 0x11 or decrypted[3] != 0x07:
        return DECODE_FAIL_SANITY
    pulses = ((decrypted[13] << 24) | (decrypted[14] << 16)
              | (decrypted[15] << 8) | decrypted[16])
    return [Event.make(
        ("model", "Ikea-Sparsnas", "Model"),
        ("id", _s32(rcv_id), "Sensor ID"),
        ("sequence", (decrypted[9] << 8) | decrypted[10], "Sequence Number"),
        ("battery_ok", decrypted[17] * 0.01, "Battery level"),
        ("pulses_per_kWh", _SPARSNAS_PULSES_PER_KWH, "Pulses per kWh"),
        ("cumulative_kWh", pulses / _SPARSNAS_PULSES_PER_KWH,
         "Cumulative kWh", "%7.3fkWh"),
        ("effect", (decrypted[11] << 8) | decrypted[12], "Effect", "%dW"),
        ("pulses", _s32(pulses), "Pulses"),
        ("mode", decrypted[4] ^ 0x0F, "Mode"),
        ("mic", "CRC", "Integrity"),
    )]


def _ert_meter_type(ert_type):
    t = ert_type & 0x0F
    if t in (4, 5, 7, 8):
        return "Electric"
    if t in (0, 1, 2, 9, 12):
        return "Gas"
    if t in (3, 11, 13):
        return "Water"
    return "unknown"


@decoder("scmplus")
def scmplus(bits, dev):
    """ERT SCM+ meters (ref src/devices/scmplus.c)."""
    if bits.bits_per_row[0] < 128:
        return DECODE_ABORT_LENGTH
    sync = bytes([0x16, 0xA3, 0x1E])
    idx = bits.search(0, 0, sync, 24)
    if idx >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] - idx < 128:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, idx, 16 * 8))
    crc = util.crc16(bytes(b[2:14]), 12, 0x1021, 0x0971)
    if crc != ((b[14] << 8) | b[15]):
        return DECODE_FAIL_MIC
    endpoint_id = (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]
    consumption = (b[8] << 24) | (b[9] << 16) | (b[10] << 8) | b[11]
    return [Event.make(
        ("model", "SCMplus"),
        ("id", _s32(endpoint_id)),
        ("ProtocolID", "0x%02X" % b[2], "Protocol_ID"),
        ("EndpointType", "0x%02X" % b[3], "Endpoint_Type"),
        ("EndpointID", _s32(endpoint_id), "Endpoint_ID"),
        ("Consumption", _s32(consumption), "", "%u"),
        ("Tamper", "0x%04X" % ((b[12] << 8) | b[13])),
        ("PacketCRC", "0x%04X" % crc, "crc"),
        ("MeterType", _ert_meter_type(b[3]), "Meter_Type"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ert_idm")
def ert_idm(bits, dev):
    """ERT Interval Data Message (ref src/devices/ert_idm.c:75-280)."""
    if bits.bits_per_row[0] < 720:
        return DECODE_ABORT_LENGTH
    sync = bytes([0x16, 0xA3, 0x1C])
    idx = bits.search(0, 0, sync, 24)
    if idx >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] - idx < 720:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, idx, 720))
    pkt_crc = (b[88] << 8) | b[89]
    if util.crc16(bytes(b[2:88]), 86, 0x1021, 0xD895) != pkt_crc:
        return DECODE_FAIL_MIC
    serial = (b[7] << 24) | (b[8] << 16) | (b[9] << 8) | b[10]
    tamper = "0x" + "".join("%02X" % b[13 + j] for j in range(6))
    outage = "0x" + "".join("%02X" % b[21 + j] for j in range(6))
    last_consumption = (b[27] << 24) | (b[28] << 16) | (b[29] << 8) | b[30]
    diffs = []
    pos = idx + 31 * 8
    for _ in range(47):
        buffy = _ints(bits.extract_bytes(0, pos, 9)) + [0]
        diffs.append((buffy[0] << 1) | (buffy[1] >> 7))
        pos += 9
    return [Event.make(
        ("model", "IDM"),
        ("id", _s32(serial)),
        ("PacketTypeID", "0x%02X" % b[2]),
        ("PacketLength", b[3]),
        ("ApplicationVersion", b[5]),
        ("ERTType", b[6], "", "0x%02X"),
        ("ERTSerialNumber", _s32(serial)),
        ("ConsumptionIntervalCount", b[11]),
        ("ModuleProgrammingState", b[12], "", "0x%02X"),
        ("TamperCounters", tamper),
        ("AsynchronousCounters", (b[19] << 8) | b[20], "", "0x%02X"),
        ("PowerOutageFlags", outage),
        ("LastConsumptionCount", _s32(last_consumption), "", "%u"),
        ("DifferentialConsumptionIntervals", diffs),
        ("TransmitTimeOffset", (b[84] << 8) | b[85]),
        ("MeterIdCRC", (b[86] << 8) | b[87], "", "0x%04X"),
        ("PacketCRC", pkt_crc, "", "0x%04X"),
        ("MeterType", _ert_meter_type(b[6]), "Meter_Type"),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("ert_netidm")
def ert_netidm(bits, dev):
    """ERT NetIDM (ref src/devices/ert_idm.c:300-520)."""
    if bits.bits_per_row[0] < 720:
        return DECODE_ABORT_LENGTH
    sync = bytes([0x16, 0xA3, 0x1C])
    idx = bits.search(0, 0, sync, 24)
    if idx >= bits.bits_per_row[0]:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] - idx < 720:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.extract_bytes(0, idx, 720))
    pkt_crc = (b[88] << 8) | b[89]
    if util.crc16(bytes(b[2:88]), 86, 0x1021, 0xD895) != pkt_crc:
        return DECODE_FAIL_MIC
    serial = (b[7] << 24) | (b[8] << 16) | (b[9] << 8) | b[10]
    tamper = "0x" + "".join("%02X" % b[13 + j] for j in range(6))
    unknown1 = "0x" + "".join("%02X" % b[19 + j] for j in range(7))
    unknown2 = "0x" + "".join("%02X" % b[29 + j] for j in range(3))
    last_gen = (b[26] << 16) | (b[27] << 8) | b[28]
    last_consumption = (b[32] << 24) | (b[33] << 16) | (b[34] << 8) | b[35]
    diffs = []
    pos = idx + 36 * 8
    for _ in range(27):
        buffy = _ints(bits.extract_bytes(0, pos, 14)) + [0]
        diffs.append((buffy[0] << 6) | (buffy[1] >> 2))
        pos += 14
    return [Event.make(
        ("model", "NETIDM"),
        ("id", _s32(serial)),
        ("PacketTypeID", "0x%02X" % b[2]),
        ("PacketLength", b[3]),
        ("ApplicationVersion", b[5]),
        ("ERTType", b[6], "", "0x%02X"),
        ("ERTSerialNumber", _s32(serial)),
        ("ConsumptionIntervalCount", b[11]),
        ("ModuleProgrammingState", b[12], "", "0x%02X"),
        ("TamperCounters", tamper),
        ("Unknown_field_1", unknown1),
        ("LastGenerationCount", last_gen, "", "%u"),
        ("Unknown_field_2", unknown2),
        ("LastConsumptionCount", _s32(last_consumption), "", "%u"),
        ("DifferentialConsumptionIntervals", diffs),
        ("TransmitTimeOffset", (b[84] << 8) | b[85]),
        ("MeterIdCRC", (b[86] << 8) | b[87], "", "0x%04X"),
        ("PacketCRC", pkt_crc, "", "0x%04X"),
        ("MeterType", _ert_meter_type(b[6])),
        ("mic", "CRC", "Integrity"),
    )]


@decoder("blueline")
def blueline(bits, dev):
    """BlueLine PowerCost Monitor (ref src/devices/blueline.c).

    Stateful: the transmitter id (needed to de-offset payloads) comes from
    `-R 176:<id>`, `-R 176:auto` brute-force, or an observed ID message."""
    ctx = getattr(dev, "_blueline_ctx", None)
    if ctx is None:
        ctx = {"id": 0, "searching": 0, "hits": {}}
        arg = getattr(dev, "arg", None)
        if arg == "auto":
            ctx["searching"] = 1
        elif arg:
            ctx["id"] = int(arg, 0)
        dev._blueline_ctx = ctx
    bits.invert()
    events = []
    worst = 0
    for row in range(bits.num_rows):
        if bits.bits_per_row[row] != 32:
            worst = min(worst, DECODE_ABORT_LENGTH)
            continue
        b = _ints(bits.bb[row])
        if b[0] != 0xFE:
            worst = min(worst, DECODE_ABORT_LENGTH)
            continue
        msg_type = b[1] & 0x03
        recv_crc = b[3]
        if msg_type == 0:
            calc_crc = util.crc8(bytes(b[1:3]), 2, 0x07, 0x00)
            off16 = 0
        else:
            off16 = (((b[2] << 8) | b[1]) - ctx["id"]) & 0xFFFF
            off8 = [off16 & 0xFF, off16 >> 8]
            calc_crc = util.crc8(bytes(off8), 2, 0x07, 0x00)
        if calc_crc != recv_crc:
            if ctx["searching"] and msg_type != 0:
                guess = _blueline_guess_id(ctx, b)
                if guess:
                    ctx["id"] = guess
                    ctx["searching"] = 0
            worst = min(worst, DECODE_FAIL_MIC)
            continue
        if msg_type == 0:
            rid = (b[2] << 8) | b[1]
            events.append(Event.make(
                ("model", "Blueline-PowerCost"),
                ("id", rid),
                ("mic", "CRC", "Integrity"),
            ))
            if ctx["searching"]:
                ctx["id"] = rid
                ctx["searching"] = 0
        elif msg_type == 1:
            events.append(Event.make(
                ("model", "Blueline-PowerCost"),
                ("id", ctx["id"]),
                ("gap", off16),
                ("mic", "CRC", "Integrity"),
            ))
        elif msg_type == 2:
            temperature = off16 >> 8
            flags = (off16 & 0xFF) >> 2
            battery = (flags & 0x20) >> 5
            events.append(Event.make(
                ("model", "Blueline-PowerCost"),
                ("id", ctx["id"]),
                ("flags", flags, "", "%02x"),
                ("battery_ok", int(not battery), "Battery"),
                ("temperature_C", 0.436 * temperature - 30.36,
                 "Temperature", "%.1f C"),
                ("mic", "CRC", "Integrity"),
            ))
        else:
            events.append(Event.make(
                ("model", "Blueline-PowerCost"),
                ("id", ctx["id"]),
                ("impulses", off16),
                ("mic", "CRC", "Integrity"),
            ))
    return events if events else worst


def _blueline_rev_crc8(message, poly, remainder):
    """Run a CRC-8 backwards (ref src/devices/blueline.c:128-156)."""
    poly = (poly >> 1) | 0x80
    for byte in reversed(message):
        for _ in range(8):
            if remainder & 0x01:
                remainder = (remainder >> 1) ^ poly
            else:
                remainder >>= 1
        remainder ^= byte
    return remainder


def _blueline_guess_id(ctx, row):
    """Brute-force candidate ids (ref src/devices/blueline.c:158-198)."""
    start_value = (row[2] << 8) | row[1]
    recv_crc = row[3]
    msg_type = row[1] & 0x03
    best_id = 0
    best_hits = 0
    num_at_best = 0
    hi = 0
    for _ in range(256):
        rev = _blueline_rev_crc8([0x00, (row[2] + hi) & 0xFF], 0x07, recv_crc)
        if (rev & 0x03) == msg_type:
            working = ((((row[2] + hi) & 0xFF) << 8) | rev)
            working = (start_value - working) & 0xFFFF
            key = working // 4
            ctx["hits"][key] = ctx["hits"].get(key, 0) + 1
            if ctx["hits"][key] >= best_hits:
                if ctx["hits"][key] > best_hits:
                    best_hits = ctx["hits"][key]
                    best_id = working
                    num_at_best = 1
                else:
                    num_at_best += 1
        hi += 1
    return best_id if best_hits >= 4 and num_at_best == 1 else 0


@decoder("rfxmeter")
def rfxmeter(bits, dev):
    """RFXMeter / RFXPower (ref src/devices/rfxmeter.c)."""
    if bits.num_rows not in (1, 2):
        return DECODE_ABORT_LENGTH
    row = bits.num_rows - 1
    if bits.bits_per_row[row] != 48:
        return DECODE_ABORT_LENGTH
    b = _ints(bits.bb[row])
    if (b[0] ^ 0xF0) != b[1]:
        return DECODE_FAIL_SANITY
    if (util.add_nibbles(bytes(b[:6]), 6) & 0x0F) != 0x0F:
        return DECODE_FAIL_MIC
    return [Event.make(
        ("model", "RfxMeter"),
        ("id", b[0], "Id"),
        ("msg_type", b[5] >> 4, "Msg Type"),
        ("msg_value", (b[4] << 16) | (b[2] << 8) | b[3], "Msg Value"),
        ("mic", "CHECKSUM", "Integrity"),
    )]

"""Misc decoders batch R (reference files cited per function):
Silver Spring Networks mesh endpoint.
"""

from __future__ import annotations

from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
    decoder,
)


def _ssn_crc32(data):
    """CRC-32/MPEG-2 (ref src/devices/silver_spring_mesh.c:140)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _ssn_descramble(buf, seed):
    """8-bit additive scrambler x^8+x^4+x^3+x^2+1
    (ref src/devices/silver_spring_mesh.c:153)."""
    reg = seed
    out = []
    for byte in buf:
        k = 0
        for _ in range(8):
            k = ((k << 1) | ((reg >> 7) & 1)) & 0xFF
            t = reg & 0x8E
            t ^= t >> 4
            t ^= t >> 2
            t ^= t >> 1
            reg = ((reg << 1) | (t & 1)) & 0xFF
        out.append(byte ^ k)
    return out


def _ssn_append_route(buf, length, o, parts):
    """One route advertisement object
    (ref src/devices/silver_spring_mesh.c:197)."""
    if o + 36 > length or buf[o] != 0x21:
        return 0
    count = buf[o + 28]
    total = 36 + 8 * count
    if o + total > length:
        return 0
    path_cost = (buf[o + 32] << 8) | buf[o + 33]
    link_cost = (buf[o + 34] << 8) | buf[o + 35]
    s = "hop<=%u cost=%u/%u egress=" % (buf[o + 1], path_cost, link_cost)
    s += "".join("%02x" % buf[o + 20 + k] for k in range(8))
    for n in range(count):
        s += " next=" + "".join("%02x" % buf[o + 36 + 8 * n + k]
                                for k in range(8))
    parts.append(s)
    return total


def _ssn_parse_routes(buf, length):
    parts = []
    o = 0
    while o < length:
        used = _ssn_append_route(buf, length, o, parts)
        if not used:
            break
        o += used
    return "; ".join(parts)[:383]


def _ssn_ip_sum(total, data, length):
    i = 0
    while i + 1 < length:
        total += (data[i] << 8) | data[i + 1]
        i += 2
    if i < length:
        total += data[i] << 8
    return total


def _ssn_parse_ipv6(p, length):
    """IPv6 + UDP summary (ref src/devices/silver_spring_mesh.c:267)."""
    if length < 40:
        return ""
    plen = (p[4] << 8) | p[5]
    next_hdr = p[6]
    src = p[8:24]
    dst = p[24:40]
    body = p[40:]
    if 40 + plen > length:
        return ""
    out = "[" + ":".join("%02x%02x" % (src[i], src[i + 1])
                         for i in range(0, 16, 2)) + "] -> ["
    out += ":".join("%02x%02x" % (dst[i], dst[i + 1])
                    for i in range(0, 16, 2)) + "]"
    if next_hdr == 17 and plen >= 8:
        sport = (body[0] << 8) | body[1]
        dport = (body[2] << 8) | body[3]
        ulen = (body[4] << 8) | body[5]
        if ulen <= plen:
            total = 17 + ulen
            total = _ssn_ip_sum(total, src, 16)
            total = _ssn_ip_sum(total, dst, 16)
            total = _ssn_ip_sum(total, body, ulen)
            while total >> 16:
                total = (total & 0xFFFF) + (total >> 16)
            cksum_ok = (total & 0xFFFF) == 0xFFFF
            out += " %u->%u len=%u cksum=%s" % (sport, dport, ulen,
                                                "ok" if cksum_ok else "bad")
            if dport == 648 and ulen >= 14:
                out += " mgmt_len=%u" % ((body[12] << 8) | body[13])
    return out[:255]


def _ssn_parse_mpdu16(v, vlen, extras):
    """MPDU type 16 payload (ref src/devices/silver_spring_mesh.c:322)."""
    if vlen < 1:
        return
    if v[0] == 0x21:
        extras["routes"] = _ssn_parse_routes(v, vlen)
        return
    if vlen < 4:
        return
    pid = v[0] & 0x0F
    addr_cnt = v[3] & 0x3F
    hdr_len = 4 + 8 * addr_cnt
    if hdr_len > vlen:
        return
    payload = v[hdr_len:]
    payload_len = vlen - hdr_len
    if pid == 3:
        extras["routes"] = _ssn_parse_routes(payload, payload_len)
    elif pid == 6:
        extras["ipv6"] = _ssn_parse_ipv6(payload, payload_len)


def _ssn_append_tlv(psdu, length, i, parts, extras):
    """One TLV record (ref src/devices/silver_spring_mesh.c:356).
    Returns (used, type, is_dll)."""
    if i + 2 > length:
        return 0, 0, 0
    h0 = psdu[i]
    h1 = psdu[i + 1]
    is_mpdu = (h0 & 0x80) != 0
    tlv_type = (h0 >> 3) if is_mpdu else ((h0 << 1) | (h1 >> 7))
    vlen = (((h0 & 0x07) << 8) | h1) if is_mpdu else (h1 & 0x7F)
    if i + 2 + vlen > length:
        return 0, 0, 0
    val = psdu[i + 2:i + 2 + vlen]
    s = "%s%u/%u" % ("M" if is_mpdu else "D", tlv_type, vlen)
    if is_mpdu and tlv_type == 17 and vlen > 0:
        nested = []
        _ssn_append_tlv(psdu, i + 2 + vlen, i + 2, nested, None)
        s += "{" + " ".join(nested) + "}"
    parts.append(s)
    if extras is not None:
        if is_mpdu:
            extras["seen_mpdu"] = 1
            if tlv_type == 16:
                _ssn_parse_mpdu16(val, vlen, extras)
        elif tlv_type == 2:
            extras["seen_dll2"] = 1
            if vlen == 3:
                raw = (val[0] << 16) | (val[1] << 8) | val[2]
                extras["cli"] = ((raw >> 21) & 0x7, (raw >> 12) & 0x1FF,
                                 (raw >> 9) & 0x7, raw & 0x1FF)
        elif tlv_type == 4:
            extras["seen_dll4"] = 1
            if vlen == 2:
                raw = (val[0] << 8) | val[1]
                extras["seq"] = ((raw >> 15) & 1, (raw >> 14) & 1,
                                 (raw >> 10) & 0xF, raw & 0x3FF)
        elif tlv_type == 9:
            extras["seen_dll9"] = 1
            if vlen == 1:
                extras["rssi"] = val[0] - 256 if val[0] >= 128 else val[0]
        elif tlv_type == 1:
            if vlen == 2:
                extras["fet"] = (val[0] << 8) | val[1]
        elif tlv_type == 8:
            if vlen == 5:
                extras["sync_channel"] = val[4]
    return 2 + vlen, tlv_type, not is_mpdu


def _ssn_parse_tlvs(psdu, psdu_len, start, extras):
    """TLV stream walk (ref src/devices/silver_spring_mesh.c:445)."""
    parts = []
    i = start
    saw_crc_marker = False
    while i < psdu_len:
        used, tlv_type, is_dll = _ssn_append_tlv(psdu, psdu_len, i, parts,
                                                 extras)
        if not used:
            break
        i += used
        if is_dll and tlv_type == 6:
            saw_crc_marker = True
            continue
        if is_dll and tlv_type == 5:
            out = " ".join(parts)
            if i < psdu_len:
                out += " +%uB" % (psdu_len - i)
            return out[:255]
    out = " ".join(parts)
    if saw_crc_marker and i + 4 == psdu_len:
        want = (psdu[i] << 24) | (psdu[i + 1] << 16) | (psdu[i + 2] << 8) \
            | psdu[i + 3]
        got = _ssn_crc32(psdu[:i])
        out += (" " if out else "") + (":ok" if got == want else ":bad")
    elif i < psdu_len:
        out += (" " if out else "") + "+%uB" % (psdu_len - i)
    return out[:255]


def _ssn_classify_link(fctrl, extras):
    """Link role (ref src/devices/silver_spring_mesh.c:501)."""
    if fctrl == 2:
        return "broadcast"
    if fctrl == 3:
        return "poll"
    if fctrl == 1:
        if extras.get("seen_dll4") or extras.get("seen_mpdu"):
            return "data"
        if extras.get("seen_dll2"):
            return "poll_ack"
        if extras.get("seen_dll9"):
            return "data_ack"
    return ""


@decoder("silver_spring_mesh")
def silver_spring_mesh(bits, dev):
    """Silver Spring Networks mesh endpoint
    (ref src/devices/silver_spring_mesh.c:523)."""
    sync = bytes([0xAA, 0xAA, 0x18, 0xBF])
    if bits.num_rows != 1:
        return DECODE_ABORT_EARLY
    pos = bits.search(0, 0, sync, 32)
    if pos >= bits.bits_per_row[0]:
        bits.invert()
        pos = bits.search(0, 0, sync, 32)
        if pos >= bits.bits_per_row[0]:
            return DECODE_ABORT_EARLY
    frame_start = pos + 32 - 1
    avail_bits = bits.bits_per_row[0] - frame_start
    if avail_bits < 7 * 8:
        return DECODE_ABORT_LENGTH
    avail_bytes = min(avail_bits // 8, 512)
    # canonical frame = bit-complement of the matched polarity
    frame = [int(x) ^ 0xFF for x in
             bits.extract_bytes(0, frame_start, avail_bytes * 8)]
    if frame[1] & 0xF8:
        return DECODE_FAIL_SANITY
    channel = frame[0]
    psdu_len = ((frame[1] & 0x07) << 8) | frame[2]
    frame_len = 3 + psdu_len + 4
    if psdu_len < 1 or frame_len > avail_bytes:
        return DECODE_ABORT_LENGTH
    scr = frame[3:3 + psdu_len + 4]
    seed_found = -1
    psdu = None
    for seed in range(1, 256):
        cand = _ssn_descramble(scr, seed)
        fcs = (cand[psdu_len] << 24) | (cand[psdu_len + 1] << 16) \
            | (cand[psdu_len + 2] << 8) | cand[psdu_len + 3]
        if _ssn_crc32(cand[:psdu_len]) == fcs:
            seed_found = seed
            psdu = cand
            break
    if seed_found < 0:
        return DECODE_FAIL_MIC
    psdu_str = "".join("%02x" % x for x in psdu[:psdu_len])
    fctrl = psdu[0]
    addr_off = 1
    dst_str = ""
    src_str = ""
    if (fctrl & 0x01) and addr_off + 8 <= psdu_len:
        dst_str = "".join("%02x" % x for x in psdu[addr_off:addr_off + 8])
        addr_off += 8
    if (fctrl & 0x02) and addr_off + 8 <= psdu_len:
        src_str = "".join("%02x" % x for x in psdu[addr_off:addr_off + 8])
        addr_off += 8
    extras = {}
    tlv_str = _ssn_parse_tlvs(psdu, psdu_len, addr_off, extras)
    link = _ssn_classify_link(fctrl, extras)
    seq = extras.get("seq")
    cli = extras.get("cli")
    return [Event.make(
        ("model", "SilverSpring-Mesh"),
        ("dst_id", dst_str, "Destination EUI-64") if dst_str else None,
        ("src_id", src_str, "Source EUI-64") if src_str else None,
        ("channel", channel, "RF channel"),
        ("seed", seed_found, "Scrambler seed", "%02x"),
        ("len", psdu_len, "PSDU bytes"),
        ("link", link, "Link role") if link else None,
        ("seq_num", seq[3], "Sequence num") if seq else None,
        ("frag_num", seq[2], "Fragment num") if seq else None,
        ("frag_more", seq[1], "More fragments") if seq else None,
        ("retry", seq[0], "Retry") if seq else None,
        ("fet", extras["fet"], "Epoch tick") if "fet" in extras else None,
        ("rssi", extras["rssi"], "RSSI") if "rssi" in extras else None,
        ("cli_tx_pri", cli[0], "CLI tx prio") if cli else None,
        ("cli_tx_time", cli[1], "CLI tx time") if cli else None,
        ("cli_rx_pri", cli[2], "CLI rx prio") if cli else None,
        ("cli_rx_time", cli[3], "CLI rx time") if cli else None,
        ("sync_channel", extras["sync_channel"], "Sync channel")
        if "sync_channel" in extras else None,
        ("routes", extras["routes"], "Route adverts")
        if extras.get("routes") else None,
        ("ipv6", extras["ipv6"], "IPv6/UDP")
        if extras.get("ipv6") else None,
        ("tlvs", tlv_str, "TLV records") if tlv_str else None,
        ("data", psdu_str, "PSDU"),
        ("mic", "CRC", "Integrity"),
    )]

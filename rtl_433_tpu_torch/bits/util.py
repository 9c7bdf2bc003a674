"""Bit/byte utilities: reversal, UART framing, CRC, LFSR digests, whitening.

Behavioral parity with rtl_433's bit utilities (see reference
``src/bit_util.c``: crc4/7/8/8le/16/16lsb at :240-351, lfsr digests at
:353-457, whitening at :463-505, parity/xor/add at :542-583, UART extract at
:74-180). Host-side implementations in plain Python/numpy; the batched digests of
the MIC kernel are ops/mic.py.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# bit reversal / reflection

_REV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def reverse8(x: int) -> int:
    """Reverse the bits of a byte. Ref src/bit_util.c:18."""
    return int(_REV8[x & 0xFF])


def reverse32(x: int) -> int:
    """Reverse bits of a 32-bit word, byte-order preserved view semantics.

    Ref src/bit_util.c:26: bytes of the little-endian representation are
    each bit-reversed and reassembled MSB-first, i.e. a full 32-bit bit
    reversal of the little-endian word read back as big-endian — which
    equals a plain 32-bit bit reversal on any endianness-free integer.
    """
    b = [(x >> (8 * i)) & 0xFF for i in range(4)]
    return (reverse8(b[0]) << 24) | (reverse8(b[1]) << 16) | (reverse8(b[2]) << 8) | reverse8(b[3])


def reflect_bytes(msg) -> np.ndarray:
    """Bit-reverse every byte. Ref src/bit_util.c:34."""
    return _REV8[np.asarray(bytearray(msg), dtype=np.uint8)]


def reflect4(x: int) -> int:
    """Swap nibble bit order within each nibble. Ref src/bit_util.c:41."""
    x = (x & 0xCC) >> 2 | (x & 0x33) << 2
    x = (x & 0xAA) >> 1 | (x & 0x55) << 1
    return x & 0xFF


def reflect_nibbles(msg) -> np.ndarray:
    """Ref src/bit_util.c:48."""
    a = np.asarray(bytearray(msg), dtype=np.uint8)
    return np.array([reflect4(int(v)) for v in a], dtype=np.uint8)


def invert_bytes(msg) -> np.ndarray:
    a = np.asarray(bytearray(msg), dtype=np.uint8)
    return (~a).astype(np.uint8)


# ---------------------------------------------------------------------------
# bit access helpers

def bit_at(msg, pos: int) -> int:
    """MSB-first bit at absolute bit position ``pos``."""
    return (msg[pos >> 3] >> (7 - (pos & 7))) & 1


# ---------------------------------------------------------------------------
# UART / symbol extraction

def extract_nibbles_4b1s(message, offset_bits: int, num_bits: int):
    """4-bit nibbles with a trailing stuff bit '1'. Ref src/bit_util.c:55."""
    out = []
    message = bytes(bytearray(message))
    while num_bits >= 5:
        bits = (message[offset_bits // 8] << 8)
        bits |= message[offset_bits // 8 + 1] if offset_bits // 8 + 1 < len(message) else 0
        bits >>= 11 - (offset_bits % 8)
        if (bits & 1) != 1:
            break
        out.append((bits >> 1) & 0xF)
        offset_bits += 5
        num_bits -= 5
    return out


def extract_bytes_uart_8n1(message, offset_bits: int, num_bits: int):
    """8n1 little-endian UART frames -> bytes. Ref src/bit_util.c:74."""
    out = []
    message = bytes(bytearray(message))

    def _bit(p):
        return (message[p // 8] >> (7 - (p % 8))) & 1

    def _byte(p):
        d = message[p // 8]
        if p % 8:
            d = ((message[p // 8] << 8) | message[p // 8 + 1]) >> (8 - (p % 8))
        return d & 0xFF

    while num_bits >= 10:
        if _bit(offset_bits) != 0:
            break
        data = _byte(offset_bits + 1)
        if _bit(offset_bits + 9) != 1:
            break
        out.append(reverse8(data))
        offset_bits += 10
        num_bits -= 10
    return out


def extract_bytes_uart_8n2(message, offset_bits: int, num_bits: int):
    """8n2 frames, skipping to the first start bit. Ref src/bit_util.c:103."""
    out = []
    message = bytes(bytearray(message))

    def _bit(p):
        return (message[p // 8] >> (7 - (p % 8))) & 1

    def _byte(p):
        d = message[p // 8]
        if p % 8:
            d = ((message[p // 8] << 8) | message[p // 8 + 1]) >> (8 - (p % 8))
        return d & 0xFF

    while num_bits > 11:
        if _bit(offset_bits) == 0:
            break
        offset_bits += 1
        num_bits -= 1
    while num_bits >= 11:
        if _bit(offset_bits) != 0:
            break
        data = _byte(offset_bits + 1)
        if _bit(offset_bits + 9) != 1 or _bit(offset_bits + 10) != 1:
            break
        out.append(reverse8(data))
        offset_bits += 11
        num_bits -= 11
    return out


def extract_bytes_uart_8o1(message, offset_bits: int, num_bits: int):
    """8o1 frames (inverted logic, odd parity). Ref src/bit_util.c:147."""
    out = []
    message = bytes(bytearray(message))

    def _bit(p):
        return (message[p // 8] >> (7 - (p % 8))) & 1

    def _byte(p):
        d = message[p // 8]
        if p % 8:
            d = ((message[p // 8] << 8) | message[p // 8 + 1]) >> (8 - (p % 8))
        return d & 0xFF

    while num_bits >= 11:
        if _bit(offset_bits) != 1:
            break
        data = _byte(offset_bits + 1)
        if _bit(offset_bits + 9) != parity8(data):
            break
        if _bit(offset_bits + 10) != 0:
            break
        out.append(data)
        offset_bits += 11
        num_bits -= 11
    return out


def _symbol_match(message, offset_bits, num_bits, symbol):
    """Ref src/bit_util.c:182."""
    symbol_len = symbol & 0x1F
    if num_bits < symbol_len:
        return 0
    for pos in range(symbol_len):
        m_bit = bit_at(message, offset_bits + pos)
        s_bit = (symbol >> (31 - pos)) & 1
        if m_bit != s_bit:
            return 0
    return symbol_len


def extract_bits_symbols(message, offset_bits: int, num_bits: int,
                         zero: int, one: int, sync: int):
    """Symbol-coded bit extraction; returns (bits list MSB-first). Ref src/bit_util.c:204."""
    out_bits = []
    message = bytes(bytearray(message))
    while num_bits >= 1:
        n = _symbol_match(message, offset_bits, num_bits, sync)
        if n:
            offset_bits += n
            num_bits -= n
            continue
        n = _symbol_match(message, offset_bits, num_bits, zero)
        if n:
            offset_bits += n
            num_bits -= n
            out_bits.append(0)
            continue
        n = _symbol_match(message, offset_bits, num_bits, one)
        if n:
            offset_bits += n
            num_bits -= n
            out_bits.append(1)
            continue
        break
    return out_bits


# ---------------------------------------------------------------------------
# CRCs (generic bitwise, MSB- and LSB-first)

def crc4(message, nbytes: int, polynomial: int, init: int) -> int:
    """Ref src/bit_util.c:240 (works on the high nibble internally)."""
    remainder = (init << 4) & 0xFF
    poly = (polynomial << 4) & 0xFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= byte
        for _ in range(8):
            if remainder & 0x80:
                remainder = ((remainder << 1) ^ poly) & 0xFF
            else:
                remainder = (remainder << 1) & 0xFF
    return (remainder >> 4) & 0x0F


def crc7(message, nbytes: int, polynomial: int, init: int) -> int:
    """Ref src/bit_util.c:259."""
    remainder = (init << 1) & 0xFF
    poly = (polynomial << 1) & 0xFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= byte
        for _ in range(8):
            if remainder & 0x80:
                remainder = ((remainder << 1) ^ poly) & 0xFF
            else:
                remainder = (remainder << 1) & 0xFF
    return (remainder >> 1) & 0x7F


def crc8(message, nbytes: int, polynomial: int, init: int) -> int:
    """MSB-first CRC-8. Ref src/bit_util.c:278."""
    remainder = init & 0xFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= byte
        for _ in range(8):
            if remainder & 0x80:
                remainder = ((remainder << 1) ^ polynomial) & 0xFF
            else:
                remainder = (remainder << 1) & 0xFF
    return remainder


def crc8le(message, nbytes: int, polynomial: int, init: int) -> int:
    """LSB-first (reflected) CRC-8. Ref src/bit_util.c:296."""
    remainder = reverse8(init)
    poly = reverse8(polynomial)
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= byte
        for _ in range(8):
            if remainder & 1:
                remainder = (remainder >> 1) ^ poly
            else:
                remainder >>= 1
    return remainder & 0xFF


def crc16lsb(message, nbytes: int, polynomial: int, init: int) -> int:
    """LSB-first CRC-16. Ref src/bit_util.c:315."""
    remainder = init & 0xFFFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= byte
        for _ in range(8):
            if remainder & 1:
                remainder = (remainder >> 1) ^ polynomial
            else:
                remainder >>= 1
            remainder &= 0xFFFF
    return remainder


def crc16(message, nbytes: int, polynomial: int, init: int) -> int:
    """MSB-first CRC-16. Ref src/bit_util.c:334."""
    remainder = init & 0xFFFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        remainder ^= (byte << 8)
        remainder &= 0xFFFF
        for _ in range(8):
            if remainder & 0x8000:
                remainder = ((remainder << 1) ^ polynomial) & 0xFFFF
            else:
                remainder = (remainder << 1) & 0xFFFF
    return remainder


# ---------------------------------------------------------------------------
# Galois LFSR digests

def lfsr_digest8(message, nbytes: int, gen: int, key: int) -> int:
    """Ref src/bit_util.c:353."""
    s = 0
    key &= 0xFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        for i in range(7, -1, -1):
            if (byte >> i) & 1:
                s ^= key
            if key & 1:
                key = ((key >> 1) ^ gen) & 0xFF
            else:
                key >>= 1
    return s & 0xFF


def lfsr_digest8_reverse(message, nbytes: int, gen: int, key: int) -> int:
    """Process last byte to first, bits MSB->LSB. Ref src/bit_util.c:380."""
    s = 0
    key &= 0xFF
    message = bytes(bytearray(message))
    for k in range(nbytes - 1, -1, -1):
        byte = message[k]
        for i in range(7, -1, -1):
            if (byte >> i) & 1:
                s ^= key
            if key & 1:
                key = ((key >> 1) ^ gen) & 0xFF
            else:
                key >>= 1
    return s & 0xFF


def lfsr_digest8_reflect(message, nbytes: int, gen: int, key: int) -> int:
    """Process last byte to first, bits LSB->MSB, key rolls left. Ref src/bit_util.c:407."""
    s = 0
    key &= 0xFF
    message = bytes(bytearray(message))
    for k in range(nbytes - 1, -1, -1):
        byte = message[k]
        for i in range(8):
            if (byte >> i) & 1:
                s ^= key
            if key & 0x80:
                key = ((key << 1) ^ gen) & 0xFF
            else:
                key = (key << 1) & 0xFF
    return s & 0xFF


def lfsr_digest16(message, nbytes: int, gen: int, key: int) -> int:
    """Ref src/bit_util.c:434."""
    s = 0
    key &= 0xFFFF
    message = bytes(bytearray(message))
    for byte in message[:nbytes]:
        for i in range(7, -1, -1):
            if (byte >> i) & 1:
                s ^= key
            if key & 1:
                key = ((key >> 1) ^ gen) & 0xFFFF
            else:
                key >>= 1
    return s & 0xFFFF


# ---------------------------------------------------------------------------
# data whitening (9-bit LFSR x^9 + x^5 + 1, init 0x1FF)

def ccitt_whitening(buf) -> np.ndarray:
    """Byte-wise CCITT whitening. Ref src/bit_util.c:463."""
    out = np.asarray(bytearray(buf), dtype=np.uint8).copy()
    key_msb, key_lsb = 0x01, 0xFF
    for pos in range(len(out)):
        out[pos] ^= reverse8(key_lsb)
        for _ in range(8):
            key_msb_prev = key_msb
            key_msb = (key_lsb & 1) ^ ((key_lsb >> 5) & 1)
            key_lsb = ((key_msb_prev << 7) & 0x80) | (key_lsb >> 1)
    return out


def ibm_whitening(buf) -> np.ndarray:
    """Bit-wise IBM whitening. Ref src/bit_util.c:491."""
    out = np.asarray(bytearray(buf), dtype=np.uint8).copy()
    key_msb, key_lsb = 0x01, 0xFF
    for pos in range(len(out)):
        out[pos] ^= key_lsb
        for _ in range(8):
            key_msb_prev = key_msb
            key_msb = (key_lsb & 1) ^ ((key_lsb >> 5) & 1)
            key_lsb = (key_lsb >> 1) | ((key_msb_prev << 7) & 0x80)
    return out


# ---------------------------------------------------------------------------
# parity / checksums

def parity8(byte: int) -> int:
    """Ref src/bit_util.c:542."""
    byte ^= byte >> 4
    byte &= 0xF
    return (0x6996 >> byte) & 1


def parity_bytes(message, nbytes: int = None) -> int:
    message = bytes(bytearray(message))
    if nbytes is None:
        nbytes = len(message)
    r = 0
    for b in message[:nbytes]:
        r ^= parity8(b)
    return r


def xor_bytes(message, nbytes: int = None) -> int:
    message = bytes(bytearray(message))
    if nbytes is None:
        nbytes = len(message)
    r = 0
    for b in message[:nbytes]:
        r ^= b
    return r


def add_bytes(message, nbytes: int = None) -> int:
    message = bytes(bytearray(message))
    if nbytes is None:
        nbytes = len(message)
    return int(sum(message[:nbytes]))


def add_nibbles(message, nbytes: int = None) -> int:
    message = bytes(bytearray(message))
    if nbytes is None:
        nbytes = len(message)
    return int(sum((b >> 4) + (b & 0x0F) for b in message[:nbytes]))

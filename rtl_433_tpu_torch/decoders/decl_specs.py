"""Declarative decoder spec table.

Each spec cites the reference decoder it mirrors; the Python twin in this
package stays registered and is the differential oracle
(tests/test_declarative.py fuzzes every spec against it, and
tests/test_torch_fast_dispatch.py holds this copy to that one). See
decoders/declarative.py for the IR and ops/decode_bank.py for the kernel.
"""

from .declarative import (Check, DeclSpec, F, Raw, San, Variant, _spec)
from .base import DECODE_ABORT_EARLY, DECODE_ABORT_LENGTH


_spec(DeclSpec(
    # Nexus-TH/T (ref src/devices/nexus.c:44-140; decoders/protocols.py
    # _nexus_like): 36-bit row repeated 3x, type nibble F, 12-bit signed
    # temperature, humidity 0 = Nexus-T
    symbol="nexus",
    min_bits=36, max_bits=37, row_mode="repeat", min_repeats=3,
    repeat_min_bits=36, frame_bits=40, in_bits=296,
    # reject the Rubicson CRC coincidence (ref src/devices/nexus.c:77-88):
    # crc8(poly 0x31, init 0x6C) over the 40-bit window
    # [b0, b1, b2, b3&F0, (b3&0F)<<4 | (b4&F0)>>4] must be NONZERO
    checks=(Check("crc8", off=0, nbytes=5, p1=0x31, p2=0x6C,
                  cmp_const=0, negated=True,
                  bit_map=tuple(range(28)) + (-1,) * 4
                  + tuple(range(28, 36))),),
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 1),          # 1 battery
          Raw(10, 2),         # 2 channel-1 (and the != 3 guard)
          Raw(12, 12),        # 3 temperature raw (signed 12)
          Raw(28, 8),         # 4 humidity
          Raw(9, 1),          # 5 test
          Raw(24, 4),         # 6 type nibble (must be F)
          # 7: b0|b2|b3 combined — the all-0 / all-FF guards
          Raw(0, 24, bit_order=tuple(range(0, 8)) + tuple(range(16, 32)))),
    sanity=(San(6, "eq", 0xF),
            San(2, "ne", 0x3),
            San(7, "ne", 0x000000),
            San(7, "ne", 0xFFFFFF),
            San(4, "le", 100),),
    variants=(
        Variant(cond=San(4, "eq", 0), fields=(
            F("model", "const", value="Nexus-T"),
            F("id", terms=((0, 1, 0),), pretty="House Code"),
            F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
            F("battery_ok", kind="bool", terms=((1, 1, 0),),
              pretty="Battery"),
            F("temperature_C", kind="float", terms=((3, 1, 12),),
              mul=0.1, pretty="Temperature", fmt="%.2f C"),
            F("test", kind="bool", terms=((5, 1, 0),), pretty="Test?",
              cond=San(5, "ne", 0)),
        )),
        Variant(fields=(
            F("model", "const", value="Nexus-TH"),
            F("id", terms=((0, 1, 0),), pretty="House Code"),
            F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
            F("battery_ok", kind="bool", terms=((1, 1, 0),),
              pretty="Battery"),
            F("temperature_C", kind="float", terms=((3, 1, 12),),
              mul=0.1, pretty="Temperature", fmt="%.2f C"),
            F("humidity", terms=((4, 1, 0),), pretty="Humidity",
              fmt="%u %%"),
            F("test", kind="bool", terms=((5, 1, 0),), pretty="Test?",
              cond=San(5, "ne", 0)),
        )),
    ),
))


_spec(DeclSpec(
    # Jasco-Security (ref src/devices/jasco.c; decoders/misc_a.py jasco):
    # fc0c preamble, Manchester, 4-byte XOR checksum
    symbol="jasco",
    min_bits=80, max_bits=87, row_mode="row0",
    preamble="1111110000001100", need_bits=64,
    # frame_bits covers the RAW window; Manchester halves it, so checks
    # and raws below address DECODED bit positions (0..31)
    transform="manchester", mc_min=32, frame_bits=64, in_bits=160,
    checks=(Check("xor_bytes", off=0, nbytes=4, cmp_const=0),),
    raws=(Raw(0, 16),         # 0 id
          Raw(16, 8)),        # 1 b2 (status source)
    variants=(Variant(fields=(
        F("model", "const", value="Jasco-Security"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("status", kind="eq", terms=((1, 1, 0),), mask=0xEF, val=0xEF,
          pretty="Closed"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))

# ---------------------------------------------------------------------------
# OOK PPM/PWM sensor family
# ---------------------------------------------------------------------------

_spec(DeclSpec(
    # Silvercrest remote (ref src/devices/silvercrest.c:19-49;
    # decoders/protocols.py silvercrest): row 1 is 33 bits, 7c26 prefix,
    # button nibble validated via a lookup pair table
    symbol="silvercrest",
    min_bits=33, max_bits=33, row_mode="fixed", fixed_row=1,
    exact_lens=(33,), frame_bits=33, in_bits=64,
    raws=(Raw(0, 16),                                  # 0 prefix
          Raw(20, 4),                                  # 1 cmd
          # 2: (cmd << 4) | check nibble
          Raw(0, 8, bit_order=tuple(range(20, 24)) + tuple(range(28, 32)))),
    sanity=(San(0, "eq", 0x7C26),
            San(2, "in", (0x02, 0x13, 0x20, 0x31, 0x44, 0x55, 0x67, 0x76,
                          0x8C, 0x9D, 0xAF, 0xBE, 0xC8, 0xD9, 0xEB, 0xFA)),),
    variants=(Variant(fields=(
        F("model", "const", value="Silvercrest-Remote"),
        F("button", terms=((1, 1, 0),)),
    )),),
))


_RUBICSON_CRC = Check(
    # crc8(0x31, 0x6c) over [b0, b1, b2, b3&F0, (b3&0F)<<4 | (b4&F0)>>4]
    # (ref src/devices/rubicson.c)
    "crc8", off=0, nbytes=5, p1=0x31, p2=0x6C, cmp_const=0,
    bit_map=tuple(range(28)) + (-1,) * 4 + tuple(range(28, 36)))

_spec(DeclSpec(
    # Rubicson temperature (ref src/devices/rubicson.c; protocols.py)
    symbol="rubicson",
    min_bits=36, max_bits=38, row_mode="repeat", min_repeats=3,
    repeat_min_bits=36, frame_bits=40, in_bits=296,
    checks=(_RUBICSON_CRC,),
    raws=(Raw(0, 8), Raw(8, 1), Raw(10, 2), Raw(12, 12), Raw(24, 4)),
    sanity=(San(4, "eq", 0xF),),
    variants=(Variant(fields=(
        F("model", "const", value="Rubicson-Temperature"),
        F("id", terms=((0, 1, 0),), pretty="House Code"),
        F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", kind="bool", terms=((1, 1, 0),), pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _prologue_guard(bits):
    # short noise row 0 aborts the whole package (ref src/devices/prologue.c)
    if 0 < bits.bits_per_row[0] <= 8:
        return DECODE_ABORT_EARLY
    return None


_spec(DeclSpec(
    # Prologue/ThermoPro-TX2 (ref src/devices/prologue.c; protocols.py)
    symbol="prologue",
    min_bits=36, max_bits=37, row_mode="repeat", min_repeats=4,
    repeat_min_bits=36, host_guard=_prologue_guard,
    frame_bits=40, in_bits=296,
    raws=(Raw(0, 4),          # 0 type
          Raw(4, 8),          # 1 id
          Raw(12, 1),         # 2 battery
          Raw(13, 1),         # 3 button
          Raw(14, 2),         # 4 channel-1
          Raw(16, 12),        # 5 temp (signed 12)
          Raw(28, 8)),        # 6 humidity
    sanity=(San(0, "in", (0x9, 0x5)),),
    variants=(Variant(fields=(
        F("model", "const", value="Prologue-TH"),
        F("subtype", terms=((0, 1, 0),)),
        F("id", terms=((1, 1, 0),)),
        F("channel", terms=((4, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", kind="bool", terms=((2, 1, 0),), pretty="Battery"),
        F("temperature_C", kind="float", terms=((5, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.2f C"),
        F("humidity", terms=((6, 1, 0),), pretty="Humidity", fmt="%u %%",
          cond=San(6, "ne", 0xCC)),
        F("button", terms=((3, 1, 0),), pretty="Button"),
    )),),
))


_spec(DeclSpec(
    # Waveman switch (ref src/devices/waveman.c:26-85; protocols.py):
    # 25-bit row, every even bit set, pair-coded inverted nibbles
    symbol="waveman",
    min_bits=25, max_bits=25, row_mode="row0", exact_lens=(25,),
    frame_bits=25, in_bits=64,
    raws=(Raw(0, 24),                                        # 0 all-FF guard
          Raw(0, 12, bit_order=tuple(j for j in range(24)   # 1 even bits
                                     if j % 2 == 0)),
          Raw(0, 4, bit_order=(7, 5, 3, 1)),                 # 2 ~nb0
          Raw(0, 2, bit_order=(15, 13)),                     # 3 ~nb1 hi
          Raw(0, 2, bit_order=(11, 9)),                      # 4 ~nb1 lo
          Raw(0, 4, bit_order=(23, 21, 19, 17))),            # 5 ~nb2
    sanity=(San(0, "ne", 0xFFFFFF),
            San(1, "eq", 0xFFF),
            # nb2 = 0xF - raw in {0xE, 0x6} -> raw in {1, 9}
            San(5, "in", (1, 9)),),
    variants=(Variant(fields=(
        F("model", "const", value="Waveman-Switch"),
        F("id", kind="enum", terms=((2, -1, 0),), add=0xF,
          map={i: chr(ord("A") + i) for i in range(16)}),
        # nb1 = 0xF - (4*hi + lo): (nb1 >> 2) + 1 = (3 - hi) + 1,
        # (nb1 & 3) + 1 = (3 - lo) + 1
        F("channel", kind="int", terms=((3, -1, 0),), add=4),
        F("button", kind="int", terms=((4, -1, 0),), add=4),
        F("state", kind="enum", terms=((5, -1, 0),), add=0xF,
          map={0xE: "ON", 0x6: "OFF"}),
    )),),
))


def _min_rows_guard(n):
    def guard(bits):
        if bits.num_rows < n:
            return DECODE_ABORT_EARLY
        return None
    return guard


_spec(DeclSpec(
    # GT-WT-02 (ref src/devices/gt_wt_02.c:44-141; temperature.py):
    # 37-bit rows (39 = 2 lead bits), nibble-sum-mod-64 checksum,
    # first decodable row wins
    symbol="gt_wt_02",
    min_bits=37, max_bits=39, exact_lens=(37, 39),
    len_aligns=((39, 2),), row_mode="any",
    host_guard=_min_rows_guard(2),
    frame_bits=40, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=4, mask=0x3F,
                  cmp_off=31, cmp_width=6,
                  bit_map=tuple(range(31)) + (-1,)),),
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 1),          # 1 battery_low
          Raw(9, 1),          # 2 button
          Raw(10, 2),         # 3 channel
          Raw(12, 12),        # 4 temp signed
          Raw(24, 7),         # 5 hum_raw
          Raw(0, 32),         # 6 nonzero guard (b0..b3)
          Raw(32, 8)),        # 7 nonzero guard (b4)
    sanity=((San(6, "ne", 0), San(7, "ne", 0)),   # OR-group: any(b[:5])
            San(3, "le", 2),
            San(4, "ge", -20.0, signed_bits=12, fmul=0.1),
            San(4, "le", 60.0, signed_bits=12, fmul=0.1),
            San(5, "in", (10, 110) + tuple(range(20, 91))),),
    variants=(Variant(fields=(
        F("model", "const", value="GT-WT02"),
        F("id", terms=((0, 1, 0),), pretty="ID Code"),
        F("channel", terms=((3, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((1, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((4, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", kind="mapf", terms=((5, 1, 0),),
          map={10: 0, 110: 100}, pretty="Humidity", fmt="%.0f %%"),
        F("button", terms=((2, 1, 0),), pretty="Button "),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


# CRC-4(0x3) xor-folded check shared by s3318p / kedsum / esperanza_ews
# (ref src/devices/s3318p.c:85-88): crc4(b[:4]) ^ (b4 >> 4) == b4 & 0xF
_S3318_CRC = Check(
    "crc4", off=0, nbytes=4, p1=0x3, p2=0x0, cmp_off=36, cmp_width=4,
    xor_bits=tuple((32 + j, 1 << (3 - j)) for j in range(4)))


def _s3318p_guard(bits):
    if bits.bits_per_row[0] == 0 and bits.num_rows > 1 \
            and bits.bits_per_row[1] == 0:
        return DECODE_ABORT_EARLY
    return None


_spec(DeclSpec(
    # Conrad S3318P (ref src/devices/s3318p.c:60-116; temperature.py):
    # 42-bit rows x4, 2 lead bits, CRC-4, tenth-degrees F offset 90
    symbol="s3318p",
    min_bits=42, max_bits=42, exact_lens=(42,), row_mode="repeat",
    min_repeats=4, repeat_min_bits=42, host_guard=_s3318p_guard,
    align_off=2, frame_bits=40, in_bits=296,
    checks=(_S3318_CRC,),
    raws=(Raw(0, 8),                                    # 0 id
          Raw(10, 2),                                   # 1 channel-1
          Raw(0, 12,                                    # 2 temp raw
              bit_order=tuple(range(20, 24)) + tuple(range(16, 20))
              + tuple(range(12, 16))),
          Raw(0, 8,                                     # 3 humidity
              bit_order=tuple(range(28, 32)) + tuple(range(24, 28))),
          Raw(33, 1),                                   # 4 battery flag
          Raw(32, 1),                                   # 5 button
          Raw(0, 32)),                                  # 6 nonzero guard
    sanity=(San(6, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Conrad-S3318P"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((4, -1, 0),), add=1, pretty="Battery"),
        F("temperature_F", kind="float", terms=((2, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((3, 1, 0),), pretty="Humidity", fmt="%u %%",
          cond=San(3, "ne", 0)),
        F("button", terms=((5, 1, 0),), pretty="Button"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _kedsum_guard(bits):
    if bits.num_rows < 5 or any(bits.bits_per_row[i] != 0
                                for i in range(5)):
        return DECODE_ABORT_EARLY
    return None


_spec(DeclSpec(
    # Kedsum-TH (ref src/devices/kedsum.c:36-95; temperature.py): 5 empty
    # sync rows, 42-bit rows x4, CRC-4, battery level enum
    symbol="kedsum",
    min_bits=42, max_bits=42, exact_lens=(42,), row_mode="repeat",
    min_repeats=4, repeat_min_bits=42, host_guard=_kedsum_guard,
    align_off=2, frame_bits=40, in_bits=296,
    checks=(_S3318_CRC,),
    raws=(Raw(0, 8),                                    # 0 id
          Raw(10, 2),                                   # 1 channel-1
          Raw(8, 2),                                    # 2 battery code
          Raw(0, 12,                                    # 3 temp raw
              bit_order=tuple(range(20, 24)) + tuple(range(16, 20))
              + tuple(range(12, 16))),
          Raw(0, 8,                                     # 4 humidity
              bit_order=tuple(range(28, 32)) + tuple(range(24, 28))),
          Raw(0, 8,                                     # 5 flags:
              bit_order=(8, 9, -1, -1, 32, 33, 34, 35))),  # (b1&C0)|(b4>>4)
    variants=(Variant(fields=(
        F("model", "const", value="Kedsum-TH"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", kind="enumf", terms=((2, 1, 0),), mul=0.01,
          map={0: 0, 1: 10, 2: 100, 3: 30}, pretty="Battery level"),
        F("flags", terms=((5, 1, 0),), pretty="Flags2"),
        F("temperature_F", kind="float", terms=((3, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _esperanza_guard(bits):
    # exactly 14 rows alternating empty / identical 42-bit payloads
    # (ref src/devices/esperanza_ews.c:62-110)
    from .base import DECODE_ABORT_LENGTH, DECODE_FAIL_SANITY
    if bits.bits_per_row[0] != 0 or bits.num_rows < 2 \
            or bits.bits_per_row[1] != 0:
        return DECODE_FAIL_SANITY
    if bits.num_rows != 14:
        return DECODE_ABORT_LENGTH
    for row in range(2, bits.num_rows - 3, 2):
        if bits.bits_per_row[row] != 42 \
                or not (bits.bb[row] == bits.bb[row + 2]).all():
            return DECODE_FAIL_SANITY
    return [2]


_spec(DeclSpec(
    # Esperanza EWS (ref src/devices/esperanza_ews.c:62-110;
    # temperature.py): row pattern validated host-side, CRC-4 on row 2
    symbol="esperanza_ews",
    min_bits=42, max_bits=42, exact_lens=(42,), row_mode="any",
    host_guard=_esperanza_guard, align_off=2, frame_bits=40, in_bits=296,
    checks=(_S3318_CRC,),
    raws=(Raw(0, 8),                                    # 0 id
          Raw(10, 2),                                   # 1 channel-1
          Raw(0, 12,                                    # 2 temp raw
              bit_order=tuple(range(20, 24)) + tuple(range(16, 20))
              + tuple(range(12, 16))),
          Raw(0, 8,                                     # 3 humidity
              bit_order=tuple(range(28, 32)) + tuple(range(24, 28))),
          Raw(33, 1)),                                  # 4 battery flag
    variants=(Variant(fields=(
        F("model", "const", value="Esperanza-EWS"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((4, -1, 0),), add=1, pretty="Battery"),
        F("temperature_F", kind="float", terms=((2, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((3, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Solight TE44 (ref src/devices/solight_te44.c:41-91; temperature.py):
    # Rubicson layout, battery unused
    symbol="solight_te44",
    min_bits=36, max_bits=37, exact_lens=(37,), row_mode="repeat",
    min_repeats=3, repeat_min_bits=36, frame_bits=40, in_bits=296,
    checks=(_RUBICSON_CRC,),
    raws=(Raw(0, 8), Raw(10, 2), Raw(12, 12), Raw(24, 4)),
    sanity=(San(3, "eq", 0xF),),
    variants=(Variant(fields=(
        F("model", "const", value="Solight-TE44"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("temperature_C", kind="float", terms=((2, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.2f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Auriol AFW2A1 (ref src/devices/auriol_afw2a1.c:55-115;
    # temperature.py): fixed 0xA nibble, range sanity only
    symbol="auriol_afw2a1",
    min_bits=36, row_mode="repeat", min_repeats=12, repeat_min_bits=36,
    frame_bits=40, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(10, 2),         # 1 channel-1
          Raw(8, 1),          # 2 battery_ok
          Raw(9, 1),          # 3 button
          Raw(12, 12),        # 4 temp signed
          Raw(24, 4),         # 5 const 0xA nibble
          Raw(28, 8)),        # 6 humidity
    sanity=(San(5, "eq", 0xA),
            San(6, "le", 0x64),
            San(4, "ge", -51.1, signed_bits=12, fmul=0.1),
            San(4, "le", 76.7, signed_bits=12, fmul=0.1),),
    variants=(Variant(fields=(
        F("model", "const", value="Auriol-AFW2A1"),
        F("id", terms=((0, 1, 0),)),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((2, 1, 0),), pretty="Battery"),
        F("button", terms=((3, 1, 0),), pretty="Button"),
        F("temperature_C", kind="float", terms=((4, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", kind="float", terms=((6, 1, 0),),
          pretty="Humidity", fmt="%.0f %%"),
    )),),
))


_spec(DeclSpec(
    # Auriol AHFL (ref src/devices/auriol_ahfl.c:30-100; temperature.py):
    # 42-bit rows x2, fixed 0x4 nibble, 6-bit nibble-sum checksum
    symbol="auriol_ahfl",
    min_bits=42, max_bits=42, exact_lens=(42,), row_mode="repeat",
    min_repeats=2, repeat_min_bits=42, frame_bits=48, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=5, mask=0x3F,
                  cmp_off=36, cmp_width=6,
                  bit_map=tuple(range(32)) + tuple(range(32, 36))
                  + (-1,) * 4),),
    raws=(Raw(0, 8),          # 0 id
          Raw(10, 2),         # 1 channel-1
          Raw(8, 1),          # 2 battery_ok
          Raw(9, 1),          # 3 button
          Raw(12, 12),        # 4 temp signed
          Raw(32, 4),         # 5 const 0x4 nibble
          Raw(31, 1),         # 6 zero bit (b3 & 1)
          Raw(24, 7)),        # 7 humidity
    sanity=(San(5, "eq", 0x4),
            San(6, "eq", 0x0),),
    variants=(Variant(fields=(
        F("model", "const", value="Auriol-AHFL"),
        F("id", terms=((0, 1, 0),)),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((2, 1, 0),), pretty="Battery"),
        F("button", terms=((3, 1, 0),), pretty="Button"),
        F("temperature_C", kind="float", terms=((4, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", terms=((7, 1, 0),), pretty="Humidity", fmt="%d %%"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # inFactory-TH (ref src/devices/infactory.c:55-116; temperature.py):
    # CRC-4 poly 0x13 with channel/CRC nibble swap, BCD humidity
    symbol="infactory",
    min_bits=40, max_bits=42, exact_lens=(40, 41, 42), row_mode="row0",
    frame_bits=40, in_bits=64,
    checks=(
        # crc4(0x13) over [b0, (b1&0F)|((b4&0F)<<4), b2, b3]
        # ^ (b4>>4) == (b1>>4)
        Check("crc4", off=0, nbytes=4, p1=0x13, p2=0x0,
              cmp_off=8, cmp_width=4,
              bit_map=tuple(range(0, 8)) + tuple(range(36, 40))
              + tuple(range(12, 16)) + tuple(range(16, 24))
              + tuple(range(24, 32)),
              xor_bits=tuple((32 + j, 1 << (3 - j)) for j in range(4))),),
    raws=(Raw(0, 8),          # 0 id
          Raw(38, 2),         # 1 channel
          Raw(13, 1),         # 2 battery flag
          Raw(12, 1),         # 3 button
          Raw(16, 12),        # 4 temp raw
          Raw(28, 4),         # 5 humidity tens (BCD)
          Raw(32, 4)),        # 6 humidity ones (BCD)
    sanity=(San(1, "ne", 0),
            San(0, "le", 100, terms=((5, 10, 0), (6, 1, 0))),),
    variants=(Variant(fields=(
        F("model", "const", value="inFactory-TH"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), pretty="Channel"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("button", terms=((3, 1, 0),), pretty="Button"),
        F("temperature_F", kind="float", terms=((4, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((5, 10, 0), (6, 1, 0)), pretty="Humidity",
          fmt="%u %%"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Springfield-Soil (ref src/devices/springfield.c:33-107;
    # temperature.py): XOR nibble-folded checksum, moisture level
    symbol="springfield",
    min_bits=36, max_bits=37, exact_lens=(36, 37), row_mode="repeat",
    min_repeats=3, repeat_min_bits=36, frame_bits=40, in_bits=296,
    # xor_bytes(b[:4]) hi nibble ^ lo nibble == 0: pure xor_bits check
    # (each frame bit k of bytes 0..3 contributes 1 << (3 - (k%8)%4))
    checks=(Check("xor_bytes", off=0, nbytes=0, cmp_const=0, mask=0xF,
                  xor_bits=tuple((k, 1 << (3 - (k % 8) % 4))
                                 for k in range(32))),),
    raws=(Raw(0, 32),         # 0 word guard
          Raw(0, 8),          # 1 id
          Raw(8, 1),          # 2 battery
          Raw(9, 1),          # 3 button
          Raw(10, 2),         # 4 channel-1
          Raw(12, 12),        # 5 temp signed
          Raw(24, 4)),        # 6 moisture level
    sanity=(San(0, "ne", 0),
            San(0, "ne", 0xFFFFFFFF),
            San(5, "ge", -30, signed_bits=12, fmul=0.1),
            San(5, "le", 70, signed_bits=12, fmul=0.1),
            San(6, "le", 10),),
    variants=(Variant(fields=(
        F("model", "const", value="Springfield-Soil"),
        F("id", terms=((1, 1, 0),), pretty="SID"),
        F("channel", terms=((4, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("transmit", kind="enum", terms=((3, 1, 0),),
          map={1: "MANUAL", 0: "AUTO"}, pretty="Transmit"),
        F("temperature_C", kind="float", terms=((5, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("moisture", terms=((6, 10, 0),), pretty="Moisture", fmt="%d %%"),
        F("button", terms=((3, 1, 0),), pretty="Button"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # TFA-Pool (ref src/devices/tfa_pool_thermometer.c:30-80;
    # temperature.py): nibble-sum-minus-1 checksum in the first nibble
    symbol="tfa_pool_thermometer",
    min_bits=28, max_bits=28, exact_lens=(28,), row_mode="repeat",
    min_repeats=7, repeat_min_bits=28, frame_bits=28, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=3, add_const=-1, mask=0xF,
                  cmp_off=0, cmp_width=4,
                  bit_map=tuple(range(4, 28))),),
    raws=(Raw(4, 8),          # 0 device id
          Raw(12, 12),        # 1 temp raw
          Raw(24, 2),         # 2 channel
          Raw(26, 1)),        # 3 battery
    variants=(Variant(fields=(
        F("model", "const", value="TFA-Pool"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("channel", terms=((2, 1, 0),), pretty="Channel"),
        F("battery_ok", terms=((3, 1, 0),), pretty="Battery"),
        # (raw - 4096 if raw > 2048 else raw) * 0.1 — note: NOT plain
        # two's complement (2048 itself stays positive)
        F("temperature_C", kind="float",
          terms=((1, 1, 0, (2048, 4096)),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Thermopro-TP11 (ref src/devices/thermopro_tp11.c:22-60;
    # temperature.py): reflected LFSR-8 digest gen 0x51 key 0x04
    symbol="thermopro_tp11",
    min_bits=32, max_bits=33, row_mode="repeat", min_repeats=2,
    repeat_min_bits=32, frame_bits=32, in_bits=296,
    checks=(Check("lfsr_digest8_reflect", off=0, nbytes=3, p1=0x51,
                  p2=0x04, cmp_off=24, cmp_width=8),),
    raws=(Raw(0, 12),         # 0 device id
          Raw(12, 12),        # 1 temp raw
          Raw(0, 32)),        # 2 all-0/all-FF guard
    sanity=(San(2, "ne", 0),
            San(2, "ne", 0xFFFFFFFF),),
    variants=(Variant(fields=(
        F("model", "const", value="Thermopro-TP11"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("temperature_C", kind="float", terms=((1, 1, 0),), add=-200,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _tp12_rows(bits):
    # repeated-prefix row selection with a data-dependent repeat count
    # (ref src/devices/thermopro_tp12.c:46-106)
    row = bits.find_repeated_prefix(5 if bits.num_rows > 5 else 2, 40)
    if row < 0:
        return DECODE_ABORT_EARLY
    return [row]


_spec(DeclSpec(
    # Thermopro-TP12 (ref src/devices/thermopro_tp12.c:46-106;
    # temperature.py): two probe temperatures, reflected LFSR-8
    symbol="thermopro_tp12",
    min_bits=41, max_bits=41, exact_lens=(41,), row_mode="any",
    host_guard=_tp12_rows, frame_bits=40, in_bits=296,
    checks=(Check("lfsr_digest8_reflect", off=0, nbytes=4, p1=0x51,
                  p2=0x04, cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(0, 12,          # 1 temp1: ((b2 & F0) << 4) | b1
              bit_order=tuple(range(16, 20)) + tuple(range(8, 16))),
          Raw(0, 12,          # 2 temp2: ((b2 & 0F) << 8) | b3
              bit_order=tuple(range(20, 24)) + tuple(range(24, 32))),
          Raw(0, 32)),        # 3 nonzero guard
    sanity=(San(3, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Thermopro-TP12"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("temperature_1_C", kind="float", terms=((1, 1, 0),), add=-200,
          mul=0.1, pretty="Temperature 1 (Food)", fmt="%.1f C"),
        F("temperature_2_C", kind="float", terms=((2, 1, 0),), add=-200,
          mul=0.1, pretty="Temperature 2 (Barbecue)", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Hyundai-WS (ref src/devices/wssensor.c:30-92; temperature.py):
    # 24-bit rows x4, no MIC, signed temperature
    symbol="wssensor",
    min_bits=24, max_bits=24, exact_lens=(24,), row_mode="repeat",
    min_repeats=4, repeat_min_bits=23, frame_bits=24, in_bits=296,
    raws=(Raw(0, 12),         # 0 temp signed
          Raw(16, 8),         # 1 id (byte 2)
          Raw(14, 2),         # 2 channel-1
          Raw(12, 1),         # 3 battery
          Raw(13, 1),         # 4 button
          Raw(0, 24)),        # 5 guard
    sanity=(San(5, "ne", 0),
            San(5, "ne", 0xFFFFFF),),
    variants=(Variant(fields=(
        F("model", "const", value="Hyundai-WS"),
        F("id", terms=((1, 1, 0),), pretty="House Code"),
        F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((3, 1, 0),), pretty="Battery"),
        F("temperature_C", kind="float", terms=((0, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.2f C"),
        F("button", terms=((4, 1, 0),), pretty="Button"),
    )),),
))


def _generic_temp_guard(bits):
    from .base import DECODE_ABORT_LENGTH
    for i in range(1, 10):
        if i >= bits.num_rows or bits.bits_per_row[i] != 24:
            return DECODE_ABORT_LENGTH
    return [1]


_spec(DeclSpec(
    # Generic-Temperature (ref src/devices/generic_temperature_sensor.c:
    # 22-62; temperature.py): rows 1-9 all 24 bits, no MIC
    symbol="generic_temperature_sensor",
    min_bits=24, max_bits=24, row_mode="any",
    host_guard=_generic_temp_guard, frame_bits=24, in_bits=64,
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 2),          # 1 battery bits
          Raw(10, 14),        # 2 temp raw (signed 14, then >> 2)
          Raw(0, 24)),        # 3 guard
    sanity=(San(3, "ne", 0),
            San(3, "ne", 0xFFFFFF),),
    variants=(Variant(fields=(
        F("model", "const", value="Generic-Temperature"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("battery_ok", terms=((1, 1, 0),), pretty="Battery?"),
        F("temperature_C", kind="float", terms=((2, 1, 14),), shr=2,
          mul=0.1, pretty="Temperature", fmt="%.2f C"),
    )),),
))


# ---------------------------------------------------------------------------
# FSK PCM family
# ---------------------------------------------------------------------------

def _lacrosse_it_spec(symbol, model):
    # LaCrosse TX29/TX35 IT (ref src/devices/lacrosse_tx35.c:76-180;
    # protocols.py _lacrosse_it): a2dd49 preamble, frame at match+20,
    # crc8(0x31) over 4 bytes, BCD temperature, humidity 106=none
    # 125=probe (+0x40 on id), events for EVERY matching row
    return DeclSpec(
        symbol=symbol,
        min_bits=24, row_mode="all",
        preamble="101000101101110101001001",   # a2dd49
        align_off=-4,                          # frame starts at match+20
        frame_bits=40, in_bits=512,
        checks=(Check("crc8", off=0, nbytes=4, p1=0x31, p2=0x00,
                      cmp_off=32, cmp_width=8),),
        raws=(Raw(4, 6),        # 0 sensor id
              Raw(12, 4),       # 1 temp tens (BCD)
              Raw(16, 4),       # 2 temp ones
              Raw(20, 4),       # 3 temp tenths
              Raw(10, 1),       # 4 new battery
              Raw(24, 1),       # 5 battery low
              Raw(25, 7)),      # 6 humidity
        variants=(
            Variant(cond=San(6, "eq", 125), fields=(
                F("model", "const", value=model),
                F("id", terms=((0, 1, 0),), add=0x40),
                F("battery_ok", terms=((5, -1, 0),), add=1,
                  pretty="Battery"),
                F("newbattery", terms=((4, 1, 0),), pretty="NewBattery"),
                F("temperature_C", kind="fsum",
                  terms=((1, 10, 0), (2, 1, 0), (3, 0.1, 0)), add=-40.0,
                  pretty="Temperature", fmt="%.1f C"),
                F("mic", "const", value="CRC", pretty="Integrity"),
            )),
            Variant(cond=San(6, "eq", 106), fields=(
                F("model", "const", value=model),
                F("id", terms=((0, 1, 0),)),
                F("battery_ok", terms=((5, -1, 0),), add=1,
                  pretty="Battery"),
                F("newbattery", terms=((4, 1, 0),), pretty="NewBattery"),
                F("temperature_C", kind="fsum",
                  terms=((1, 10, 0), (2, 1, 0), (3, 0.1, 0)), add=-40.0,
                  pretty="Temperature", fmt="%.1f C"),
                F("mic", "const", value="CRC", pretty="Integrity"),
            )),
            Variant(fields=(
                F("model", "const", value=model),
                F("id", terms=((0, 1, 0),)),
                F("battery_ok", terms=((5, -1, 0),), add=1,
                  pretty="Battery"),
                F("newbattery", terms=((4, 1, 0),), pretty="NewBattery"),
                F("temperature_C", kind="fsum",
                  terms=((1, 10, 0), (2, 1, 0), (3, 0.1, 0)), add=-40.0,
                  pretty="Temperature", fmt="%.1f C"),
                F("humidity", terms=((6, 1, 0),), pretty="Humidity",
                  fmt="%u %%"),
                F("mic", "const", value="CRC", pretty="Integrity"),
            )),
        ),
    )


_spec(_lacrosse_it_spec("lacrosse_tx35", "LaCrosse-TX35DTHIT"))
_spec(_lacrosse_it_spec("lacrosse_tx29", "LaCrosse-TX29IT"))


# ---------------------------------------------------------------------------
# Doorbells / remotes / rain gauges batch
# ---------------------------------------------------------------------------

_spec(DeclSpec(
    # Elro-DB286A doorbell (ref src/devices/elro_db286a.c:20-40;
    # remotes.py): 33-bit code repeated 5x, no MIC
    symbol="elro_db286a",
    min_bits=33, max_bits=33, exact_lens=(33,), row_mode="repeat",
    min_repeats=5, repeat_min_bits=33, frame_bits=33, in_bits=296,
    raws=(Raw(0, 32),),
    variants=(Variant(fields=(
        F("model", "const", value="Elro-DB286A"),
        F("id", kind="hexs", terms=((0, 1, 0),), val=8, pretty="ID"),
    )),),
))


from .remotes2 import _DISH_BUTTONS  # noqa: E402  (data table)

_spec(DeclSpec(
    # Dish Network remote 6.3 (ref src/devices/dish_remote_6_3.c;
    # remotes2.py): 16-bit rows x3, fixed framing bits, button table
    symbol="dish_remote_6_3",
    min_bits=16, max_bits=16, row_mode="repeat", min_repeats=3,
    repeat_min_bits=16, frame_bits=16, in_bits=296,
    raws=(Raw(0, 6),                                    # 0 button code
          Raw(6, 2),                                    # 1 must be 2
          Raw(0, 4, bit_order=(8, 9, 10, 12))),         # 2 framing 0xB
    sanity=(San(1, "eq", 0x2),
            San(2, "eq", 0xB),),
    variants=(Variant(fields=(
        F("model", "const", value="Dish-RC63"),
        F("button", kind="enum", terms=((0, 1, 0),),
          map={i: s for i, s in enumerate(_DISH_BUTTONS)}),
    )),),
))


_spec(DeclSpec(
    # Blyss-DC5ukwh (ref src/devices/blyss.c:18-48; remotes.py): two
    # fixed 33-bit codes (both end in 0x80)
    symbol="blyss",
    min_bits=33, max_bits=33, exact_lens=(33,), row_mode="any",
    frame_bits=40, in_bits=296,
    raws=(Raw(0, 32), Raw(32, 8)),
    sanity=(San(0, "in", (0xCE8E2A6C, 0xE7377A2C)),
            San(1, "eq", 0x80),),
    variants=(Variant(fields=(
        F("model", "const", value="Blyss-DC5ukwh"),
        F("id", kind="hexs", terms=((0, 1, 0),), val=8),
    )),),
))


def _acurite_rain_guard(bits):
    if bits.num_rows < 12 and bits.bits_per_row[0] >= 24:
        return DECODE_ABORT_EARLY
    return None


_spec(DeclSpec(
    # Acurite-Rain 896 (ref src/devices/acurite.c:151-185; weather
    # family): 24-bit row 0, >= 12 rows, stale bytes 3/4 must be zero
    symbol="acurite_rain_896",
    min_bits=24, row_mode="row0", host_guard=_acurite_rain_guard,
    frame_bits=40, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 8),          # 1 b1
          Raw(16, 8),         # 2 b2
          Raw(24, 8),         # 3 b3 (stale, must be 0)
          Raw(32, 8),         # 4 b4 (stale, must be 0)
          Raw(12, 12)),       # 5 rain counter
    sanity=(San(0, "ne", 0), San(1, "ne", 0), San(2, "ne", 0),
            San(3, "eq", 0), San(4, "eq", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Acurite-Rain"),
        F("id", terms=((0, 1, 0),)),
        F("rain_mm", kind="float", terms=((5, 1, 0),), mul=0.5,
          pretty="Total Rain", fmt="%.1f mm"),
    )),),
))


_spec(DeclSpec(
    # Quhwa-Doorbell (ref src/devices/quhwa.c:16-48; remotes.py):
    # inverted 18-bit code repeated 5x
    symbol="quhwa",
    min_bits=18, max_bits=18, exact_lens=(18,), row_mode="repeat",
    min_repeats=5, repeat_min_bits=18, frame_bits=24, in_bits=296,
    raws=(Raw(0, 24),         # 0 nonzero guard (pre-inversion, stale ok)
          Raw(14, 2),         # 1 must be 0 (inverted 0x03)
          Raw(16, 2),         # 2 must be 0 (inverted 0xC0)
          Raw(0, 16)),        # 3 id source
    sanity=(San(0, "ne", 0),
            San(1, "eq", 0),
            San(2, "eq", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Quhwa-Doorbell"),
        F("id", terms=((3, -1, 0),), add=0xFFFF, pretty="ID"),
    )),),
))


_spec(DeclSpec(
    # RF-tech / INFRA 217S34 (ref src/devices/rftech.c; temperature
    # family): sign-magnitude temperature, no MIC
    symbol="rftech",
    min_bits=24, max_bits=24, exact_lens=(24,), row_mode="repeat",
    min_repeats=3, repeat_min_bits=24, frame_bits=24, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 1),          # 1 sign
          Raw(9, 7),          # 2 integer degrees
          Raw(20, 4),         # 3 tenths
          Raw(16, 1),         # 4 battery
          Raw(17, 2)),        # 5 button bits
    variants=(
        Variant(cond=San(1, "eq", 1), fields=(
            F("model", "const", value="RF-tech"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("battery_ok", terms=((4, 1, 0),), pretty="Battery"),
            # -(a + 0.1*b): IEEE negation distributes over the sum
            F("temperature_C", kind="fsum",
              terms=((2, -1, 0), (3, -0.1, 0)), pretty="Temperature",
              fmt="%.1f C"),
            F("button", kind="bool", terms=((5, 1, 0),), pretty="Button"),
        )),
        Variant(fields=(
            F("model", "const", value="RF-tech"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("battery_ok", terms=((4, 1, 0),), pretty="Battery"),
            F("temperature_C", kind="fsum",
              terms=((2, 1, 0), (3, 0.1, 0)), pretty="Temperature",
              fmt="%.1f C"),
            F("button", kind="bool", terms=((5, 1, 0),), pretty="Button"),
        )),
    ),
))


_spec(DeclSpec(
    # Eurochron-TH (ref src/devices/eurochron.c; temperature.py)
    symbol="eurochron",
    min_bits=36, max_bits=36, row_mode="repeat", min_repeats=3,
    repeat_min_bits=36, frame_bits=40, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(12, 4),         # 1 must be 0
          Raw(8, 1),          # 2 battery-low flag
          Raw(11, 1),         # 3 button
          Raw(16, 8),         # 4 humidity
          Raw(24, 12)),       # 5 temp signed 12
    sanity=(San(1, "eq", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Eurochron-TH"),
        F("id", terms=((0, 1, 0),)),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((5, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity"),
        F("button", terms=((3, 1, 0),), pretty="Button"),
    )),),
))


_spec(DeclSpec(
    # Maverick-ET73 BBQ (ref src/devices/maverick_et73.c; temperature.py)
    symbol="maverick_et73",
    min_bits=48, max_bits=48, exact_lens=(48,), row_mode="repeat",
    min_repeats=3, repeat_min_bits=48, frame_bits=48, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 12),         # 1 temp1 signed 12
          Raw(20, 12),        # 2 temp2 signed 12
          Raw(0, 32)),        # 3 all-0/all-FF guard
    sanity=(San(3, "ne", 0),
            San(3, "ne", 0xFFFFFFFF),),
    variants=(Variant(fields=(
        F("model", "const", value="Maverick-ET73"),
        F("id", terms=((0, 1, 0),), pretty="Random Id"),
        F("temperature_1_C", kind="float", terms=((1, 1, 12),), mul=0.1,
          pretty="Temperature 1", fmt="%.1f C"),
        F("temperature_2_C", kind="float", terms=((2, 1, 12),), mul=0.1,
          pretty="Temperature 2", fmt="%.1f C"),
    )),),
))


def _rfxmeter_rows(bits):
    from .base import DECODE_ABORT_LENGTH
    if bits.num_rows not in (1, 2):
        return DECODE_ABORT_LENGTH
    return [bits.num_rows - 1]


_spec(DeclSpec(
    # RFXMeter / RFXPower (ref src/devices/rfxmeter.c; meters family):
    # id ^ 0xF0 == next byte, nibble-sum == 0x0F
    symbol="rfxmeter",
    min_bits=48, max_bits=48, exact_lens=(48,), row_mode="any",
    host_guard=_rfxmeter_rows, frame_bits=48, in_bits=296,
    checks=(
        Check("xor_bytes", off=0, nbytes=2, cmp_const=0xF0),
        Check("add_nibbles", off=0, nbytes=6, mask=0xF, cmp_const=0x0F),),
    raws=(Raw(0, 8),          # 0 id
          Raw(40, 4),         # 1 msg type
          # 2 msg value: (b4 << 16) | (b2 << 8) | b3
          Raw(0, 24, bit_order=tuple(range(32, 40)) + tuple(range(16, 24))
              + tuple(range(24, 32)))),
    variants=(Variant(fields=(
        F("model", "const", value="RfxMeter"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("msg_type", terms=((1, 1, 0),), pretty="Msg Type"),
        F("msg_value", terms=((2, 1, 0),), pretty="Msg Value"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # TFA Drop 30.3233.01 rain gauge (ref src/devices/tfa_drop_30.3233.c;
    # weather family): inverted, reflected LFSR-8 gen 0x31 key 0xF4
    symbol="tfa_drop_303233",
    min_bits=66, max_bits=82, row_mode="repeat", min_repeats=2,
    repeat_min_bits=66, transform="invert", frame_bits=66, in_bits=296,
    checks=(Check("lfsr_digest8_reflect", off=0, nbytes=7, p1=0x31,
                  p2=0xF4, cmp_off=56, cmp_width=8),),
    raws=(Raw(0, 4),          # 0 type nibble (0x3)
          Raw(4, 20),         # 1 id
          Raw(24, 1),         # 2 battery-low
          # 3 rain counter: (b6 << 8) | b4
          Raw(0, 16, bit_order=tuple(range(48, 56)) + tuple(range(32, 40))),
          ),
    sanity=(San(0, "eq", 0x3),),
    variants=(Variant(fields=(
        F("model", "const", value="TFA-Drop"),
        F("id", terms=((1, 1, 0),), pretty="", fmt="%5x"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("rain_mm", kind="float", terms=((3, 1, 0),), add=10,
          modulo=0x10000, mul=0.254, pretty="Rain total", fmt="%.1f mm"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Akhan-100F14 RKE (ref src/devices/akhan_100F14.c:19-59;
    # remotes.py): inverted 25-bit code, command nibble lookup
    symbol="akhan_100F14",
    min_bits=25, max_bits=25, exact_lens=(25,), row_mode="row0",
    frame_bits=25, in_bits=64,
    raws=(Raw(0, 20),         # 0 ~id source
          Raw(20, 4)),        # 1 ~cmd source
    sanity=(San(1, "in", (14, 13, 11, 7)),),   # ~cmd in {1,2,4,8}
    variants=(Variant(fields=(
        F("model", "const", value="Akhan-100F14"),
        F("id", terms=((0, -1, 0),), add=0xFFFFF, pretty="ID (20bit)",
          fmt="0x%x"),
        F("data", kind="enum", terms=((1, -1, 0),), add=0xF,
          map={0x1: "0x1 (Lock)", 0x2: "0x2 (Unlock)",
               0x4: "0x4 (Mute)", 0x8: "0x8 (Alarm)"},
          pretty="Data (4bit)"),
    )),),
))


def _generic_motion_rows(bits):
    rows = [i for i in range(bits.num_rows) if bits.count_repeats(i) >= 3]
    if not rows:
        return DECODE_ABORT_EARLY
    return rows


_spec(DeclSpec(
    # Generic-Motion (ref src/devices/generic_motion.c:33-60; misc):
    # 20-bit rows repeated >= 3x (any row), no checksum
    symbol="generic_motion",
    min_bits=20, max_bits=20, exact_lens=(20,), row_mode="any",
    host_guard=_generic_motion_rows, frame_bits=24, in_bits=64,
    raws=(Raw(0, 20),         # 0 code
          Raw(8, 16)),        # 1 b1|b2 guard (stale tail read)
    sanity=(San(1, "ne", 0x0000),
            San(1, "ne", 0xFFF0),),
    variants=(Variant(fields=(
        F("model", "const", value="Generic-Motion"),
        F("code", kind="hexs", terms=((0, 1, 0),), val=5),
    )),),
))


# ---------------------------------------------------------------------------
# Temperature / rain PPM+PWM batch 5 (round-5 session 2)
# ---------------------------------------------------------------------------

_spec(DeclSpec(
    # Acurite-606TX (ref src/devices/acurite.c:1904-1958; acurite.py
    # acurite_606): 32/33-bit rows x3, LFSR-8 digest gen 0x98 key 0xF1
    symbol="acurite_606",
    min_bits=32, max_bits=33, row_mode="repeat", min_repeats=3,
    repeat_min_bits=32, frame_bits=32, in_bits=296,
    checks=(Check("lfsr_digest8", off=0, nbytes=3, p1=0x98, p2=0xF1,
                  cmp_off=24, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(12, 12),        # 1 temperature (signed 12)
          Raw(10, 2),         # 2 channel
          Raw(8, 1),          # 3 battery
          Raw(9, 1),          # 4 button
          Raw(0, 32)),        # 5 all-zero guard
    sanity=(San(5, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="Acurite-606TX"),
        F("id", terms=((0, 1, 0),)),
        F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((3, 1, 0),), pretty="Battery"),
        F("button", terms=((4, 1, 0),), pretty="Button"),
        F("temperature_C", kind="float", terms=((1, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Globaltronics Quigg GT-TMBBQ-05 (ref src/devices/gt_tmbbq05.c;
    # bbq.py gt_tmbbq05): 33-bit rows x5, frame at bit 1, even parity
    # over [b0,b1,b2,b3&F0] plus nibble-sum == low nibble of b3
    symbol="gt_tmbbq05",
    min_bits=33, max_bits=33, exact_lens=(33,), row_mode="repeat",
    min_repeats=5, repeat_min_bits=33, align_off=1,
    frame_bits=32, in_bits=296,
    checks=(Check("parity_bytes", off=0, nbytes=4, cmp_const=0,
                  bit_map=tuple(range(28)) + (-1,) * 4),
            Check("add_nibbles", off=0, nbytes=4, mask=0xF,
                  cmp_off=28, cmp_width=4,
                  bit_map=tuple(range(28)) + (-1,) * 4),),
    raws=(Raw(0, 16,          # 0 id: (b0 << 8) | b2
              bit_order=tuple(range(0, 8)) + tuple(range(16, 24))),
          Raw(0, 10,          # 1 temp: ((b3 & C0) << 2) | b1
              bit_order=(24, 25) + tuple(range(8, 16))),
          Raw(0, 32)),        # 2 all-zero guard
    sanity=(San(2, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="GT-TMBBQ05"),
        F("id", terms=((0, 1, 0),), pretty="ID Code"),
        F("temperature_F", kind="float", terms=((1, 1, 0),), add=-90,
          pretty="Temperature", fmt="%.2f F"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Rubicson 48659 meat thermometer (ref src/devices/rubicson_48659.c;
    # bbq.py rubicson_48659): (sum(b0..b2) - b3) & FF == A6; a set sign
    # bit yields temperature -1.0 (reference operator-precedence quirk)
    symbol="rubicson_48659",
    min_bits=10, max_bits=33, row_mode="repeat", min_repeats=10,
    repeat_min_bits=32, frame_bits=32, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=3, cmp_off=24, cmp_width=8,
                  add_const=-0xA6),),
    raws=(Raw(0, 8),          # 0 id
          Raw(13, 1),         # 1 sign-bit quirk (b1 & 0x04)
          Raw(14, 10)),       # 2 temperature: ((b1 & 3) << 8) | b2
    variants=(
        Variant(cond=San(1, "eq", 1), fields=(
            F("model", "const", value="Rubicson-48659"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("temperature_F", "const", value=-1.0,
              pretty="Temperature", fmt="%.1f F"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
        Variant(fields=(
            F("model", "const", value="Rubicson-48659"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("temperature_F", kind="float", terms=((2, 1, 0),),
              pretty="Temperature", fmt="%.1f F"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
    ),
))


_spec(DeclSpec(
    # Baldr / RainPoint rain gauge (ref src/devices/baldr_rain.c;
    # meters.py baldr_rain): 36-bit rows x3, no MIC, all-0/all-F guards
    # over bytes 0/2/3
    symbol="baldr_rain",
    min_bits=36, max_bits=37, row_mode="repeat", min_repeats=3,
    repeat_min_bits=36, frame_bits=40, in_bits=296,
    raws=(Raw(0, 12),         # 0 id
          Raw(12, 4),         # 1 flags
          Raw(16, 20),        # 2 rain
          # 3: b0|b2|b3 combined guard
          Raw(0, 24, bit_order=tuple(range(0, 8)) + tuple(range(16, 32)))),
    sanity=(San(3, "ne", 0x000000),
            San(3, "ne", 0xFFFFFF),),
    variants=(Variant(fields=(
        F("model", "const", value="Baldr-Rain"),
        F("id", terms=((0, 1, 0),), pretty="", fmt="%03x"),
        F("flags", terms=((1, 1, 0),), pretty="Flags", fmt="%x"),
        F("rain_in", kind="float", terms=((2, 1, 0),), mul=0.001,
          pretty="Rain", fmt="%.3f in"),
    )),),
))


_spec(DeclSpec(
    # Baldr-E0666TH (ref src/devices/baldr_therm.c; temperature.py
    # baldr_therm): 64-bit rows x8, fixed-zero guard fields, no MIC
    symbol="baldr_therm",
    min_bits=64, max_bits=65, row_mode="repeat", min_repeats=8,
    repeat_min_bits=64, frame_bits=64, in_bits=296,
    raws=(Raw(0, 16,          # 0 id: (b0 << 8) | b7
              bit_order=tuple(range(0, 8)) + tuple(range(56, 64))),
          Raw(10, 2),         # 1 channel
          Raw(8, 1),          # 2 battery
          Raw(12, 12),        # 3 temperature (signed 12)
          Raw(28, 8),         # 4 humidity: ((b3 << 4) | (b4 >> 4)) & FF
          Raw(52, 1),         # 5 startup (b6 & 0x08)
          Raw(9, 1),          # 6 guard (b1 & 0x40)
          Raw(24, 4),         # 7 guard (b3 & 0xF0)
          Raw(36, 4),         # 8 guard (b4 & 0x0F)
          Raw(40, 8),         # 9 guard b5
          Raw(0, 7,           # 10 guard (b6 & 0xF7)
              bit_order=(48, 49, 50, 51, 53, 54, 55))),
    sanity=(San(6, "eq", 0), San(7, "eq", 0xF), San(8, "eq", 0),
            San(9, "eq", 0), San(10, "eq", 0)),
    variants=(Variant(fields=(
        F("model", "const", value="Baldr-E0666TH"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", kind="bool", terms=((2, 1, 0),),
          pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("startup", kind="bool", terms=((5, 1, 0),), pretty="Startup"),
    )),),
))


def _single_row_guard(bits):
    if bits.num_rows != 1:
        return DECODE_ABORT_LENGTH
    return None


_spec(DeclSpec(
    # Gasmate-BA1008 meat thermometer (ref src/devices/gasmate_ba1008.c;
    # bbq.py gasmate_ba1008): single 32-bit row, nibble sum == 0x0C,
    # sign-magnitude BCD temperature
    symbol="gasmate_ba1008",
    min_bits=32, max_bits=32, exact_lens=(32,), row_mode="row0",
    host_guard=_single_row_guard, frame_bits=32, in_bits=64,
    checks=(Check("add_nibbles", off=0, nbytes=4, mask=0xF,
                  cmp_const=0x0C),),
    raws=(Raw(0, 5),          # 0 preamble guard (b0 & 0xF8) >> 3
          Raw(5, 1),          # 1 sign
          Raw(6, 2),          # 2 hundreds
          Raw(8, 4),          # 3 tens (BCD)
          Raw(12, 4),         # 4 ones (BCD)
          Raw(16, 12)),       # 5 unknown_1
    sanity=(San(0, "eq", 0x1E),),
    variants=(
        Variant(cond=San(1, "eq", 1), fields=(
            F("model", "const", value="Gasmate-BA1008"),
            F("temperature_C",
              terms=((2, -100, 0), (3, -10, 0), (4, -1, 0)),
              pretty="Temperature_C", fmt="%d C"),
            F("unknown_1", terms=((5, 1, 0),), pretty="Unknown Value",
              fmt="%03x"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
        Variant(fields=(
            F("model", "const", value="Gasmate-BA1008"),
            F("temperature_C",
              terms=((2, 100, 0), (3, 10, 0), (4, 1, 0)),
              pretty="Temperature_C", fmt="%d C"),
            F("unknown_1", terms=((5, 1, 0),), pretty="Unknown Value",
              fmt="%03x"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
    ),
))


_spec(DeclSpec(
    # Auriol 4-LD5661 rain gauge (ref src/devices/auriol_4ld5661.c;
    # meters.py auriol_4ld5661): any 52-bit row, b3 == F0 and
    # (b1 & 0x40) == 0 gates, first decodable row wins
    symbol="auriol_4ld5661",
    min_bits=52, max_bits=52, exact_lens=(52,), row_mode="any",
    frame_bits=56, in_bits=296,
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 1),          # 1 battery
          Raw(12, 12),        # 2 temperature (signed 12)
          Raw(32, 20),        # 3 rain
          Raw(24, 8),         # 4 guard b3
          Raw(9, 1)),         # 5 guard (b1 & 0x40)
    sanity=(San(4, "eq", 0xF0), San(5, "eq", 0)),
    variants=(Variant(fields=(
        F("model", "const", value="Auriol-4LD5661", pretty="Model"),
        F("id", terms=((0, 1, 0),), pretty="ID", fmt="%02x"),
        F("battery_ok", terms=((1, 1, 0),), pretty="Battery OK"),
        F("temperature_C", kind="float", terms=((2, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("rain_mm", kind="float", terms=((3, 1, 0),),
          pretty="Rain", fmt="%.1f mm"),
        F("rain", terms=((3, 1, 0),), pretty="Rain tips"),
    )),),
))


_spec(DeclSpec(
    # Florabest-FBTH1 (ref src/devices/florabest.c; temperature.py
    # florabest): 30-bit rows x3, odd parity over the 30 bits
    symbol="florabest",
    min_bits=30, max_bits=30, exact_lens=(30,), row_mode="repeat",
    min_repeats=3, repeat_min_bits=30, frame_bits=32, in_bits=296,
    checks=(Check("parity_bytes", off=0, nbytes=4, cmp_const=1,
                  bit_map=tuple(range(30)) + (-1,) * 2),),
    raws=(Raw(0, 16),         # 0 id
          Raw(0, 8),          # 1 b0 guard
          Raw(16, 13)),       # 2 temp: (b2 << 5) | (b3 >> 3)
    sanity=(San(1, "eq", 0x49),),
    variants=(Variant(fields=(
        F("model", "const", value="Florabest-FBTH1"),
        F("id", terms=((0, 1, 0),), pretty="Id", fmt="%04x"),
        F("temperature_F", kind="fsum", terms=((2, 0.1),), add=-90.0,
          pretty="Temperature", fmt="%.1f F"),
        F("mic", "const", value="PARITY", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # LaCrosse-TX34IT rain gauge (ref src/devices/lacrosse_tx34.c;
    # lacrosse.py lacrosse_tx34): a2dd4 20-bit preamble, crc8(0x31) over
    # 4 bytes, type nibble 5, events for EVERY matching row
    symbol="lacrosse_tx34",
    min_bits=24, row_mode="all",
    preamble="10100010110111010100",          # a2dd4
    need_bits=40, frame_bits=40, in_bits=512,
    checks=(Check("crc8", off=0, nbytes=4, p1=0x31, p2=0x00,
                  cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 4),          # 0 type nibble
          Raw(4, 6),          # 1 id
          Raw(11, 1),         # 2 battery low
          Raw(10, 1),         # 3 new battery
          Raw(16, 16)),       # 4 rain ticks
    sanity=(San(0, "eq", 5),),
    variants=(Variant(fields=(
        F("model", "const", value="LaCrosse-TX34IT"),
        F("id", terms=((1, 1, 0),)),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("newbattery", terms=((3, 1, 0),), pretty="New battery"),
        F("rain_mm", kind="float", terms=((4, 1, 0),), mul=0.222,
          pretty="Total rain", fmt="%.1f mm"),
        F("rain_raw", terms=((4, 1, 0),), pretty="Raw rain"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


# ---------------------------------------------------------------------------
# Inverted-buffer + repeated-prefix batch (round-5 session 2)
# ---------------------------------------------------------------------------

_spec(DeclSpec(
    # Bresser-3CH (ref src/devices/bresser_3ch.c:37-93; temperature.py
    # bresser_3ch): inverted 40-bit rows x3, sum(b0..b3) == b4,
    # float-exact temperature range gates
    symbol="bresser_3ch",
    min_bits=40, max_bits=42, row_mode="repeat", min_repeats=3,
    repeat_min_bits=40, transform="invert", frame_bits=40, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=4, cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 1),          # 1 battery low
          Raw(10, 2),         # 2 channel
          Raw(12, 12),        # 3 temperature raw
          Raw(24, 8)),        # 4 humidity
    sanity=(San(2, "ne", 0),
            San(4, "le", 100),
            San(3, "ge", -20.0, addi=-900, fmul=0.1),
            San(3, "le", 160.0, addi=-900, fmul=0.1)),
    variants=(Variant(fields=(
        F("model", "const", value="Bresser-3CH"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("channel", terms=((2, 1, 0),), pretty="Channel"),
        F("battery_ok", terms=((1, -1, 0),), add=1, pretty="Battery"),
        F("temperature_F", kind="float", terms=((3, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


def _tfa_3221_rows(bits):
    # data-dependent repeat count (ref src/devices/tfa_30_3221.c:52-60)
    row = bits.find_repeated_row(4 if bits.num_rows > 4 else 2, 40)
    if row < 0:
        return DECODE_ABORT_EARLY
    return [row]


_spec(DeclSpec(
    # TFA-303221 (ref src/devices/tfa_30_3221.c; temperature.py
    # tfa_30_3221): inverted rows, reflected LFSR-8 gen 0x31 key 0xF4
    symbol="tfa_30_3221",
    min_bits=40, max_bits=41, row_mode="any", host_guard=_tfa_3221_rows,
    transform="invert", frame_bits=40, in_bits=296,
    checks=(Check("lfsr_digest8_reflect", off=0, nbytes=4, p1=0x31,
                  p2=0xF4, cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(10, 2),         # 1 channel
          Raw(8, 1),          # 2 battery low
          Raw(12, 12),        # 3 temperature raw
          Raw(24, 8),         # 4 humidity
          Raw(9, 1)),         # 5 sendmode
    sanity=(San(0, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="TFA-303221"),
        F("id", terms=((0, 1, 0),), pretty="Sensor ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 0),), add=-500,
          mul=0.1, pretty="Temperature", fmt="%.2f C"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("sendmode", terms=((5, 1, 0),), pretty="Test mode"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _hg02832_guard(bits):
    # exactly a 1-bit preamble row + a 40-bit data row
    # (ref src/devices/auriol_hg02832.c:47-56)
    if bits.num_rows != 2:
        return DECODE_ABORT_EARLY
    if bits.bits_per_row[0] != 1 or bits.bits_per_row[1] != 40:
        return DECODE_ABORT_LENGTH
    return [1]


def _xor4_crc8_bits(p1, p2):
    # crc8 of the single byte b0^b1^b2^b3: the unit-bit digest table
    # fans out to all four frame bytes (GF(2)-linear in each)
    from ..bits import util as _bu
    zero = int(_bu.crc8(bytes(1), 1, p1, p2))
    out = []
    for k in range(8):
        w = int(_bu.crc8(bytes([0x80 >> k]), 1, p1, p2)) ^ zero
        for byte in range(4):
            out.append((byte * 8 + k, w))
    return tuple(out)


_spec(DeclSpec(
    # Auriol-HG02832 (ref src/devices/auriol_hg02832.c; temperature.py
    # auriol_hg02832): inverted, crc8(b0^b1^b2^b3) == b4 via xor_bits
    symbol="auriol_hg02832",
    min_bits=40, max_bits=40, exact_lens=(40,), row_mode="any",
    host_guard=_hg02832_guard, transform="invert",
    frame_bits=40, in_bits=64,
    checks=(Check("crc8", off=0, nbytes=1, p1=0x31, p2=0x53,
                  bit_map=(-1,) * 8, xor_bits=_xor4_crc8_bits(0x31, 0x53),
                  cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(18, 2),         # 1 channel
          Raw(16, 1),         # 2 battery low
          Raw(20, 12),        # 3 temperature (signed 12)
          Raw(8, 8),          # 4 humidity
          Raw(17, 1)),        # 5 button
    variants=(Variant(fields=(
        F("model", "const", value="Auriol-HG02832"),
        F("id", terms=((0, 1, 0),)),
        F("channel", terms=((1, 1, 0),), add=1),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", kind="float", terms=((4, 1, 0),),
          pretty="Humidity", fmt="%.0f %%"),
        F("button", terms=((5, 1, 0),), pretty="Button"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # EMOS-E6016R rain gauge (ref src/devices/emos_e6016_rain.c;
    # meters.py emos_e6016_rain): 55 5A 75 preamble read pre-invert
    # (post-invert AA A5 8A), checksum over inverted bytes
    symbol="emos_e6016_rain",
    min_bits=72, max_bits=73, row_mode="repeat", min_repeats=3,
    repeat_min_bits=72, transform="invert", frame_bits=72, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=8, cmp_off=64, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 sync AA
          Raw(8, 8),          # 1 sync A5
          Raw(16, 8),         # 2 sync 8A
          Raw(24, 8),         # 3 id
          Raw(32, 2),         # 4 battery (b4 >> 6)
          Raw(52, 12)),       # 5 rain raw
    sanity=(San(0, "eq", 0xAA), San(1, "eq", 0xA5), San(2, "eq", 0x8A)),
    variants=(Variant(fields=(
        F("model", "const", value="EMOS-E6016R"),
        F("id", terms=((3, 1, 0),), pretty="House Code"),
        F("battery_ok", kind="bool", terms=((4, 1, 0),),
          pretty="Battery_OK"),
        F("rain_mm", kind="float", terms=((5, 1, 0),), mul=0.7,
          pretty="Rain_mm", fmt="%.1f mm"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Rubicson-48942 pool thermometer (ref src/devices/
    # rubicson_pool_48942.c; temperature.py rubicson_pool_48942):
    # inverted 41-bit rows x2, crc8(0x31) over 4 bytes
    symbol="rubicson_pool_48942",
    min_bits=41, max_bits=41, exact_lens=(41,), row_mode="repeat",
    min_repeats=2, repeat_min_bits=41, transform="invert",
    frame_bits=48, in_bits=296,
    checks=(Check("crc8", off=0, nbytes=4, p1=0x31, p2=0x00,
                  cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 4),          # 0 channel
          Raw(4, 10),         # 1 id
          Raw(16, 1),         # 2 battery low
          Raw(17, 11),        # 3 temperature raw
          Raw(28, 4),         # 4 guard (b3 & 0x0F)
          Raw(40, 8),         # 5 guard b5
          # 6: b0|b2|b4 zero guard
          Raw(0, 24, bit_order=tuple(range(0, 8)) + tuple(range(16, 24))
              + tuple(range(32, 40)))),
    sanity=(San(4, "eq", 0), San(5, "eq", 0), San(6, "ne", 0)),
    variants=(Variant(fields=(
        F("model", "const", value="Rubicson-48942"),
        F("channel", terms=((0, 1, 0),), add=1, pretty="Channel"),
        F("id", terms=((1, 1, 0),), pretty="Random ID"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 0),), add=-1024,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _vauno_rows(bits):
    # repeated 42-bit prefix x4 (ref src/devices/vauno_en8822c.c:60-70)
    row = bits.find_repeated_prefix(4, 42)
    if row < 0:
        return DECODE_ABORT_EARLY
    return [row]


_spec(DeclSpec(
    # Vauno-EN8822C (ref src/devices/vauno_en8822c.c; temperature.py
    # vauno_en8822c): 6-bit nibble-sum check across a byte boundary
    symbol="vauno_en8822c",
    min_bits=42, row_mode="any", host_guard=_vauno_rows,
    frame_bits=48, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=6, mask=0x3F,
                  cmp_off=36, cmp_width=6,
                  bit_map=tuple(range(36)) + (-1,) * 12),),
    raws=(Raw(0, 8),          # 0 id
          Raw(10, 2),         # 1 channel
          Raw(35, 1),         # 2 battery low (b4 & 0x10)
          Raw(12, 12),        # 3 temperature (signed 12)
          Raw(24, 7),         # 4 humidity (b3 >> 1)
          Raw(0, 32),         # 5 nonzero guard lo
          Raw(32, 4)),        # 6 nonzero guard hi
    sanity=((San(5, "ne", 0), San(6, "ne", 0)),),
    variants=(Variant(fields=(
        F("model", "const", value="Vauno-EN8822C"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", terms=((4, 1, 0),), pretty="Humidity", fmt="%u %%"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


def _schou_rows(bits):
    # (ref src/devices/schou_72543_rain.c:47-58)
    if bits.num_rows < 2:
        return DECODE_ABORT_LENGTH
    row = bits.find_repeated_prefix(2, 64)
    if row < 0:
        return DECODE_ABORT_EARLY
    return [row]


_spec(DeclSpec(
    # Schou 72543 Day rain gauge (ref src/devices/schou_72543_rain.c;
    # meters.py schou_72543_rain): LE temp/rain words, byte checksum
    symbol="schou_72543_rain",
    min_bits=64, row_mode="any", host_guard=_schou_rows,
    frame_bits=64, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=7, cmp_off=56, cmp_width=8),),
    raws=(Raw(0, 16),         # 0 id
          Raw(0, 16,          # 1 temp: (b6 << 8) | b5
              bit_order=tuple(range(48, 56)) + tuple(range(40, 48))),
          Raw(0, 16,          # 2 rain: (b4 << 8) | b3
              bit_order=tuple(range(32, 40)) + tuple(range(24, 32))),
          Raw(16, 1),         # 3 battery low
          Raw(20, 3),         # 4 msg counter
          Raw(17, 1),         # 5 msg repeat
          Raw(0, 32),         # 6 nonzero guard lo
          Raw(32, 24)),       # 7 nonzero guard hi
    sanity=((San(6, "ne", 0), San(7, "ne", 0)),),
    variants=(Variant(fields=(
        F("model", "const", value="Schou-72543"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("temperature_F", kind="float", terms=((1, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.1f F"),
        F("rain_mm", kind="float", terms=((2, 1, 0),), mul=0.1,
          pretty="Rain", fmt="%.1f mm"),
        F("battery_ok", terms=((3, -1, 0),), add=1, pretty="Battery_ok"),
        F("msg_counter", terms=((4, 1, 0),), pretty="Counter"),
        F("msg_repeat", kind="bool", terms=((5, 1, 0),),
          pretty="Msg_repeat"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Inovalley KW9015B rain/temperature (ref src/devices/
    # inovalley-kw9015b.c; meters.py kw9015b): all fields read through
    # reverse8; nibble-sum check over reflected bytes, expected nibble at
    # DESCENDING frame positions via sub_bits
    symbol="kw9015b",
    min_bits=36, max_bits=36, row_mode="repeat", min_repeats=3,
    repeat_min_bits=36, frame_bits=40, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=4, mask=0xF, reflect=True,
                  cmp_const=0, sub_bits=((35, 8), (34, 4), (33, 2),
                                         (32, 1))),),
    raws=(Raw(0, 4, bit_order=(3, 2, 1, 0)),   # 0 id (r0 & 0x0F)
          Raw(8, 1),                           # 1 battery (b1 >> 7)
          Raw(0, 12, bit_order=(23, 22, 21, 20, 19, 18, 17, 16,
                                15, 14, 13, 12)),  # 2 temp (signed 12)
          Raw(0, 12, bit_order=(7, 6, 10, 9, 31, 30, 29, 28,
                                27, 26, 25, 24))),  # 3 rain
    variants=(Variant(fields=(
        F("model", "const", value="Inovalley-kw9015b"),
        F("id", terms=((0, 1, 0),)),
        F("battery_ok", terms=((1, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((2, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("rain", terms=((3, 1, 0),), pretty="Rain Count"),
        F("rain_mm", kind="float", terms=((3, 1, 0),), mul=0.45,
          pretty="Rain total", fmt="%.1f mm"),
    )),),
))


def _wec2103_guard(bits):
    # six rows, the 42-bit third gates, the fourth decodes
    # (ref src/devices/wec2103.c:56-64)
    if bits.num_rows != 6 or bits.bits_per_row[2] != 42:
        return DECODE_ABORT_LENGTH
    return [3]


_spec(DeclSpec(
    # WEC-2103 (ref src/devices/wec2103.c; temperature.py wec2103):
    # CRC-4 over a nibble-shuffled message, result xored with b4 >> 4
    symbol="wec2103",
    min_bits=0, row_mode="any", host_guard=_wec2103_guard,
    frame_bits=40, in_bits=296,
    checks=(Check("crc4", off=0, nbytes=4, p1=0x3, p2=0x0,
                  bit_map=tuple(range(0, 8))
                  + (36, 37, 38, 39, 12, 13, 14, 15)
                  + tuple(range(16, 32)),
                  xor_bits=((32, 8), (33, 4), (34, 2), (35, 1)),
                  cmp_off=8, cmp_width=4),),
    raws=(Raw(0, 8),          # 0 id
          Raw(36, 4),         # 1 channel
          Raw(12, 1),         # 2 button (b1 & 0x08)
          Raw(16, 12),        # 3 temperature raw
          Raw(28, 4),         # 4 humidity tens
          Raw(32, 4),         # 5 humidity ones
          Raw(12, 4)),        # 6 flags
    variants=(Variant(fields=(
        F("model", "const", value="WEC-2103"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("channel", terms=((1, 1, 0),), pretty="Channel"),
        F("battery_ok", "const", value=1, pretty="Battery"),
        F("button", terms=((2, 1, 0),), pretty="Button"),
        F("temperature_F", kind="float", terms=((3, 1, 0),), add=-900,
          mul=0.1, pretty="Temperature", fmt="%.2f F"),
        F("humidity", terms=((4, 10, 0), (5, 1, 0)), pretty="Humidity",
          fmt="%u %%"),
        F("flags", terms=((6, 1, 0),), pretty="Flags"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


# ---------------------------------------------------------------------------
# FSK PCM preamble-framed batch (round-5 session 2)
# ---------------------------------------------------------------------------

_spec(DeclSpec(
    # Fineoffset-WH55 water leak (ref src/devices/fineoffset_wh55.c;
    # fineoffset3.py fineoffset_wh55): aa2dd455 sync, frame back at
    # match+24 (the 55 byte is frame byte 0), crc8(0x31) over 9 == 0
    symbol="fineoffset_wh55",
    min_bits=0, row_mode="row0", host_guard=_single_row_guard,
    preamble="10101010001011011101010001010101",   # aa2dd455
    align_off=-8, need_bits=72, frame_bits=96, in_bits=512,
    checks=(Check("crc8", off=0, nbytes=9, p1=0x31, p2=0x00,
                  cmp_const=0),),
    raws=(Raw(16, 16),        # 0 id
          Raw(8, 4),          # 1 channel
          Raw(32, 8),         # 2 battery raw
          Raw(40, 16),        # 3 raw value
          Raw(56, 1),         # 4 sensitivity
          Raw(57, 1)),        # 5 alarm
    variants=(Variant(fields=(
        F("model", "const", value="Fineoffset-WH55"),
        F("id", terms=((0, 1, 0),), pretty="ID", fmt="%05X"),
        F("channel", terms=((1, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", kind="float", terms=((2, 1, 0),), mul=0.2,
          pretty="Battery level"),
        F("raw_value", terms=((3, 1, 0),), pretty="Raw Value"),
        F("sensitivity", terms=((4, 1, 0),), pretty="Sensitivity"),
        F("alarm", terms=((5, 1, 0),), pretty="Alarm"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # TFA-Marbella pool thermometer (ref src/devices/tfa_marbella.c;
    # temperature.py tfa_marbella): frame INCLUDES the aa2dd4 sync
    # (fields at msg[3..10]), reflected LFSR over msg[3:10]
    symbol="tfa_marbella",
    min_bits=0, row_mode="row0",
    preamble="101010100010110111010100",           # aa2dd4
    align_off=-24, frame_bits=88, in_bits=512,
    checks=(Check("lfsr_digest8_reflect", off=24, nbytes=7, p1=0x31,
                  p2=0x31, cmp_off=80, cmp_width=8),),
    raws=(Raw(24, 24),        # 0 serial
          Raw(52, 3),         # 1 counter ((msg6 >> 1) & 7)
          Raw(48, 1),         # 2 battery low (msg6 >> 7)
          Raw(56, 12),        # 3 temperature raw
          Raw(72, 8)),        # 4 msg9 guard (== AA)
    sanity=(San(4, "eq", 0xAA),),
    variants=(Variant(fields=(
        F("model", "const", value="TFA-Marbella"),
        F("id", kind="hexs", terms=((0, 1, 0),), val=6),
        F("counter", terms=((1, 1, 0),)),
        F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((3, 1, 0),), add=-400,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Mueller-HotRod water meter (ref src/devices/mueller_hotrod.c;
    # meters.py mueller_hotrod): feb100 sync, crc8(0x07) ^ 0x55 == b8,
    # 7-digit BCD volume
    symbol="mueller_hotrod",
    min_bits=96, row_mode="row0", host_guard=_single_row_guard,
    preamble="111111101011000100000000",           # feb100
    need_bits=49, frame_bits=72, in_bits=512,
    checks=(Check("crc8", off=0, nbytes=8, p1=0x07, p2=0x00,
                  xor_out=0x55, cmp_off=64, cmp_width=8),),
    raws=(Raw(0, 32),         # 0 id bytes
          Raw(32, 4),         # 1 BCD digit 1e6
          Raw(36, 4),         # 2 1e5
          Raw(40, 4),         # 3 1e4
          Raw(44, 4),         # 4 1e3
          Raw(48, 4),         # 5 1e2
          Raw(52, 4),         # 6 1e1
          Raw(56, 4),         # 7 1e0 (x10 in the sum)
          Raw(60, 4)),        # 8 flag
    variants=(Variant(fields=(
        F("model", "const", value="Mueller-HotRod"),
        F("id", kind="hexs", terms=((0, 1, 0),), val=8),
        F("volume_gal",
          terms=((1, 1000000, 0), (2, 100000, 0), (3, 10000, 0),
                 (4, 1000, 0), (5, 100, 0), (6, 10, 0), (7, 1, 0)),
          pretty="Volume", fmt="%u gal"),
        F("flag", terms=((8, 1, 0),), pretty="Flag", fmt="%x"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Quinetic switches (ref src/devices/quinetic.c; misc): a423 sync,
    # CRC-16/CCITT-FALSE over 5 bytes == 0, channel 192 = release
    symbol="quinetic",
    min_bits=110, max_bits=140, row_mode="row0",
    preamble="1010010000100011",                   # a423
    frame_bits=40, in_bits=296,
    checks=(Check("crc16", off=0, nbytes=5, p1=0x1021, p2=0x1D0F,
                  cmp_const=0),),
    raws=(Raw(0, 16),         # 0 id
          Raw(16, 8)),        # 1 channel
    sanity=(San(1, "ne", 192),),
    variants=(Variant(fields=(
        F("model", "const", value="Quinetic", pretty="Model"),
        F("id", terms=((0, 1, 0),), pretty="ID", fmt="%04x"),
        F("channel", terms=((1, 1, 0),), pretty="Channel"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Eco-Eye PV/grid current monitor (ref src/devices/ecoeye.c;
    # energy.py ecoeye): aa2dd4 sync, byte-sum checksum
    symbol="ecoeye",
    min_bits=0, row_mode="row0", host_guard=_single_row_guard,
    preamble="101010100010110111010100",           # aa2dd4
    need_bits=40, frame_bits=40, in_bits=512,
    checks=(Check("add_bytes", off=0, nbytes=4, cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 16),         # 0 PV current
          Raw(16, 16)),       # 1 used current
    variants=(Variant(fields=(
        F("model", "const", value="EcoEye"),
        F("current_used_A", kind="float", terms=((1, 1, 0),), mul=0.01,
          pretty="Used", fmt="%.2f A"),
        F("current_pv_A", kind="float", terms=((0, 1, 0),), mul=0.01,
          pretty="PV", fmt="%.2f A"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # McPower-Kinetic switch (ref src/devices/mcpower_kinetic.c; misc):
    # aaaa sync, CRC-16/CCITT init AA55 == trailing word
    symbol="mcpower_kinetic",
    min_bits=0, row_mode="row0", host_guard=_single_row_guard,
    preamble="1010101010101010",                   # aaaa
    need_bits=48, frame_bits=48, in_bits=512,
    checks=(Check("crc16", off=0, nbytes=4, p1=0x1021, p2=0xAA55,
                  cmp_off=32, cmp_width=16),),
    raws=(Raw(0, 16),         # 0 id
          Raw(17, 1),         # 1 left button
          Raw(18, 1),         # 2 right button
          Raw(20, 4),         # 3 counter
          Raw(24, 8)),        # 4 flags
    variants=(Variant(fields=(
        F("model", "const", value="McPower-Kinetic"),
        F("id", terms=((0, 1, 0),), pretty="", fmt="%04x"),
        F("button_left", terms=((1, 1, 0),), pretty="Left button"),
        F("button_right", terms=((2, 1, 0),), pretty="Right button"),
        F("counter", terms=((3, 1, 0),), pretty="Counter"),
        F("flags", terms=((4, 1, 0),), pretty="Flags", fmt="%02x"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # WG-PB12V1 temperature (ref src/devices/wg_pb12v1.c;
    # temperature.py wg_pb12v1): FF sync byte, crc8(0x31) over b1..b4
    symbol="wg_pb12v1",
    min_bits=48, row_mode="row0", frame_bits=48, in_bits=296,
    checks=(Check("crc8", off=8, nbytes=4, p1=0x31, p2=0x00,
                  cmp_off=40, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 sync (== FF)
          Raw(8, 4),          # 1 type nibble (== 3)
          Raw(27, 5),         # 2 id
          Raw(12, 12),        # 3 temperature raw
          Raw(32, 8)),        # 4 b4 guard (== FF)
    sanity=(San(0, "eq", 0xFF), San(1, "eq", 0x3), San(4, "eq", 0xFF)),
    variants=(Variant(fields=(
        F("model", "const", value="WG-PB12V1"),
        F("id", terms=((2, 1, 0),), pretty="ID"),
        F("temperature_C", kind="float", terms=((3, 1, 0),), add=-400,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Chuango-Security x1527 (ref src/devices/chuango.c; misc_a.py
    # chuango): first 3 bytes inverted in place; bit 24 reads inverted
    # under the whole-row invert, so its gate flips to eq 0
    symbol="chuango",
    min_bits=25, max_bits=25, exact_lens=(25,), row_mode="row0",
    transform="invert", frame_bits=32, in_bits=64,
    raws=(Raw(0, 20),         # 0 id
          Raw(20, 4),         # 1 cmd
          Raw(24, 1),         # 2 (b3 & 0x80), inverted
          Raw(0, 20)),        # 3 zero guard (b0|b1|b2&F0)
    sanity=(San(2, "eq", 0), San(3, "ne", 0)),
    variants=(Variant(fields=(
        F("model", "const", value="Chuango-Security"),
        F("id", terms=((0, 1, 0),), pretty="ID"),
        F("cmd", kind="enum", terms=((1, 1, 0),), default="",
          map={0xF: "?", 0xE: "?", 0xD: "Low Battery", 0xC: "Closing",
               0xB: "24H Zone", 0xA: "Single Delay Zone", 0x9: "?",
               0x8: "Arm", 0x7: "Normal Zone", 0x6: "Home Mode Zone",
               0x5: "On", 0x4: "Home Mode", 0x3: "Tamper", 0x2: "Alarm",
               0x1: "Disarm", 0x0: "Test"},
          pretty="CMD"),
        F("cmd_id", terms=((1, 1, 0),), pretty="CMD_ID"),
    )),),
))


# ---------------------------------------------------------------------------
# Remotes / security + probed-GF(2) batch (round-5 session 2)
# ---------------------------------------------------------------------------

def _nibblefold_xor_bits(nbits):
    # contribution of frame bit f to the nibble-folded byte XOR
    # (s >> 4) ^ (s & 0xF): weight 8 >> (f % 4)
    return tuple((f, 8 >> (f % 4)) for f in range(nbits))


_spec(DeclSpec(
    # Visonic Powercode (ref src/devices/visonic_powercode.c;
    # garage.py visonic_powercode): 37-bit rows x2, frame at bit 1,
    # nibble-folded XOR LRC == 0
    symbol="visonic_powercode",
    min_bits=37, max_bits=37, exact_lens=(37,), row_mode="repeat",
    min_repeats=2, repeat_min_bits=37, align_off=1,
    frame_bits=40, in_bits=296,
    checks=(Check("xor_bytes", off=0, nbytes=1, mask=0xF,
                  bit_map=(-1,) * 8, xor_bits=_nibblefold_xor_bits(40),
                  cmp_const=0),),
    raws=(Raw(0, 24),         # 0 id
          Raw(24, 1),         # 1 tamper
          Raw(25, 1),         # 2 alarm
          Raw(26, 1),         # 3 battery low
          Raw(27, 1),         # 4 else
          Raw(28, 1),         # 5 restore
          Raw(29, 1),         # 6 supervised
          Raw(30, 1),         # 7 spidernet
          Raw(31, 1),         # 8 repeater
          Raw(0, 32),         # 9 nonzero guard lo
          Raw(32, 8)),        # 10 nonzero guard hi
    sanity=((San(9, "ne", 0), San(10, "ne", 0)),),
    variants=(Variant(fields=(
        F("model", "const", value="Visonic-Powercode", pretty="Model"),
        F("id", kind="hexs", terms=((0, 1, 0),), val=6, pretty="ID"),
        F("tamper", terms=((1, 1, 0),), pretty="Tamper"),
        F("alarm", terms=((2, 1, 0),), pretty="Alarm"),
        F("battery_ok", terms=((3, -1, 0),), add=1, pretty="Battery"),
        F("else", terms=((4, 1, 0),), pretty="Else"),
        F("restore", terms=((5, 1, 0),), pretty="Restore"),
        F("supervised", terms=((6, 1, 0),), pretty="Supervised"),
        F("spidernet", terms=((7, 1, 0),), pretty="Spidernet"),
        F("repeater", terms=((8, 1, 0),), pretty="Repeater"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Honda car key (ref src/devices/hondaremote.c; car_remotes.py
    # hondaremote): 385-394 bit rows, FF guards, cmd byte - 0xAA
    symbol="hondaremote",
    min_bits=385, max_bits=394, row_mode="any",
    frame_bits=376, in_bits=512,
    raws=(Raw(0, 8),          # 0 b0 guard
          Raw(304, 8),        # 1 b38 guard
          Raw(352, 16),       # 2 id
          Raw(368, 8)),       # 3 cmd byte
    sanity=(San(0, "eq", 0xFF), San(1, "eq", 0xFF)),
    variants=(Variant(fields=(
        F("model", "const", value="Honda-CarRemote"),
        F("id", terms=((2, 1, 0),)),
        F("code", kind="enum", terms=((3, 1, 0),), add=-0xAA,
          map={0: "boot", 1: "unlock", 2: "lock"}, default="unknown"),
    )),),
))


_spec(DeclSpec(
    # Generic-Remote SC226x/EV1527 (ref src/devices/generic_remote.c:
    # 17-63; remotes.py generic_remote): 25-bit rows, first 3 bytes
    # inverted, tristate code rendering
    symbol="generic_remote",
    min_bits=25, max_bits=25, exact_lens=(25,), row_mode="row0",
    transform="invert", frame_bits=32, in_bits=64,
    raws=(Raw(0, 16),         # 0 id (house code)
          Raw(16, 8),         # 1 cmd
          Raw(24, 1),         # 2 raw bit 24 (inverted here)
          Raw(0, 24)),        # 3 tristate source
    sanity=(San(2, "eq", 0), San(0, "ne", 0), San(1, "ne", 0)),
    variants=(Variant(fields=(
        F("model", "const", value="Generic-Remote"),
        F("id", terms=((0, 1, 0),), pretty="House Code"),
        F("cmd", terms=((1, 1, 0),), pretty="Command"),
        F("tristate", kind="tri", terms=((3, 1, 0),), value="0ZX1",
          val=12, pretty="Tri-State"),
    )),),
))


_spec(DeclSpec(
    # Dickert MAHS433-01 garage remote (ref src/devices/dickert_mahs.c;
    # gates.py dickert_pwm): 37-bit single row, frame at bit 1, two
    # trinary switch banks
    symbol="dickert_pwm",
    min_bits=37, max_bits=37, exact_lens=(37,), row_mode="row0",
    host_guard=_single_row_guard, align_off=1, frame_bits=36, in_bits=64,
    raws=(Raw(0, 20),         # 0 id / dip source
          Raw(20, 16)),       # 1 fac source
    variants=(Variant(fields=(
        F("model", "const", value="Dickert-MAHS433"),
        F("id", terms=((0, 1, 0),), pretty=""),
        F("dipswitch", kind="tri", terms=((0, 1, 0),), value="-0?+",
          val=10, pretty="DIP switches"),
        F("facswitch", kind="tri", terms=((1, 1, 0),), value="-0?+",
          val=8, pretty="Factory code"),
    )),),
))


def _markisol_rows(bits):
    # first row with 41/42 bits (ref src/devices/markisol.c:96-103)
    for i in range(bits.num_rows):
        if bits.bits_per_row[i] in (41, 42):
            return [i]
    return DECODE_ABORT_EARLY


_spec(DeclSpec(
    # Markisol / E-Motion / BOFU curtain remote (ref src/devices/
    # markisol.c; remotes3.py markisol): bytes re-read at bit 1,
    # reverse8'd and inverted; sum(buf) == 1 folds to a reflected
    # byte-sum == 250 over the raw window
    symbol="markisol",
    min_bits=41, max_bits=42, row_mode="any", host_guard=_markisol_rows,
    frame_bits=48, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=5, reflect=True,
                  bit_map=tuple(range(1, 41)), cmp_const=250),),
    raws=(Raw(0, 16,          # 0 id source (reversed window, un-inverted)
              bit_order=(8, 7, 6, 5, 4, 3, 2, 1,
                         16, 15, 14, 13, 12, 11, 10, 9)),
          Raw(0, 4, bit_order=(24, 23, 29, 21)),   # 1 control source
          Raw(0, 4, bit_order=(20, 19, 18, 17)),   # 2 channel source
          Raw(22, 1),         # 3 zone bit (buf2 & 0x20)
          Raw(32, 1)),        # 4 zone bit (buf3 & 0x80)
    variants=(Variant(fields=(
        F("model", "const", value="Markisol", pretty="Model"),
        F("id", terms=((0, -1, 0),), add=0xFFFF, pretty="", fmt="%04X"),
        F("control", kind="enum", terms=((1, -1, 0),), add=15,
          map={0: "Limit (0)", 1: "Down (1)", 2: "? (2)",
               3: "H-Down (3)", 4: "Confirm (4)", 5: "Stop (5)",
               6: "? (6)", 7: "? (7)", 8: "? (8)", 9: "? (9)",
               10: "? (10)", 11: "? (11)", 12: "Up (12)",
               13: "Limit (13)", 14: "H-Up (14)", 15: "? (15)"},
          pretty="Control"),
        F("channel", terms=((2, -1, 0),), add=15, pretty="Channel"),
        F("zone", terms=((3, -1, 0), (4, -2, 0)), add=4, pretty="Zone"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


def _audiovox_buttons():
    names = ["Lock", "Unlock", "Option", "Trunk"]
    return {v: "; ".join(names[i] for i in range(4) if v & (1 << i))
            for v in range(1, 16)}


_spec(DeclSpec(
    # Audiovox-PROOE3B car remote (ref src/devices/audiovox_pro_oe3b.c;
    # car_remotes.py audiovox_pro_oe3b): raw-b2 gates, then id/buttons
    # from inverted bytes
    symbol="audiovox_pro_oe3b",
    min_bits=25, max_bits=25, exact_lens=(25,), row_mode="row0",
    host_guard=_single_row_guard, frame_bits=32, in_bits=64,
    raws=(Raw(0, 4, bit_order=(16, 18, 20, 22)),  # 0 b2 & 0xAA packed
          Raw(16, 8),                             # 1 b2
          Raw(0, 16),                             # 2 id source
          Raw(0, 4, bit_order=(17, 19, 21, 23))), # 3 buttons source
    sanity=(San(0, "eq", 0), San(1, "ne", 0x55),
            San(2, "ne", 0xFFFF), San(2, "ne", 0), San(3, "ne", 15)),
    variants=(Variant(fields=(
        F("model", "const", value="Audiovox-PROOE3B", pretty="model"),
        F("id", kind="hexsu", terms=((2, -1, 0),), add=0xFFFF, val=4,
          pretty="ID"),
        F("button_str", kind="enum", terms=((3, -1, 0),), add=15,
          map=_audiovox_buttons(), pretty="Button"),
    )),),
))


_spec(DeclSpec(
    # Universal 24V fan controller (ref src/devices/universalfanctrl.c;
    # remotes4.py universalfanctrl): nibble-folded XOR == 0xA
    symbol="universalfanctrl",
    min_bits=33, row_mode="repeat", min_repeats=3, repeat_min_bits=33,
    frame_bits=40, in_bits=296,
    checks=(Check("xor_bytes", off=0, nbytes=1, mask=0xF,
                  bit_map=(-1,) * 8, xor_bits=_nibblefold_xor_bits(32),
                  cmp_const=0xA),),
    raws=(Raw(32, 1),         # 0 guard (b4 & 0x80)
          Raw(0, 20),         # 1 transmitter id
          Raw(20, 5),         # 2 button code
          Raw(25, 3)),        # 3 rolling counter
    sanity=(San(0, "eq", 1),),
    variants=(Variant(fields=(
        F("model", "const", value="UniFan-24V"),
        F("id", terms=((1, 1, 0),), pretty="Transmitter ID"),
        F("button", kind="enum", terms=((2, 1, 0),), default="Unknown",
          map={0x19: "All Off", 0x17: "Light On/Off", 0x1B: "Forward",
               0x0A: "Fan", 0x0E: "Reverse", 0x09: "Fan Off",
               0x0F: "Speed 1", 0x0D: "Speed 2", 0x03: "Speed 3",
               0x15: "Speed 4", 0x10: "Speed 5", 0x13: "speed 6",
               0x1D: "1H", 0x16: "2H", 0x06: "3H"},
          pretty="Button"),
        F("button_code", terms=((2, 1, 0),), pretty="Button Code"),
        F("counter", terms=((3, 1, 0),), pretty="Rolling Counter"),
        F("mic", "const", value="CHECKSUM", pretty=""),
    )),),
))


_spec(DeclSpec(
    # TFA Twin Plus 30.3049 / Conrad KW9010 (ref src/devices/
    # tfa_twin_plus_30.3049.c; temperature.py tfa_twin_plus_303049):
    # reversed-byte nibble sum, 9-bit offset-512 temperature
    symbol="tfa_twin_plus_303049",
    min_bits=36, max_bits=36, exact_lens=(36,), row_mode="repeat",
    min_repeats=2, repeat_min_bits=36, frame_bits=40, in_bits=296,
    checks=(Check("add_nibbles", off=0, nbytes=4, mask=0xF, reflect=True,
                  cmp_const=0, sub_bits=((35, 8), (34, 4), (33, 2),
                                         (32, 1))),),
    raws=(Raw(0, 6, bit_order=(7, 6, 3, 2, 1, 0)),   # 0 id
          Raw(4, 2),          # 1 channel
          Raw(8, 1),          # 2 battery low
          Raw(0, 9,           # 3 temperature
              bit_order=(20, 19, 18, 17, 16, 15, 14, 13, 12)),
          Raw(21, 3),         # 4 negative sign (b2 & 7)
          Raw(0, 7,           # 5 humidity (rb3 & 0x7F)
              bit_order=(30, 29, 28, 27, 26, 25, 24)),
          Raw(0, 32),         # 6 nonzero guard lo
          Raw(32, 8)),        # 7 nonzero guard hi
    sanity=((San(6, "ne", 0), San(7, "ne", 0)),),
    variants=(
        Variant(cond=San(4, "ne", 0), fields=(
            F("model", "const", value="TFA-TwinPlus"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("channel", terms=((1, 1, 0),), pretty="Channel"),
            F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
            F("temperature_C", kind="float", terms=((3, 1, 0),),
              add=-512, mul=0.1, pretty="Temperature", fmt="%.1f C"),
            F("humidity", terms=((5, 1, 0),), add=-28, pretty="Humidity",
              fmt="%u %%"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
        Variant(fields=(
            F("model", "const", value="TFA-TwinPlus"),
            F("id", terms=((0, 1, 0),), pretty="Id"),
            F("channel", terms=((1, 1, 0),), pretty="Channel"),
            F("battery_ok", terms=((2, -1, 0),), add=1, pretty="Battery"),
            F("temperature_C", kind="float", terms=((3, 1, 0),),
              mul=0.1, pretty="Temperature", fmt="%.1f C"),
            F("humidity", terms=((5, 1, 0),), add=-28, pretty="Humidity",
              fmt="%u %%"),
            F("mic", "const", value="CHECKSUM", pretty="Integrity"),
        )),
    ),
))


def _gt_wt_03_rows(bits):
    # (ref src/devices/gt_wt_03.c:118-125)
    row = 0
    if bits.num_rows > 1:
        row = bits.find_repeated_row(bits.num_rows // 2 + 1, 41)
    if row < 0:
        return DECODE_ABORT_LENGTH
    return [row]


def _rollbyte_bits(gen, nbits):
    # decoders/home2.py _chk_rollbyte: window bit f contributes
    # (gen >> (f % 8)) & 0xFF — a rolling-key byte XOR, GF(2)-linear
    return tuple((f, (gen >> (f % 8)) & 0xFF) for f in range(nbits))


_spec(DeclSpec(
    # Globaltronics GT-WT-03 (ref src/devices/gt_wt_03.c; home2.py
    # gt_wt_03): inverted rows, rolling-byte checksum gen 0x3100 ^ 0x2D,
    # humidity sentinels 10/110, float-exact temperature range
    symbol="gt_wt_03",
    min_bits=41, max_bits=41, exact_lens=(41,), row_mode="any",
    host_guard=_gt_wt_03_rows, transform="invert",
    frame_bits=48, in_bits=296,
    checks=(Check("xor_bytes", off=0, nbytes=1, bit_map=(-1,) * 8,
                  xor_bits=_rollbyte_bits(0x3100, 32), xor_out=0x2D,
                  cmp_off=32, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 id
          Raw(8, 8),          # 1 humidity raw
          Raw(18, 2),         # 2 channel
          Raw(16, 1),         # 3 battery low
          Raw(20, 12),        # 4 temperature (signed 12)
          Raw(17, 1),         # 5 button
          Raw(0, 32),         # 6 nonzero guard lo
          Raw(32, 8)),        # 7 nonzero guard hi
    sanity=((San(6, "ne", 0), San(7, "ne", 0)),
            San(4, "gt", -50.2, signed_bits=12, fmul=0.1),
            San(4, "lt", 70.2, signed_bits=12, fmul=0.1),
            (San(1, "eq", 10), San(1, "eq", 110), San(1, "ge", 20)),
            (San(1, "eq", 10), San(1, "eq", 110), San(1, "le", 95))),
    variants=(Variant(fields=(
        F("model", "const", value="GT-WT03"),
        F("id", terms=((0, 1, 0),), pretty="ID Code"),
        F("channel", terms=((2, 1, 0),), add=1, pretty="Channel"),
        F("battery_ok", terms=((3, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((4, 1, 12),), mul=0.1,
          pretty="Temperature", fmt="%.1f C"),
        F("humidity", kind="mapf", terms=((1, 1, 0),),
          map={10: 0, 110: 100}, pretty="Humidity", fmt="%.0f %%"),
        F("button", terms=((5, 1, 0),), pretty="Button"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _aft77_rows(bits):
    # first row with exactly 68 bits (ref src/devices/auriol_aft77b2.c)
    for r in range(bits.num_rows):
        if bits.bits_per_row[r] == 68:
            return [r]
    return DECODE_ABORT_EARLY


def _aft77_lsrc_bits():
    # probe decoders/misc_d.py _aft77_lsrc (reflected Galois LFSR,
    # gen 0x83 key 0xEC) on unit-bit messages; window = frame bits 4..51
    from .misc_d import _aft77_lsrc
    zero = _aft77_lsrc([0] * 6, 6)
    out = []
    for k in range(48):
        msg = [0] * 6
        msg[k >> 3] = 0x80 >> (k & 7)
        out.append((4 + k, _aft77_lsrc(msg, 6) ^ zero))
    return zero, tuple(out)


_AFT77_ZERO, _AFT77_BITS = _aft77_lsrc_bits()

_spec(DeclSpec(
    # Auriol AFT 77 B2 (ref src/devices/auriol_aft77b2.c; misc_d.py
    # auriol_aft77b2): A5 sync, nibble-shifted frame (bits 4..67),
    # byte-sum + probed reflected-LFSR checks, sign-magnitude BCD temp
    symbol="auriol_aft77b2",
    min_bits=68, max_bits=68, exact_lens=(68,), row_mode="any",
    host_guard=_aft77_rows, frame_bits=68, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=6,
                  bit_map=tuple(range(4, 52)), cmp_off=52, cmp_width=8),
            Check("xor_bytes", off=0, nbytes=1, bit_map=(-1,) * 8,
                  xor_bits=_AFT77_BITS, xor_out=_AFT77_ZERO,
                  cmp_off=60, cmp_width=8),),
    raws=(Raw(0, 8),          # 0 sync (== A5)
          Raw(12, 8),         # 1 id (frame[1])
          Raw(28, 1),         # 2 sign (ptr3 & 0x08)
          Raw(32, 4),         # 3 BCD hundreds
          Raw(36, 4),         # 4 BCD tens
          Raw(40, 4)),        # 5 BCD ones
    sanity=(San(0, "eq", 0xA5),),
    variants=(
        Variant(cond=San(2, "eq", 1), fields=(
            F("model", "const", value="Auriol-AFT77B2"),
            F("id", terms=((1, 1, 0),), pretty=""),
            F("temperature_C", kind="float",
              terms=((3, -100, 0), (4, -10, 0), (5, -1, 0)), mul=0.1,
              pretty="Temperature", fmt="%.2f C"),
            F("mic", "const", value="CRC", pretty="Integrity"),
        )),
        Variant(fields=(
            F("model", "const", value="Auriol-AFT77B2"),
            F("id", terms=((1, 1, 0),), pretty=""),
            F("temperature_C", kind="float",
              terms=((3, 100, 0), (4, 10, 0), (5, 1, 0)), mul=0.1,
              pretty="Temperature", fmt="%.2f C"),
            F("mic", "const", value="CRC", pretty="Integrity"),
        )),
    ),
))


# ---------------------------------------------------------------------------
# TPMS / meters / MC + guard-FALLBACK batch (round-5 session 2)
# ---------------------------------------------------------------------------

from .declarative import FALLBACK  # noqa: E402


_spec(DeclSpec(
    # ERT-SCM utility meter (ref src/devices/ert_scm.c; energy.py
    # ert_scm): 96-bit row, CRC-16 poly 0x6F63 over bytes 2..11 == 0
    symbol="ert_scm",
    min_bits=96, max_bits=96, exact_lens=(96,), row_mode="row0",
    frame_bits=96, in_bits=296,
    checks=(Check("crc16", off=16, nbytes=10, p1=0x6F63, p2=0x0000,
                  cmp_const=0),),
    raws=(Raw(0, 32),         # 0 zero guard
          Raw(0, 26,          # 1 ert id: (b2 & 6) << 23 | b7..b9
              bit_order=(21, 22) + tuple(range(56, 80))),
          Raw(24, 2),         # 2 physical tamper
          Raw(26, 4),         # 3 ert type
          Raw(30, 2),         # 4 encoder tamper
          Raw(32, 24)),       # 5 consumption
    sanity=(San(0, "ne", 0),),
    variants=(Variant(fields=(
        F("model", "const", value="ERT-SCM"),
        F("id", terms=((1, 1, 0),), pretty="Id"),
        F("physical_tamper", terms=((2, 1, 0),), pretty="Physical Tamper"),
        F("ert_type", terms=((3, 1, 0),), pretty="ERT Type"),
        F("encoder_tamper", terms=((4, 1, 0),), pretty="Encoder Tamper"),
        F("consumption_data", terms=((5, 1, 0),),
          pretty="Consumption Data"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Schrader TPMS (ref src/devices/schraeder.c:45-100; car_remotes.py
    # schraeder): 68-bit row, frame at bit 4, CRC-8 0x07 init 0xF0
    symbol="schraeder",
    min_bits=68, max_bits=68, exact_lens=(68,), row_mode="row0",
    align_off=4, frame_bits=64, in_bits=296,
    checks=(Check("crc8", off=0, nbytes=7, p1=0x07, p2=0xF0,
                  cmp_off=56, cmp_width=8),),
    raws=(Raw(4, 8),          # 0 flags
          Raw(12, 28),        # 1 serial
          Raw(40, 8),         # 2 pressure raw
          Raw(48, 8)),        # 3 temperature raw
    variants=(Variant(fields=(
        F("model", "const", value="Schrader"),
        F("type", "const", value="TPMS"),
        F("flags", kind="hexs", terms=((0, 1, 0),), val=2),
        F("id", kind="hexsu", terms=((1, 1, 0),), val=7, pretty="ID"),
        F("pressure_kPa", kind="float", terms=((2, 25, 0),), mul=0.1,
          pretty="Pressure", fmt="%.1f kPa"),
        F("temperature_C", kind="float", terms=((3, 1, 0),), add=-50,
          pretty="Temperature", fmt="%.0f C"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # Schrader-EG53MA4 (ref src/devices/schraeder.c:120-170;
    # car_remotes.py schrader_EG53MA4): 120-bit row, frame at bit 40
    symbol="schrader_EG53MA4",
    min_bits=120, max_bits=120, exact_lens=(120,), row_mode="row0",
    align_off=40, frame_bits=80, in_bits=296,
    checks=(Check("add_bytes", off=0, nbytes=9, cmp_off=72, cmp_width=8),),
    raws=(Raw(0, 32),         # 0 flags
          Raw(32, 24),        # 1 serial
          Raw(56, 8),         # 2 pressure raw
          Raw(64, 8),         # 3 temperature raw
          # 4/5: b1|b2|b4 and b5|b7|b8 zero guards
          Raw(0, 24, bit_order=tuple(range(8, 24)) + tuple(range(32, 40))),
          Raw(0, 24, bit_order=tuple(range(40, 48)) + tuple(range(56, 72)))),
    sanity=((San(4, "ne", 0), San(5, "ne", 0)),),
    variants=(Variant(fields=(
        F("model", "const", value="Schrader-EG53MA4"),
        F("type", "const", value="TPMS"),
        F("flags", kind="hexs", terms=((0, 1, 0),), val=8),
        F("id", kind="hexsu", terms=((1, 1, 0),), val=6, pretty="ID"),
        F("pressure_kPa", kind="float", terms=((2, 25, 0),), mul=0.1,
          pretty="Pressure", fmt="%.1f kPa"),
        F("temperature_F", kind="float", terms=((3, 1, 0),),
          pretty="Temperature", fmt="%.1f F"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))


def _max_one_row_guard(bits):
    if bits.num_rows > 1:
        return DECODE_ABORT_EARLY
    return None


_spec(DeclSpec(
    # Honda keyfob KR5V2X/1X (ref src/devices/continental_car_remote.c:
    # 174; car_remotes.py honda_keyfob): ec0f62 sync matched on its
    # first 16 bits' frame (frame at match+16), crc8 poly 0x2F
    symbol="honda_keyfob",
    min_bits=150, max_bits=184, row_mode="row0",
    host_guard=_max_one_row_guard,
    preamble="111011000000111101100010",          # ec0f62
    align_off=-8, need_bits=120, frame_bits=120, in_bits=296,
    checks=(Check("crc8", off=0, nbytes=14, p1=0x2F, p2=0x00,
                  cmp_off=112, cmp_width=8),),
    raws=(Raw(16, 32),        # 0 device id
          Raw(48, 8),         # 1 event byte
          Raw(56, 24),        # 2 counter
          Raw(80, 32)),       # 3 code (signed 32)
    variants=(Variant(fields=(
        F("model", "const", value="Honda-KR5V2X1X", pretty="model"),
        F("id", terms=((0, 1, 0),), pretty="Device ID", fmt="%08x"),
        F("event", kind="enum", terms=((1, 1, 0),), default="?",
          map={0x21: "Lock", 0x22: "Unlock", 0x24: "Trunk",
               0x27: "Emergency", 0x2D: "RemoteStart"}, pretty="Event"),
        F("counter", terms=((2, 1, 0),), pretty="Counter", fmt="%06x"),
        F("code", terms=((3, 1, 32),), pretty="Code", fmt="%08x"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


_spec(DeclSpec(
    # 2GIG-KEY2E-345 keyfob (ref src/devices/twogig_key2e.c; misc
    # twogig_key2e): 555556 sync, Manchester, CRC-16 0x8005 init 0x4C57
    symbol="twogig_key2e",
    min_bits=96, row_mode="row0", host_guard=_single_row_guard,
    preamble="010101010101010101010110",          # 555556
    need_bits=1, transform="manchester", mc_min=72,
    frame_bits=144, in_bits=512,
    checks=(Check("crc16", off=0, nbytes=7, p1=0x8005, p2=0x4C57,
                  cmp_off=56, cmp_width=16),),
    raws=(Raw(0, 32),         # 0 encrypted id
          Raw(32, 8),         # 1 type byte (== 0x25)
          Raw(40, 16)),       # 2 encrypted status
    sanity=(San(1, "eq", 0x25),),
    variants=(Variant(fields=(
        F("model", "const", value="TwoGig-KEY2E345"),
        F("encrypted_id", kind="hexs", terms=((0, 1, 0),), val=8,
          pretty="Encrypted ID"),
        F("encrypted_status", kind="hexs", terms=((2, 1, 0),), val=4,
          pretty="Encrypted Status"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _wh0530_guard(bits):
    # the 63/95-bit Alecto WS-1200 variants keep their Python decode
    # paths (ref src/devices/fineoffset.c:1087-1138)
    if bits.bits_per_row[0] in (63, 95):
        return FALLBACK
    return None


_spec(DeclSpec(
    # Fineoffset WH0530 (ref src/devices/fineoffset.c:1087-1138;
    # fineoffset.py fineoffset_WH0530): 71-bit row, 7-bit 7F + 011
    # sync gates, frame at bit 7 kept in-frame (checks at offset 7)
    symbol="fineoffset_WH0530",
    min_bits=71, max_bits=71, exact_lens=(71,), row_mode="row0",
    host_guard=_wh0530_guard, frame_bits=71, in_bits=296,
    checks=(Check("crc8", off=7, nbytes=7, p1=0x31, p2=0x00,
                  cmp_const=0),
            Check("add_bytes", off=7, nbytes=7, cmp_off=63, cmp_width=8),),
    raws=(Raw(0, 7),          # 0 sync (== 7F)
          Raw(8, 3),          # 1 sync2 (== 011)
          Raw(11, 8),         # 2 id
          Raw(19, 1),         # 3 battery low
          Raw(20, 11),        # 4 temperature raw
          Raw(0, 16,          # 5 rain: (b4 << 8) | b3
              bit_order=tuple(range(39, 47)) + tuple(range(31, 39)))),
    sanity=(San(0, "eq", 0x7F), San(1, "eq", 0x3)),
    variants=(Variant(fields=(
        F("model", "const", value="Fineoffset-WH0530"),
        F("id", terms=((2, 1, 0),), pretty="ID"),
        F("battery_ok", terms=((3, -1, 0),), add=1, pretty="Battery"),
        F("temperature_C", kind="float", terms=((4, 1, 0),), add=-400,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("rain_mm", kind="float", terms=((5, 1, 0),), mul=0.3,
          pretty="Rain", fmt="%.1f mm"),
        F("mic", "const", value="CRC", pretty="Integrity"),
    )),),
))


def _ts_ft002_guard(bits):
    # the 70-bit realignment ORs a constant bit in (Python twin keeps it)
    if bits.bits_per_row[0] == 70:
        return FALLBACK
    return None


_spec(DeclSpec(
    # TS-FT002 tank level (ref src/devices/ts_ft002.c; meters.py
    # ts_ft002): 72-bit frame, a 71-bit row hangs a phantom 0 in front
    # (len_align -1); reversed-byte fields, 9-byte XOR == 0
    symbol="ts_ft002",
    min_bits=71, max_bits=72, exact_lens=(71, 72), row_mode="row0",
    host_guard=_ts_ft002_guard, len_aligns=((71, -1),),
    frame_bits=72, in_bits=296,
    checks=(Check("xor_bytes", off=0, nbytes=9, cmp_const=0),),
    raws=(Raw(0, 8, bit_order=tuple(range(15, 7, -1))),    # 0 id (rev b1)
          Raw(0, 8, bit_order=tuple(range(23, 15, -1))),   # 1 type
          Raw(0, 12,                                       # 2 depth
              bit_order=tuple(range(31, 23, -1)) + (35, 34, 33, 32)),
          Raw(0, 4, bit_order=(39, 38, 37, 36)),           # 3 battery flag
          Raw(0, 4, bit_order=(47, 46, 45, 44)),           # 4 transmit raw
          Raw(0, 12,                                       # 5 temperature
              bit_order=tuple(range(55, 47, -1)) + (43, 42, 41, 40))),
    sanity=(San(1, "eq", 0x11),),
    variants=(Variant(fields=(
        F("model", "const", value="TS-FT002"),
        F("id", terms=((0, 1, 0),), pretty="Id"),
        F("depth_cm", terms=((2, 1, 0),), pretty="Depth"),
        F("temperature_C", kind="float", terms=((5, 1, 0),), add=-400,
          mul=0.1, pretty="Temperature", fmt="%.1f C"),
        F("transmit_s", kind="enum", terms=((4, 1, 0),),
          map={0: 180, 7: 5, 15: 5, 8: 30, 9: 30, 10: 30, 11: 30,
               12: 30, 13: 30, 14: 30, 1: 0, 2: 0, 3: 0, 4: 0,
               5: 0, 6: 0}, pretty="Transmit Interval"),
        F("flags", terms=((3, 1, 0),), pretty="Battery Flag?"),
        F("mic", "const", value="CHECKSUM", pretty="Integrity"),
    )),),
))

"""2-D bit buffer with row/sync structure (host reference implementation).

Behavioral parity with rtl_433's ``bitbuffer_t`` (reference
``include/bitbuffer.h:20-40``, ``src/bitbuffer.c``): 50 rows x 128 bytes,
MSB-first ``add_bit``, row spilling, sync counters, pattern search,
(differential) Manchester decode, NRZS/NRZM decode, ``{n}hex`` parsing.

This host class is the exact-semantics oracle used by the decoder bank and
by tests; fixed-shape array versions (``uint8[rows, 128]`` plus
``bits_per_row``) used on-device mirror this layout 1:1 so tensors can be
round-tripped through :meth:`to_arrays` / :meth:`from_arrays`.
"""

from __future__ import annotations

import numpy as np

BITBUF_COLS = 128  # bytes per row      (ref include/bitbuffer.h:24)
BITBUF_ROWS = 50   # max rows           (ref include/bitbuffer.h:25)
BITBUF_MAX_ROW_BITS = BITBUF_ROWS * BITBUF_COLS * 8


def _bit_at(buf, pos):
    return (buf[pos >> 3] >> (7 - (pos & 7))) & 1


class BitBuffer:
    __slots__ = ("num_rows", "free_row", "bits_per_row", "syncs_before_row", "bb")

    def __init__(self):
        self.clear()

    def clear(self):
        self.num_rows = 0
        self.free_row = 0
        self.bits_per_row = [0] * BITBUF_ROWS
        self.syncs_before_row = [0] * BITBUF_ROWS
        self.bb = np.zeros((BITBUF_ROWS, BITBUF_COLS), dtype=np.uint8)

    # -- construction -------------------------------------------------------

    def add_bit(self, bit: int):
        """MSB-first append with row spilling. Ref src/bitbuffer.c:22-73."""
        if self.num_rows == 0:
            self.free_row = self.num_rows = 1
        bpr = self.bits_per_row[self.num_rows - 1]
        if bpr == 0xFFFF:
            return
        col_index = bpr // 8
        bit_index = bpr % 8
        if bpr > 0 and bpr % (BITBUF_COLS * 8) == 0:
            # spill into next row (same logical row keeps accumulating)
            if self.free_row < BITBUF_ROWS:
                self.free_row += 1
            else:
                return
        row = self.num_rows - 1
        # spilled bits land in continuation rows of bb
        self.bb[row + col_index // BITBUF_COLS, col_index % BITBUF_COLS] |= np.uint8(
            (bit & 1) << (7 - bit_index))
        self.bits_per_row[row] = bpr + 1

    def set_width(self, width: int):
        """Expand/truncate the current row. Ref src/bitbuffer.c:76-103."""
        if self.num_rows == 0:
            self.free_row = self.num_rows = 1
        remaining_rows = BITBUF_ROWS - self.num_rows + 1
        remaining_bits = remaining_rows * BITBUF_COLS * 8
        if width > remaining_bits:
            width = remaining_bits
        row = self.num_rows - 1
        if self.bits_per_row[row] > width:
            flat = self.bb[row:].reshape(-1)
            clr_from = (width + 7) // 8
            clr_end = (self.bits_per_row[row] + 7) // 8
            flat[clr_from:clr_end] = 0
            flat[width // 8] &= np.uint8((0xFF00 >> (width % 8)) & 0xFF)
        self.bits_per_row[row] = width
        extra_rows = 0 if width == 0 else (width - 1) // (BITBUF_COLS * 8)
        self.free_row = self.num_rows + extra_rows

    def add_row(self):
        """Ref src/bitbuffer.c:105-122."""
        if self.num_rows == 0:
            self.free_row = self.num_rows = 1
        if self.free_row < BITBUF_ROWS:
            self.free_row += 1
            self.num_rows = self.free_row
        else:
            self.bits_per_row[self.num_rows - 1] = 0

    def add_sync(self):
        """Ref src/bitbuffer.c:124-133."""
        if self.num_rows == 0:
            self.free_row = self.num_rows = 1
        if self.bits_per_row[self.num_rows - 1]:
            self.add_row()
        self.syncs_before_row[self.num_rows - 1] += 1

    # -- transforms ----------------------------------------------------------

    def invert(self):
        """Invert all active bits. Ref src/bitbuffer.c:135-149."""
        for row in range(self.num_rows):
            n = self.bits_per_row[row]
            if n > 0:
                last_col = (n - 1) // 8
                last_bits = ((n - 1) % 8) + 1
                flat = self.bb[row:].reshape(-1)
                flat[: last_col + 1] = ~flat[: last_col + 1]
                flat[last_col] ^= np.uint8(0xFF >> last_bits)

    def nrzs_decode(self):
        """NRZ-S: 0 = level change. Ref src/bitbuffer.c:151-170."""
        self._nrz_decode(invert=True)

    def nrzm_decode(self):
        """NRZ-M: 1 = level change. Ref src/bitbuffer.c:172-190."""
        self._nrz_decode(invert=False)

    def _nrz_decode(self, invert: bool):
        for row in range(self.num_rows):
            n = self.bits_per_row[row]
            if n > 0:
                last_col = (n - 1) // 8
                last_bits = ((n - 1) % 8) + 1
                flat = self.bb[row:].reshape(-1)
                prev = 0
                for col in range(last_col + 1):
                    b = int(flat[col])
                    mask = ((prev << 7) | (b >> 1)) & 0xFF
                    prev = b
                    flat[col] = np.uint8((b ^ (~mask if invert else mask)) & 0xFF)
                flat[last_col] &= np.uint8((0xFF << (8 - last_bits)) & 0xFF)

    # -- access ---------------------------------------------------------------

    def row_bytes(self, row: int) -> np.ndarray:
        """Active bytes of a row (including spill continuation)."""
        n = self.bits_per_row[row]
        return self.bb[row:].reshape(-1)[: (n + 7) // 8].copy()

    def extract_bytes(self, row: int, pos: int, len_bits: int) -> np.ndarray:
        """Possibly unaligned byte extraction. Ref src/bitbuffer.c:192-223."""
        out = np.zeros((len_bits + 7) // 8, dtype=np.uint8)
        if len_bits == 0:
            return out
        bits = self.bb[row:].reshape(-1)
        if (pos & 7) == 0:
            nb = (len_bits + 7) // 8
            out[:nb] = bits[pos // 8: pos // 8 + nb]
        else:
            shift = 8 - (pos & 7)
            nbytes = (len_bits + 7) >> 3
            p = pos >> 3
            word = int(bits[p])
            for i in range(nbytes):
                p += 1
                word = ((word << 8) | int(bits[p] if p < bits.size else 0)) & 0xFFFFFFFF
                out[i] = (word >> shift) & 0xFF
        if len_bits & 7:
            out[(len_bits - 1) // 8] &= np.uint8((0xFF00 >> (len_bits & 7)) & 0xFF)
        return out

    def search(self, row: int, start: int, pattern, pattern_bits_len: int) -> int:
        """First bit-pattern match at/after ``start``; row length if none.

        Ref src/bitbuffer.c:232-253 (naive restart-by-one search —
        equivalent to first-occurrence substring search). Vectorized over
        unpacked bits; a match must end within the row.
        """
        length = self.bits_per_row[row]
        plen = pattern_bits_len
        if plen <= 0 or start < 0 or start + plen > length:
            return length
        bits = self.bb[row:].reshape(-1)
        ba = np.unpackbits(bits[: (length + 7) // 8])[:length]
        pa = np.unpackbits(np.frombuffer(bytes(bytearray(pattern)),
                                         dtype=np.uint8))[:plen]
        sig = ba[start:]
        if plen <= 64 or sig.size - plen < 4096:
            # windowed byte-compare on the unpacked bits (no float
            # conversion; wins for every realistic row/pattern size)
            win = np.lib.stride_tricks.sliding_window_view(sig, plen)
            hits = np.flatnonzero((win == pa).all(axis=1))
        else:
            # ±1 correlation == plen exactly at a full match (BLAS dot;
            # wins only for very long rows with very long patterns)
            corr = np.correlate(sig.astype(np.float32) * 2.0 - 1.0,
                                pa.astype(np.float32) * 2.0 - 1.0,
                                mode="valid")
            hits = np.flatnonzero(corr >= np.float32(plen))
        return int(start + hits[0]) if hits.size else length

    def manchester_decode(self, row: int, start: int, outbuf: "BitBuffer",
                          max_bits: int) -> int:
        """IEEE 802.3: high-low is 0, low-high is 1. Ref src/bitbuffer.c:255-279.

        Vectorized: consume bit pairs until the first equal pair (the
        trailing half-pair read past ``length`` reads 0-padding, like the
        reference's in-bounds stale bytes).
        """
        bits = self.bb[row:].reshape(-1)
        length = self.bits_per_row[row]
        if max_bits and length > start + max_bits * 2:
            length = start + max_bits * 2
        if start >= length:
            return start
        nbytes = min((length + 8) // 8 + 1, bits.size)
        ba = np.unpackbits(bits[:nbytes])
        b1 = ba[start:length:2]
        # the pair's second bit may sit at index == length (reference reads it)
        b2 = ba[start + 1:length + 1:2][: b1.size]
        if b2.size < b1.size:
            b2 = np.concatenate([b2, np.zeros(b1.size - b2.size, np.uint8)])
        eq = np.flatnonzero(b1 == b2)
        n_out = int(eq[0]) if eq.size else b1.size
        for b in b2[:n_out]:
            outbuf.add_bit(int(b))
        ipos = start + 2 * n_out
        if eq.size:
            ipos += 2  # the terminating equal pair is consumed
        return ipos

    def differential_manchester_decode(self, row: int, start: int,
                                       outbuf: "BitBuffer", max_bits: int) -> int:
        """Ref src/bitbuffer.c:282-329."""
        bits = self.bb[row:].reshape(-1)
        length = self.bits_per_row[row]
        ipos = start
        bit2 = 0
        if max_bits and length > start + max_bits * 2:
            length = start + max_bits * 2
        # sync: first long pulse determines the clock
        while ipos < length:
            bit1 = _bit_at(bits, ipos); ipos += 1
            bit2 = _bit_at(bits, ipos); ipos += 1
            bit3 = _bit_at(bits, ipos) if ipos < bits.size * 8 else 0
            if bit1 != bit2:
                if bit2 != bit3:
                    outbuf.add_bit(0)
                else:
                    bit2 = bit1
                    ipos -= 1
                    break
            else:
                bit2 = 1 - bit1
                ipos -= 2
                break
        while ipos < length:
            bit1 = _bit_at(bits, ipos); ipos += 1
            if bit1 == bit2:
                break  # clock missing
            bit2 = _bit_at(bits, ipos); ipos += 1
            outbuf.add_bit(1 if bit1 == bit2 else 0)
        return ipos

    # -- row comparison --------------------------------------------------------

    def compare_rows(self, row_a: int, row_b: int, max_bits: int = 0) -> bool:
        """Ref src/bitbuffer.c:483-500."""
        na, nb = self.bits_per_row[row_a], self.bits_per_row[row_b]
        a = self.bb[row_a:].reshape(-1)
        b = self.bb[row_b:].reshape(-1)
        if max_bits == 0 or na < max_bits or nb < max_bits:
            return na == nb and bool(
                np.array_equal(a[: (na + 7) // 8], b[: (na + 7) // 8]))
        last = (max_bits - 1) // 8
        mask = (0xFF00 >> (max_bits & 7)) & 0xFF
        return bool(np.array_equal(a[: max_bits // 8], b[: max_bits // 8])) and (
            (int(a[last]) & mask) == (int(b[last]) & mask))

    def count_repeats(self, row: int, max_bits: int = 0) -> int:
        return sum(1 for i in range(self.num_rows)
                   if self.compare_rows(row, i, max_bits))

    def find_repeated_row(self, min_repeats: int, min_bits: int) -> int:
        """Ref src/bitbuffer.c:513-522.

        Vectorized all-pairs comparison for the common no-spill case
        (every decoder candidate row calls this, so the per-pair Python
        loop dominated cold dispatch); rows longer than one bb row spill
        into continuation rows and take the exact per-pair path.
        """
        nr = self.num_rows
        if nr == 0:
            return -1
        bpr = np.asarray(self.bits_per_row[:nr], np.int32)
        if nr > 1 and self.free_row == nr and \
                int(bpr.max()) <= BITBUF_COLS * 8:
            # compare_rows(max_bits=0) semantics: equal bit counts and
            # equal first ceil(bits/8) raw bytes. Bytes past the count are
            # zeroed symmetrically, which matches comparing the prefix.
            nb = (bpr + 7) // 8
            col = np.arange(BITBUF_COLS, dtype=np.int32)
            masked = np.where(col[None, :] < nb[:, None], self.bb[:nr], 0)
            eq = (bpr[:, None] == bpr[None, :]) \
                & (masked[:, None, :] == masked[None, :, :]).all(-1)
            ok = (bpr >= min_bits) & (eq.sum(1) >= min_repeats)
            idx = np.flatnonzero(ok)
            return int(idx[0]) if idx.size else -1
        for i in range(nr):
            if self.bits_per_row[i] >= min_bits and \
                    self.count_repeats(i, 0) >= min_repeats:
                return i
        return -1

    def find_repeated_prefix(self, min_repeats: int, min_bits: int) -> int:
        """Ref src/bitbuffer.c:524-533."""
        for i in range(self.num_rows):
            if self.bits_per_row[i] >= min_bits and \
                    self.count_repeats(i, min_bits) >= min_repeats:
                return i
        return -1

    # -- string I/O -------------------------------------------------------------

    @classmethod
    def parse(cls, code: str) -> "BitBuffer":
        """Parse ``{n}hex`` / ``hex/hex`` test strings. Ref src/bitbuffer.c:405-481."""
        bits = cls()
        width = -1
        i = 0
        n = len(code)
        while i < n:
            c = code[i]
            if c == ' ':
                i += 1
                continue
            if c == '0' and i + 1 < n and code[i + 1] in 'xX':
                i += 2
                continue
            if c == '{':
                if width >= 0:
                    bits.set_width(width)
                if bits.num_rows > 0:
                    bits.add_row()
                j = i + 1
                k = j
                while k < n and (code[k].isdigit() or code[k] in 'xXabcdefABCDEF'):
                    k += 1
                try:
                    width = int(code[j:k], 0)
                except ValueError:
                    width = 0
                while k < n and code[k] in ' \t\r\n':
                    k += 1
                if k < n and code[k] == '}':
                    k += 1
                if width > BITBUF_MAX_ROW_BITS:
                    width = BITBUF_MAX_ROW_BITS
                i = k
                continue
            if c == '/':
                if width >= 0:
                    bits.set_width(width)
                    width = -1
                bits.add_row()
                i += 1
                continue
            if c in '0123456789':
                data = ord(c) - ord('0')
            elif c in 'ABCDEF':
                data = ord(c) - ord('A') + 10
            elif c in 'abcdef':
                data = ord(c) - ord('a') + 10
            else:
                data = 0  # same as C: stale 'data' would be used; treat as 0 for safety
                i += 1
                continue
            bits.add_bit((data >> 3) & 1)
            bits.add_bit((data >> 2) & 1)
            bits.add_bit((data >> 1) & 1)
            bits.add_bit(data & 1)
            i += 1
        if width >= 0:
            bits.set_width(width)
        return bits

    def row_hex(self, row: int) -> str:
        return "".join(f"{b:02x}" for b in self.row_bytes(row))

    def row_code(self, row: int) -> str:
        """'{n}hh..' row code, trailing half-byte trimmed to one nibble;
        at least one '0' digit (ref src/decoder_util.c bitrow_asprint_code)."""
        n = self.bits_per_row[row]
        hexstr = self.row_hex(row)[: 2 * (n + 3) // 8]
        return f"{{{n}}}{hexstr or '0'}"

    def row_bits_str(self, row: int) -> str:
        """Bit string with a space every nibble (ref src/decoder_util.c
        bitrow_asprint_bits) — the -M bits row dump format."""
        n = self.bits_per_row[row]
        raw = "".join(f"{b:08b}" for b in self.row_bytes(row))[:n]
        return " ".join(raw[i:i + 4] for i in range(0, len(raw), 4))

    def __repr__(self):
        rows = ", ".join(
            f"{{{self.bits_per_row[r]}}}{self.row_hex(r)}" for r in range(self.num_rows))
        return f"BitBuffer[{self.num_rows} rows: {rows}]"

    def clone(self) -> "BitBuffer":
        """Independent copy (decoders may mutate their input, e.g. invert)."""
        out = BitBuffer.__new__(BitBuffer)
        out.num_rows = self.num_rows
        out.free_row = self.free_row
        out.bits_per_row = list(self.bits_per_row)
        out.syncs_before_row = list(self.syncs_before_row)
        out.bb = self.bb.copy()
        return out

    # -- tensor round-trip ---------------------------------------------------

    def to_arrays(self):
        """(bb uint8[ROWS, COLS], bits_per_row int32[ROWS], num_rows) view."""
        return self.bb.copy(), np.array(self.bits_per_row, np.int32), self.num_rows

    @classmethod
    def from_arrays(cls, bb: np.ndarray, bits_per_row, num_rows: int,
                    syncs=None) -> "BitBuffer":
        out = cls()
        out.bb[: bb.shape[0], : bb.shape[1]] = bb
        for i, v in enumerate(np.asarray(bits_per_row).tolist()):
            out.bits_per_row[i] = int(v)
        if syncs is not None:
            for i, v in enumerate(np.asarray(syncs).tolist()):
                out.syncs_before_row[i] = int(v)
        out.num_rows = int(num_rows)
        out.free_row = out.num_rows
        return out

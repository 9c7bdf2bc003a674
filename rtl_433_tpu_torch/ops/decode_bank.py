"""Batched declarative decode kernel: the device-side decoder bank.

SURVEY §2 row 12's TPU-equivalent mandate — "each protocol a
jit-compatible pure function over bitbuffer arrays" — without one kernel
per protocol: every *declarative* decoder (decoders/declarative.py) lowers
to PER-SPEC WEIGHT TABLES over frame-bit positions, and one shared tensor
program evaluates any mix of (bitbuffer row, protocol) candidates:

  - Every checksum/MIC in the reference's bit_util.c family is AFFINE:
    CRC-8/16 (MSB/LSB-first), all Galois LFSR digests, xor/parity are
    GF(2)-linear in the message bits; add_bytes/add_nibbles are
    integer-linear. A check therefore lowers to one per-spec table
    ``T[frame_bit] -> contribution`` (expected-value bytes fold in as
    extra contributions, byte reflections and window offsets permute the
    table, masks pre-mask it) and the kernel evaluates ALL checks of ALL
    candidates as two masked reductions — one XOR-reduce, one
    dot-product — regardless of algorithm. (ref src/bit_util.c:240-576)
  - Field extraction is integer-linear too: ``raw = sum(bit_j * 2^k)``
    with arbitrary bit permutations (reverse8, nibble swaps) folded into
    the weight table.
  - Preamble search, length gates, invert and Manchester transforms are
    shape-static vectorized passes. (ref src/bitbuffer.c:232-279)

The tables come from the *host* scalar library (bits/util.py digests of
unit-bit messages), so kernel semantics are inherited, not re-derived.

One engine over an array namespace: ``run(xp=...)`` selects it. The
per-train host dispatch runs it on NumPy (a single batched call replaces
dozens of Python decode calls); a torch backend on the card for
drain-scale batches is not ported yet. tests/test_torch_fast_dispatch.py
holds this copy to the JAX package's NumPy backend.

Stage codes (ref include/r_device.h:45-53): candidates fail with the
DECODE_* code of the first failing stage so the per-decoder fail counters
stay meaningful (length -> ABORT_LENGTH, preamble -> ABORT_EARLY,
MIC -> FAIL_MIC, sanity -> FAIL_SANITY).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..bits import util as bu

DECODE_FAIL_OTHER = 0
DECODE_ABORT_LENGTH = -1
DECODE_ABORT_EARLY = -2
DECODE_FAIL_MIC = -3
DECODE_FAIL_SANITY = -4

# check kinds
CK_OFF = 0
CK_GF2 = 1
CK_ADD = 2

# transforms
TF_NONE = 0
TF_INVERT = 1
TF_MANCHESTER = 2   # IEEE 802.3 second-of-pair (bitbuffer.manchester_decode)

_GF2_ALGOS = {
    "crc4": (4, lambda m, n, p1, p2: bu.crc4(m, n, p1, p2)),
    "crc7": (7, lambda m, n, p1, p2: bu.crc7(m, n, p1, p2)),
    "crc8": (8, lambda m, n, p1, p2: bu.crc8(m, n, p1, p2)),
    "crc8le": (8, lambda m, n, p1, p2: bu.crc8le(m, n, p1, p2)),
    "crc16": (16, lambda m, n, p1, p2: bu.crc16(m, n, p1, p2)),
    "crc16lsb": (16, lambda m, n, p1, p2: bu.crc16lsb(m, n, p1, p2)),
    "lfsr_digest8": (8, lambda m, n, p1, p2: bu.lfsr_digest8(m, n, p1, p2)),
    "lfsr_digest8_reverse": (
        8, lambda m, n, p1, p2: bu.lfsr_digest8_reverse(m, n, p1, p2)),
    "lfsr_digest8_reflect": (
        8, lambda m, n, p1, p2: bu.lfsr_digest8_reflect(m, n, p1, p2)),
    "lfsr_digest16": (
        16, lambda m, n, p1, p2: bu.lfsr_digest16(m, n, p1, p2)),
    "xor_bytes": (8, lambda m, n, p1, p2: bu.xor_bytes(m, n)),
    "parity_bytes": (1, lambda m, n, p1, p2: bu.parity_bytes(m, n)),
}
_ADD_ALGOS = {"add_bytes", "add_nibbles"}


def _digest_table(algo: str, nbytes: int, p1: int, p2: int,
                  reflect: bool) -> Tuple[np.ndarray, int, int]:
    """GF(2) lowering: per-window-bit contribution table + zero-message
    digest + algorithm width mask. Computed by running the HOST digest on
    unit-bit messages, so any quirk of the scalar implementation carries
    over exactly."""
    width, fn = _GF2_ALGOS[algo]
    wmask = (1 << width) - 1
    zero = int(fn(bytes(nbytes), nbytes, p1, p2)) & wmask
    tab = np.zeros(nbytes * 8, np.uint32)
    msg = bytearray(nbytes)
    for k in range(nbytes * 8):
        msg[k >> 3] = 0x80 >> (k & 7)
        tab[k] = (int(fn(bytes(msg), nbytes, p1, p2)) ^ zero) & wmask
        msg[k >> 3] = 0
    if reflect:  # window byte view is reverse8'd before the digest
        tab = tab.reshape(nbytes, 8)[:, ::-1].reshape(-1)
    return tab, zero, wmask


def _add_weights(algo: str, nbytes: int, reflect: bool) -> np.ndarray:
    """Integer lowering of the additive checks: per-window-bit weight."""
    k = np.arange(nbytes * 8)
    if algo == "add_bytes":
        w = 1 << (7 - (k & 7))
    elif algo == "add_nibbles":
        w = 1 << (3 - (k & 3))
    else:
        raise ValueError(algo)
    w = w.astype(np.int64)
    if reflect:
        w = w.reshape(nbytes, 8)[:, ::-1].reshape(-1)
    return w


class CompiledBank:
    """Per-spec weight tables for a list of lowered declarative specs.

    Produced by decoders.declarative.compile_bank(); consumed by run().
    All arrays are NumPy; run() promotes to the requested backend.
    """

    def __init__(self, specs: Sequence["LoweredSpec"]):
        S = len(specs)
        self.n_specs = S
        self.in_bits = max((sp.in_bits for sp in specs), default=64)
        self.frame_bits = max((sp.frame_bits for sp in specs), default=8)
        self.pat_len = max((sp.pat_len for sp in specs), default=0)
        self.n_checks = max((len(sp.gf2_tabs) + len(sp.add_tabs)
                             for sp in specs), default=0)
        self.n_raws = max((sp.raw_tabs.shape[0] for sp in specs), default=0)
        FB, C, R = self.frame_bits, self.n_checks, self.n_raws
        PL = max(self.pat_len, 1)

        self.min_bits = np.zeros(S, np.int32)
        self.max_bits = np.zeros(S, np.int32)
        # exact-length whitelist (0 slots unused); when any slot is set,
        # the min/max gate additionally requires n in the listed lengths
        self.exact_lens = np.zeros((S, 4), np.int32)
        # per-length frame alignment: (row_len, extra_offset) pairs
        self.la_len = np.zeros((S, 2), np.int32)
        self.la_off = np.zeros((S, 2), np.int32)
        self.plen = np.zeros(S, np.int32)
        self.pat = np.zeros((S, PL), np.uint8)
        self.pmask = np.zeros((S, PL), np.uint8)   # 0 = don't care
        self.pre_start = np.zeros(S, np.int32)
        self.align_off = np.zeros(S, np.int32)
        self.need_bits = np.zeros(S, np.int32)
        self.transform = np.zeros(S, np.int32)
        self.mc_min = np.zeros(S, np.int32)
        self.ck_kind = np.zeros((S, C), np.int32)
        self.ck_neq = np.zeros((S, C), bool)
        self.ck_gf2 = np.zeros((S, C, FB), np.uint32)
        self.ck_tc = np.zeros((S, C), np.uint32)
        self.ck_add = np.zeros((S, C, FB), np.int32)
        self.ck_mod = np.ones((S, C), np.int64)
        self.ck_tca = np.zeros((S, C), np.int64)
        self.raw_w = np.zeros((S, R, FB), np.uint32)

        for i, sp in enumerate(specs):
            self.min_bits[i] = sp.min_bits
            self.max_bits[i] = sp.max_bits
            for k, ln in enumerate(sp.exact_lens[:4]):
                self.exact_lens[i, k] = ln
            for k, (ln, off) in enumerate(sp.len_aligns[:2]):
                self.la_len[i, k] = ln
                self.la_off[i, k] = off
            self.plen[i] = sp.pat_len
            if sp.pat_len:
                self.pat[i, :sp.pat_len] = sp.pat_bits
                self.pmask[i, :sp.pat_len] = sp.pat_mask
            self.pre_start[i] = sp.pre_start
            self.align_off[i] = sp.align_off
            self.need_bits[i] = sp.need_bits
            self.transform[i] = sp.transform
            self.mc_min[i] = sp.mc_min
            c = 0
            for tab, tc, neq in sp.gf2_tabs:
                self.ck_kind[i, c] = CK_GF2
                self.ck_neq[i, c] = neq
                self.ck_gf2[i, c, :tab.shape[0]] = tab
                self.ck_tc[i, c] = tc
                c += 1
            for w, mod, tc, neq in sp.add_tabs:
                self.ck_kind[i, c] = CK_ADD
                self.ck_neq[i, c] = neq
                self.ck_add[i, c, :w.shape[0]] = w
                self.ck_mod[i, c] = mod
                self.ck_tca[i, c] = tc
                c += 1
            r = sp.raw_tabs.shape[0]
            if r:
                self.raw_w[i, :r, :sp.raw_tabs.shape[1]] = sp.raw_tabs


class LoweredSpec:
    """One declarative decoder lowered to table form (see CompiledBank)."""

    def __init__(self, *, min_bits: int, max_bits: int, in_bits: int,
                 frame_bits: int, pat_bits=(), pat_mask=(), pre_start=0,
                 align_off=0, need_bits=0, transform=TF_NONE, mc_min=0,
                 gf2_tabs=(), add_tabs=(), raw_tabs=None, exact_lens=(),
                 len_aligns=()):
        self.min_bits = min_bits
        self.max_bits = max_bits
        self.exact_lens = tuple(exact_lens)
        self.len_aligns = tuple(len_aligns)
        self.in_bits = in_bits
        self.frame_bits = frame_bits
        self.pat_bits = np.asarray(pat_bits, np.uint8)
        self.pat_mask = np.asarray(
            pat_mask if len(pat_mask) else [1] * len(pat_bits), np.uint8)
        self.pat_len = len(pat_bits)
        self.pre_start = pre_start
        self.align_off = align_off
        self.need_bits = need_bits
        self.transform = transform
        self.mc_min = mc_min
        self.gf2_tabs = list(gf2_tabs)    # (tab[u32], target, negated)
        self.add_tabs = list(add_tabs)    # (weights[i64], mod, target, neg)
        self.raw_tabs = (np.zeros((0, frame_bits), np.uint32)
                         if raw_tabs is None
                         else np.asarray(raw_tabs, np.uint32))


def make_gf2_check(algo: str, off: int, nbytes: int, p1: int = 0,
                   p2: int = 0, xor_out: int = 0, mask: Optional[int] = None,
                   cmp_off: int = -1, cmp_width: int = 0, cmp_const: int = 0,
                   reflect: bool = False, negated: bool = False,
                   frame_bits: int = 0, xor_bits: Sequence = (),
                   bit_map: Optional[Sequence[int]] = None):
    """Lower one GF(2) digest check to (table, target, negated).

    Passes iff ``((digest ^ xor_out) & mask) == expected`` where the
    expected value is the ``cmp_width``-bit big-endian field at frame bit
    ``cmp_off`` (or ``cmp_const`` when cmp_off < 0). ``negated`` flips it.
    ``xor_bits`` are extra (frame_bit, weight) GF(2) contributions XORed
    into the comparison — any linear function of the frame folds in.
    """
    tab8, zero, wmask = _digest_table(algo, nbytes, p1, p2, reflect)
    m = wmask if mask is None else (mask & 0xFFFFFFFF)
    fb = max([frame_bits, off + nbytes * 8,
              (cmp_off + cmp_width) if cmp_off >= 0 else 0]
             + [b + 1 for b, _w in xor_bits]
             + [b + 1 for b in (bit_map or ()) if b >= 0])
    tab = np.zeros(fb, np.uint32)
    if bit_map is not None:
        # scrambled window: window bit k reads frame bit bit_map[k]
        # (-1 = constant 0) — applied BEFORE the expected-value folds
        assert len(bit_map) == nbytes * 8
        for k, dst in enumerate(bit_map):
            if dst >= 0:
                tab[dst] ^= tab8[k] & m
    else:
        tab[off:off + nbytes * 8] = tab8 & m
    target = (zero ^ xor_out) & m
    if cmp_off >= 0:
        # expected-value bits fold into the same table (X ^ E == 0 form)
        for j in range(cmp_width):
            tab[cmp_off + j] ^= ((1 << (cmp_width - 1 - j)) & m)
    else:
        target ^= cmp_const & m
    for bit, w in xor_bits:
        tab[bit] ^= w & m
    return tab, target, negated


def make_add_check(algo: str, off: int, nbytes: int,
                   mask: Optional[int] = None, cmp_off: int = -1,
                   cmp_width: int = 0, cmp_const: int = 0,
                   reflect: bool = False, negated: bool = False,
                   frame_bits: int = 0, add_const: int = 0,
                   bit_map: Optional[Sequence[int]] = None,
                   sub_bits: Sequence = ()):
    """Lower one additive check: passes iff
    ``(sum + add_const) mod (mask+1) == expected``. mask must be 2^k-1.
    ``sub_bits`` are extra (frame_bit, weight) contributions SUBTRACTED
    from the sum — expected values at descending/scrambled bit positions
    fold in this way."""
    m = 0xFF if mask is None else mask
    mod = m + 1
    assert mod & (mod - 1) == 0, "additive masks must be 2^k - 1"
    w8 = _add_weights(algo, nbytes, reflect)
    fb = max([frame_bits, off + nbytes * 8,
              (cmp_off + cmp_width) if cmp_off >= 0 else 0]
             + [b + 1 for b in (bit_map or ()) if b >= 0]
             + [b + 1 for b, _w in sub_bits])
    w = np.zeros(fb, np.int64)
    if bit_map is not None:
        assert len(bit_map) == nbytes * 8
        for k, dst in enumerate(bit_map):
            if dst >= 0:
                w[dst] += w8[k]
    else:
        w[off:off + nbytes * 8] = w8
    if cmp_off >= 0:
        # expected folds in as negative weights: sum - exp == -add_const
        for j in range(cmp_width):
            w[cmp_off + j] -= 1 << (cmp_width - 1 - j)
        target = (-add_const) % mod
    else:
        target = (cmp_const - add_const) % mod
    for b, wgt in sub_bits:
        w[b] -= wgt
    return w.astype(np.int32), mod, target, negated


def make_raw(off: int, width: int, frame_bits: int,
             bit_order: Optional[Sequence[int]] = None,
             rev_bytes: bool = False) -> np.ndarray:
    """Weight row extracting an unsigned big-endian field (width <= 32).

    ``bit_order`` gives explicit frame-bit indices MSB-first for scrambled
    layouts; ``rev_bytes`` reflects bit order within each byte."""
    assert width <= 32
    w = np.zeros(frame_bits, np.uint32)
    if bit_order is not None:
        assert len(bit_order) == width
        for j, src in enumerate(bit_order):
            if src >= 0:     # -1 = constant-0 bit position
                w[src] |= np.uint32(1 << (width - 1 - j))
        return w
    for j in range(width):
        src = off + j
        if rev_bytes:
            byte, bit = divmod(j, 8)
            src = off + byte * 8 + (7 - bit)
        w[src] |= np.uint32(1 << (width - 1 - j))
    return w


def run(bank: CompiledBank, bits, n_bits, sid, xp=np, n_store=None):
    """Evaluate a candidate batch against the bank.

    bits: [B, IN] uint8 0/1 — the row's STORED bits (bitbuffer storage,
    possibly longer than n_bits; the reference's extract/CRC helpers read
    stale stored bits past bits_per_row, so extraction must too)
    n_bits: [B] int32 row lengths (bounds the length gate + search)
    n_store: [B] int32 stored-bit counts (bounds extraction; defaults to
    n_bits for callers whose rows are canonically zero-padded)
    sid: [B] int32 spec index
    Returns (code [B] int32: 0 decodes, DECODE_* otherwise,
             raws [B, R] uint32 extracted fields).
    All ops are shape-static and xp-polymorphic.
    """
    B, IN = bits.shape
    FB = bank.frame_bits
    i32 = lambda a: xp.asarray(a, dtype=xp.int32)
    bits = xp.asarray(bits, dtype=xp.uint8)
    n = i32(n_bits)
    ns = n if n_store is None else i32(n_store)
    sid = i32(sid)

    min_b = i32(bank.min_bits)[sid]
    max_b = i32(bank.max_bits)[sid]
    ok_len = (n >= min_b) & (n <= max_b)
    el = i32(bank.exact_lens)[sid]                       # [B, 4]
    has_el = xp.any(el > 0, axis=1)
    ok_len = ok_len & (~has_el | xp.any(el == n[:, None], axis=1))

    # ---- preamble search (first match wins, ref bitbuffer.c:232-253):
    # the candidate window at offset t is compared via PL shifted slices,
    # no gathers. On the NumPy backend tiny per-train batches skip the
    # stage entirely when no candidate has a pattern (host fast path; the
    # jit backend keeps the static structure).
    plen = i32(bank.plen)[sid]                   # [B]
    pre_start = i32(bank.pre_start)[sid]
    if bank.pat_len and (xp is not np or bool(np.any(np.asarray(plen) > 0))):
        PL = bank.pat_len
        T = IN
        pat = xp.asarray(bank.pat)[sid]          # [B, PL]
        pmask = xp.asarray(bank.pmask)[sid]
        t = xp.arange(T, dtype=xp.int32)[None, :]         # [1, T]
        padded = xp.concatenate(
            [bits, xp.zeros((B, PL), dtype=bits.dtype)], axis=1)
        m = xp.ones((B, T), dtype=bool)
        for k in range(PL):
            bk = padded[:, k:k + T]
            care = (pmask[:, k:k + 1] != 0) & (k < plen)[:, None]
            m = m & (~care | (bk == pat[:, k:k + 1]))
        m = m & (t >= pre_start[:, None]) & (t + plen[:, None] <= n[:, None])
        found = xp.any(m, axis=1)
        pos = xp.argmax(m, axis=1).astype(xp.int32)
    else:
        found = xp.zeros((B,), dtype=bool)
        pos = xp.zeros((B,), dtype=xp.int32)
    has_pat = plen > 0
    ok_pre = ~has_pat | found
    frame_off = xp.where(has_pat, pos + plen, 0) + i32(bank.align_off)[sid]
    la_len = i32(bank.la_len)[sid]                       # [B, 2]
    la_off = i32(bank.la_off)[sid]
    frame_off = frame_off + xp.sum(
        xp.where((la_len > 0) & (la_len == n[:, None]), la_off, 0), axis=1)

    need = i32(bank.need_bits)[sid]
    ok_need = frame_off + need <= n

    # ---- frame extraction (stale stored bits past the row length are
    # READ, like the reference's extract_bytes; zero past the storage
    # and before bit 0 — negative len_aligns hang phantom-0 bits in
    # front, e.g. ts_ft002's 71-bit realignment)
    j = xp.arange(FB, dtype=xp.int32)[None, :]
    src = frame_off[:, None] + j                             # [B, FB]
    inb = (src >= 0) & (src < ns[:, None])
    fb = xp.take_along_axis(bits, xp.clip(src, 0, IN - 1), axis=1)
    fb = xp.where(inb, fb, 0).astype(xp.uint8)

    # ---- transforms
    tf = i32(bank.transform)[sid]
    if xp is not np or bool(np.any(np.asarray(tf) == TF_INVERT)):
        # bitbuffer_invert flips only bits < bits_per_row; padding and
        # stale stored bits keep their value (ref src/bitbuffer.c:135-149)
        fb = xp.where((tf == TF_INVERT)[:, None] & (src < n[:, None]),
                      fb ^ 1, fb)
    ok_tf = xp.ones((B,), dtype=bool)
    if int(np.any(np.asarray(bank.transform) == TF_MANCHESTER)) and (
            xp is not np or bool(np.any(np.asarray(tf) == TF_MANCHESTER))):
        H = FB // 2
        b1 = fb[:, 0:2 * H:2]
        b2 = fb[:, 1:2 * H:2]
        # pair exists while its first bit is inside the row
        avail = (src[:, 0:2 * H:2] < n[:, None])
        stop = (b1 == b2) | ~avail
        n_out = xp.argmax(stop, axis=1).astype(xp.int32)
        n_out = xp.where(xp.any(stop, axis=1), n_out, H)
        mc = xp.where(xp.arange(H)[None, :] < n_out[:, None], b2, 0)
        mc = xp.concatenate(
            [mc, xp.zeros((B, FB - H), dtype=fb.dtype)], axis=1)
        is_mc = (tf == TF_MANCHESTER)
        fb = xp.where(is_mc[:, None], mc.astype(fb.dtype), fb)
        ok_tf = ~is_mc | (n_out >= i32(bank.mc_min)[sid])

    # ---- checks: one XOR-reduce + one dot per check slot
    ok_mic = xp.ones((B,), dtype=bool)
    if bank.n_checks:
        fbit = fb != 0                                       # [B, FB]
        kind = i32(bank.ck_kind)[sid]                        # [B, C]
        kind_np = np.asarray(kind) if xp is np else None
        for c in range(bank.n_checks):
            if kind_np is not None and not np.any(kind_np[:, c]):
                continue  # slot unused by every candidate (host batches)
            need_gf2 = kind_np is None or bool(
                np.any(kind_np[:, c] == CK_GF2))
            need_add = kind_np is None or bool(
                np.any(kind_np[:, c] == CK_ADD))
            if need_gf2:
                tabs = xp.asarray(bank.ck_gf2[:, c, :],
                                  dtype=xp.uint32)[sid]      # [B, FB]
                x = xp.where(fbit, tabs, xp.uint32(0))
                gf2 = xp.bitwise_xor.reduce(x, axis=1)
                gf2_ok = gf2 == xp.asarray(bank.ck_tc[:, c],
                                           dtype=xp.uint32)[sid]
            else:
                gf2_ok = xp.zeros((B,), dtype=bool)
            if need_add:
                w = xp.asarray(bank.ck_add[:, c, :], dtype=xp.int32)[sid]
                s = xp.sum(xp.where(fbit, w, 0), axis=1, dtype=xp.int32)
                mod = i32(bank.ck_mod[:, c])[sid]
                tca = i32(bank.ck_tca[:, c])[sid]
                add_ok = (s % mod + mod) % mod == tca
            else:
                add_ok = xp.zeros((B,), dtype=bool)
            ck = xp.where(kind[:, c] == CK_GF2, gf2_ok, add_ok)
            ck = ck ^ xp.asarray(bank.ck_neq[:, c])[sid]
            ok_mic = ok_mic & ((kind[:, c] == CK_OFF) | ck)

    # ---- raw field extraction
    if bank.n_raws:
        fb32 = fb.astype(xp.uint32)
        rw = xp.asarray(bank.raw_w)[sid]                     # [B, R, FB]
        raws = xp.sum(fb32[:, None, :] * rw, axis=2, dtype=xp.uint32)
    else:
        raws = xp.zeros((B, 1), dtype=xp.uint32)

    code = xp.full((B,), DECODE_ABORT_LENGTH, xp.int32)
    code = xp.where(ok_len, DECODE_ABORT_EARLY, code)
    code = xp.where(ok_len & ok_pre & ok_need & ok_tf,
                    DECODE_FAIL_MIC, code)
    code = xp.where(ok_len & ok_pre & ok_need & ok_tf & ok_mic,
                    0, code)
    return code, raws

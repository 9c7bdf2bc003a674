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

Two backends, bit-identical. ``run`` is the JAX package's function on
NumPy, for the per-train host dispatch (a single batched call replaces
dozens of Python decode calls; tests/test_torch_fast_dispatch.py holds it
to the JAX package's). ``run_torch`` is the JAX ``xp=jnp`` path, for
drain-scale batches on a device: on a CUDA tensor it launches
``csrc/decl_bank.cu`` (one warp per candidate over sparse per-spec entry
lists, :func:`sparse_tables`), on a CPU tensor it runs its plain version,
:func:`run_torch_plain`; :func:`run_torch_sparse_plain` emulates the
kernel's sparse evaluation in plain torch (tests/test_torch_decode_bank.py
holds both to JAX's ``run(xp=jnp)``). All read the bank's tables as
tensors on their device (:func:`bank_tables`, built once per bank and
device).

Stage codes (ref include/r_device.h:45-53): candidates fail with the
DECODE_* code of the first failing stage so the per-decoder fail counters
stay meaningful (length -> ABORT_LENGTH, preamble -> ABORT_EARLY,
MIC -> FAIL_MIC, sanity -> FAIL_SANITY).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import weakref

import numpy as np
import torch

from . import _cuda
from .mic import xor_reduce
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


# ---- the torch backend (the JAX ``xp=jnp`` path)

# the spec row of csrc/decl_bank.cu: the scalars, then CK_FIELDS per check
# slot (kind, negated, GF(2) target, modulus, additive target), then the
# pattern and its care mask as 32-bit words, MSB first
SP_MIN, SP_MAX, SP_EL, SP_LA_LEN, SP_LA_OFF, SP_PLEN = 0, 1, 2, 6, 8, 10
SP_PRE_START, SP_ALIGN, SP_NEED, SP_TF, SP_MC_MIN, SP_NRAW = range(11, 17)
SP_CHECKS = 17
CK_FIELDS = 5

_TABLES = weakref.WeakKeyDictionary()   # bank -> {device: tables}


def _i32(a) -> np.ndarray:
    """Integers as int32 storage of their low 32 bits."""
    a = np.asarray(a, np.int64)
    return ((a + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def _u32(t):
    """int32 storage of uint32 values as int64 values."""
    return t.to(torch.int64) & 0xFFFFFFFF


def spec_rows(bank: CompiledBank) -> np.ndarray:
    """The bank's per-spec scalars as int32 rows ``[S, K]`` (the layout of
    SP_* and CK_FIELDS)."""
    S, C = bank.n_specs, bank.n_checks
    PW = (bank.pat_len + 31) // 32
    assert bank.exact_lens.shape[1] == 4 and bank.la_len.shape[1] == 2
    sp = np.zeros((S, SP_CHECKS + CK_FIELDS * C + 2 * PW), np.int64)
    sp[:, SP_MIN] = bank.min_bits
    sp[:, SP_MAX] = bank.max_bits
    sp[:, SP_EL:SP_EL + 4] = bank.exact_lens
    sp[:, SP_LA_LEN:SP_LA_LEN + 2] = bank.la_len
    sp[:, SP_LA_OFF:SP_LA_OFF + 2] = bank.la_off
    sp[:, SP_PLEN] = bank.plen
    sp[:, SP_PRE_START] = bank.pre_start
    sp[:, SP_ALIGN] = bank.align_off
    sp[:, SP_NEED] = bank.need_bits
    sp[:, SP_TF] = bank.transform
    sp[:, SP_MC_MIN] = bank.mc_min
    # raw rows past the spec's last non-zero one sum to 0: skipped
    nz = bank.raw_w.any(axis=2)
    sp[:, SP_NRAW] = np.where(nz.any(axis=1),
                              nz.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
    for c in range(C):
        o = SP_CHECKS + CK_FIELDS * c
        sp[:, o] = bank.ck_kind[:, c]
        sp[:, o + 1] = bank.ck_neq[:, c]
        sp[:, o + 2] = bank.ck_tc[:, c]
        sp[:, o + 3] = _i32(bank.ck_mod[:, c])
        sp[:, o + 4] = _i32(bank.ck_tca[:, c])
    o = SP_CHECKS + CK_FIELDS * C
    j = np.arange(PW * 32)
    care = np.zeros((S, PW * 32), np.int64)
    pat = np.zeros((S, PW * 32), np.int64)
    PL = bank.pat.shape[1] if bank.pat_len else 0
    care[:, :PL] = (bank.pmask[:, :PL] != 0) & (j[None, :PL]
                                                < bank.plen[:, None])
    pat[:, :PL] = bank.pat[:, :PL] & care[:, :PL]
    weight = 1 << (31 - (j % 32))
    for k in range(PW):
        w = slice(32 * k, 32 * k + 32)
        sp[:, o + k] = (pat[:, w] * weight[w]).sum(1)
        sp[:, o + PW + k] = (care[:, w] * weight[w]).sum(1)
    return _i32(sp)


# the sparse entry tables of csrc/decl_bank.cu: chunks of CHUNK (frame
# bit, weight) entries, each chunk of one kind and one target (a check
# slot, or a field row)
CHUNK = 32
CH_GF2, CH_ADD, CH_RAW = 0, 1, 2


def sparse_tables(bank: CompiledBank):
    """The bank's weights as sparse per-spec entry lists: for each spec,
    each live check slot (its GF(2) or additive weights, by its kind) and
    each field row below its ``SP_NRAW``, the non-zero (frame bit, weight)
    pairs, padded with (0, 0) to whole chunks of ``CHUNK``. XOR and
    wrapping sums do not depend on order, so dropping the zeros is exact.
    Returns int32 arrays: ``entries`` [NC * CHUNK, 2] (frame bit, weight
    as int32 storage), ``chunk_dir`` [NC] (kind | target << 8, kinds
    ``CH_*``) and ``chunk_start`` [S + 1] (spec s owns chunks
    ``chunk_start[s]:chunk_start[s + 1]``)."""
    nraw = spec_rows(bank)[:, SP_NRAW]
    entries, chunk_dir, chunk_start = [], [], [0]
    for s in range(bank.n_specs):
        lists = [(CH_GF2, c, bank.ck_gf2[s, c]) if bank.ck_kind[s, c]
                 == CK_GF2 else (CH_ADD, c, bank.ck_add[s, c])
                 for c in range(bank.n_checks)
                 if bank.ck_kind[s, c] != CK_OFF]
        lists += [(CH_RAW, r, bank.raw_w[s, r]) for r in range(nraw[s])]
        for kind, target, w in lists:
            j = np.flatnonzero(w)
            k = -(-j.size // CHUNK)
            e = np.zeros((k * CHUNK, 2), np.int64)
            e[:j.size, 0] = j
            e[:j.size, 1] = w[j]
            entries.append(e)
            chunk_dir += [kind | target << 8] * k
        chunk_start.append(len(chunk_dir))
    entries = np.concatenate(entries) if entries else np.zeros((0, 2))
    return (_i32(entries), np.asarray(chunk_dir, np.int32),
            np.asarray(chunk_start, np.int32))


def bank_tables(bank: CompiledBank, device) -> dict:
    """The bank's tables as tensors on ``device``, built once per bank and
    device: the arrays of :class:`CompiledBank` under their names (uint32
    ones as int32 storage, ``ck_mod`` and ``ck_tca`` as the int32 the JAX
    path casts them to), ``spec``, the kernel's spec rows, and the sparse
    entry tables of :func:`sparse_tables` (``entries``, ``chunk_dir``,
    ``chunk_start``)."""
    device = torch.device(device)
    per = _TABLES.setdefault(bank, {})
    tabs = per.get(device)
    if tabs is None:
        arrays = {k: getattr(bank, k) for k in (
            "min_bits", "max_bits", "exact_lens", "la_len", "la_off", "plen",
            "pat", "pmask", "pre_start", "align_off", "need_bits",
            "transform", "mc_min", "ck_kind", "ck_neq", "ck_add")}
        for k in ("ck_gf2", "ck_tc", "ck_mod", "ck_tca", "raw_w"):
            arrays[k] = _i32(getattr(bank, k))
        arrays["spec"] = spec_rows(bank)
        (arrays["entries"], arrays["chunk_dir"],
         arrays["chunk_start"]) = sparse_tables(bank)
        tabs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}
        per[device] = tabs
    return tabs


def _check(bank, bits, n_bits, sid, n_store):
    if bits.dim() != 2 or bits.dtype != torch.uint8 or bits.shape[1] < 1:
        raise ValueError("decl_bank: bits must be uint8 [B, IN], IN >= 1")
    B = bits.shape[0]
    for name, t in (("n_bits", n_bits), ("sid", sid), ("n_store", n_store)):
        if t is not None and (t.shape != (B,) or t.dtype != torch.int32
                              or t.device != bits.device):
            raise ValueError(f"decl_bank: {name} must be int32 [B] on the "
                             f"bits' device")


def preamble_plain(bank: CompiledBank, tabs: dict, bits, n, sid):
    """The preamble search of the JAX path: per candidate, whether its
    spec's masked pattern occurs at an offset ``t >= pre_start`` with
    ``t + plen <= n``, and the first such ``t`` (0 where none)."""
    B, IN = bits.shape
    if not bank.pat_len:
        zero = torch.zeros(B, dtype=torch.int64, device=bits.device)
        return zero.bool(), zero
    PL, T = bank.pat_len, IN
    plen = tabs["plen"][sid].long()
    pat, pmask = tabs["pat"][sid], tabs["pmask"][sid]
    t = torch.arange(T, device=bits.device)[None, :]
    padded = torch.cat([bits, bits.new_zeros((B, PL))], 1)
    m = torch.ones((B, T), dtype=torch.bool, device=bits.device)
    for k in range(PL):
        bk = padded[:, k:k + T]
        care = (pmask[:, k:k + 1] != 0) & (k < plen)[:, None]
        m = m & (~care | (bk == pat[:, k:k + 1]))
    m = m & (t >= tabs["pre_start"][sid][:, None]) \
        & (t + plen[:, None] <= n[:, None])
    return m.any(1), m.to(torch.uint8).argmax(1)


def _stages(bank: CompiledBank, tabs: dict, bits, n, s):
    """The stages before the frame, per candidate (int64 ``n`` and spec
    ids ``s``): the length gate, the preamble (first match wins, ref
    bitbuffer.c:232-253) and the frame offset with its per-length
    alignment. Returns (ok_len, ok_pre, ok_need, frame_off)."""
    ok_len = (n >= tabs["min_bits"][s]) & (n <= tabs["max_bits"][s])
    el = tabs["exact_lens"][s]                               # [B, 4]
    ok_len = ok_len & (~(el > 0).any(1) | (el == n[:, None]).any(1))
    found, pos = preamble_plain(bank, tabs, bits, n, s)
    plen = tabs["plen"][s].long()
    has_pat = plen > 0
    ok_pre = ~has_pat | found
    frame_off = torch.where(has_pat, pos + plen, 0) + tabs["align_off"][s]
    la_len = tabs["la_len"][s]
    frame_off = frame_off + torch.where(
        (la_len > 0) & (la_len == n[:, None]), tabs["la_off"][s], 0).sum(1)
    ok_need = frame_off + tabs["need_bits"][s] <= n
    return ok_len, ok_pre, ok_need, frame_off


def _mic_ok(bank: CompiledBank, tabs: dict, s, xor_of, sum_of):
    """Whether every live check slot holds, from each slot's XOR
    (``xor_of(c)``, uint32 values as int64) and its sum (``sum_of(c)``,
    wrapped to int32 here)."""
    ok_mic = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    for c in range(bank.n_checks):
        kind = tabs["ck_kind"][s, c]
        gf2_ok = xor_of(c) == _u32(tabs["ck_tc"][s, c])
        w = (sum_of(c) + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
        mod = tabs["ck_mod"][s, c].long()
        add_ok = (w % mod + mod) % mod == tabs["ck_tca"][s, c]
        ck = torch.where(kind == CK_GF2, gf2_ok, add_ok) ^ tabs["ck_neq"][s, c]
        ok_mic = ok_mic & ((kind == CK_OFF) | ck)
    return ok_mic


def _code(ok_len, stage, ok_mic):
    code = torch.full(ok_len.shape, DECODE_ABORT_LENGTH, dtype=torch.int32,
                      device=ok_len.device)
    code = torch.where(ok_len, DECODE_ABORT_EARLY, code)
    code = torch.where(stage, DECODE_FAIL_MIC, code)
    return torch.where(stage & ok_mic, 0, code)


def run_torch_plain(bank: CompiledBank, bits, n_bits, sid, n_store=None):
    """Plain version of the bank on any device: the JAX ``xp=jnp`` path of
    :func:`run` (every stage, shape-static) in torch. Returns (code int32
    [B], raws [B, R] uint32 as int32 storage)."""
    tabs = bank_tables(bank, bits.device)
    B, IN = bits.shape
    FB, dev = bank.frame_bits, bits.device
    n = n_bits.long()
    ns = n if n_store is None else n_store.long()
    s = sid.long()
    ok_len, ok_pre, ok_need, frame_off = _stages(bank, tabs, bits, n, s)

    # frame extraction: stale stored bits below n_store are read, zero
    # outside [0, n_store)
    j = torch.arange(FB, device=dev)[None, :]
    src = frame_off[:, None] + j                             # [B, FB]
    inb = (src >= 0) & (src < ns[:, None])
    fb = torch.gather(bits, 1, src.clamp(0, IN - 1))
    fb = torch.where(inb, fb, 0)

    # transforms: invert flips only bits below n (ref bitbuffer.c:135-149)
    tf = tabs["transform"][s]
    fb = torch.where((tf == TF_INVERT)[:, None] & (src < n[:, None]),
                     fb ^ 1, fb)
    ok_tf = torch.ones(B, dtype=torch.bool, device=dev)
    if int(np.any(bank.transform == TF_MANCHESTER)):
        H = FB // 2
        b1 = fb[:, 0:2 * H:2]
        b2 = fb[:, 1:2 * H:2]
        # pair exists while its first bit is inside the row
        avail = src[:, 0:2 * H:2] < n[:, None]
        stop = (b1 == b2) | ~avail
        n_out = torch.where(stop.any(1), stop.to(torch.uint8).argmax(1), H)
        mc = torch.where(torch.arange(H, device=dev)[None, :]
                         < n_out[:, None], b2, 0)
        mc = torch.cat([mc, mc.new_zeros((B, FB - H))], 1)
        is_mc = tf == TF_MANCHESTER
        fb = torch.where(is_mc[:, None], mc, fb)
        ok_tf = ~is_mc | (n_out >= tabs["mc_min"][s])

    # checks: one XOR-reduce and one wrapping int32 sum per slot
    fbit = fb != 0
    ok_mic = _mic_ok(
        bank, tabs, s,
        lambda c: xor_reduce(torch.where(fbit, _u32(tabs["ck_gf2"][s, c]),
                                         0)),
        lambda c: torch.where(fbit, tabs["ck_add"][s, c].long(), 0).sum(1))

    # fields: wrapping uint32 dot products
    if bank.n_raws:
        fb64 = fb.long()
        raws = torch.stack([(fb64 * _u32(tabs["raw_w"][s, r])).sum(1)
                            for r in range(bank.n_raws)], 1)
        raws = (raws + (1 << 31)) % (1 << 32) - (1 << 31)
    else:
        raws = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    return _code(ok_len, ok_len & ok_pre & ok_need & ok_tf, ok_mic), \
        raws.to(torch.int32)


def _range_mask(a, b):
    """Per element, the 32-bit mask of bit positions ``[a, b)`` (LSB
    first; ``a`` and ``b`` are clamped to [0, 32])."""
    a, b = a.clamp(0, 32), b.clamp(0, 32)
    m = ((1 << b) - 1) & ~((1 << a) - 1)
    return torch.where(a < b, m, 0)


def _compress_odd(x):
    """The 16 odd bits of 32-bit words, packed into their low half."""
    x = (x >> 1) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def frame_words(bank: CompiledBank, tabs: dict, bits, n, ns, s, frame_off):
    """The frame as 32-bit words, LSB first (frame bit j is bit j % 32 of
    word j // 32), as the kernel's lanes hold it: the stored bits packed
    into words, each frame word a funnel shift of two of them from
    ``frame_off`` on, with the [0, n_store) mask, the clamp of reads past
    IN to bit IN - 1, invert below n and, for Manchester, the stop pair
    and the second bits compacted, all as word masks. Returns (words
    int64 [B, ceil(FB / 32)], ok_tf)."""
    B, IN = bits.shape
    FB, dev = bank.frame_bits, bits.device
    NW, NF = -(-IN // 32), -(-FB // 32)
    padded = torch.cat([(bits != 0).long(),
                        bits.new_zeros((B, 32 * NW - IN)).long()], 1)
    weight = 1 << torch.arange(32, device=dev)
    words = (padded.view(B, NW, 32) * weight).sum(2)          # [B, NW]
    last = (bits[:, IN - 1] != 0)[:, None]
    lane = 32 * torch.arange(NF, device=dev)[None, :]
    t = frame_off[:, None] + lane                             # [B, NF]
    k = torch.div(t, 32, rounding_mode="floor")
    zero, full = torch.zeros_like(t), torch.full_like(t, 32)

    def word(i):
        inside = (i >= 0) & (i < NW)
        return torch.where(inside, words.gather(1, i.clamp(0, NW - 1)), 0)
    fw = ((word(k + 1) << 32 | word(k)) >> (t - 32 * k)) & 0xFFFFFFFF
    past = _range_mask(IN - t, full)
    fw = (fw & ~past) | torch.where(last, past, 0)
    fw = fw & _range_mask(-t, ns[:, None] - t)
    tf = tabs["transform"][s][:, None]
    fw = fw ^ torch.where(tf == TF_INVERT, _range_mask(zero, n[:, None] - t),
                          0)
    fw = fw & _range_mask(zero, FB - lane)
    ok_tf = torch.ones(B, dtype=torch.bool, device=dev)
    if int(np.any(bank.transform == TF_MANCHESTER)):
        H = FB // 2
        pairs = 0x55555555
        eq = ~(fw ^ (fw >> 1)) & pairs
        gone = _range_mask(n[:, None] - frame_off[:, None] - lane,
                           full) & pairs
        stop = (eq | gone) & _range_mask(zero, 2 * H - lane)
        # the index of the lowest set bit, without float rounding
        low = ((stop & -stop)[..., None]
               > (1 << torch.arange(32, device=dev))).sum(-1)
        at = torch.where(stop != 0, lane // 2 + low // 2, H)
        n_out = at.min(1).values                                # [B]
        odd = _compress_odd(fw)
        odd = torch.cat([odd, torch.zeros_like(odd)], 1)       # [B, 2 NF]
        mc = odd[:, 0::2] | odd[:, 1::2] << 16
        mc = mc & _range_mask(zero, n_out[:, None] - lane)
        is_mc = tf[:, 0] == TF_MANCHESTER
        fw = torch.where(is_mc[:, None], mc, fw)
        ok_tf = ~is_mc | (n_out >= tabs["mc_min"][s])
    return fw, ok_tf


def run_torch_sparse_plain(bank: CompiledBank, bits, n_bits, sid,
                           n_store=None):
    """The kernel's evaluation, emulated in plain torch: the stages of
    :func:`_stages`, the frame as words (:func:`frame_words`), then per
    spec its chunks of :func:`sparse_tables` entries, each entry's frame
    bit taken from its word (the kernel's shuffle), each chunk one XOR or
    wrapping sum (the kernel's warp reduction) into its check slot's or
    field row's accumulator. A spec id out of range gives ABORT_LENGTH
    and zero raws. Returns what :func:`run_torch_plain` returns."""
    tabs = bank_tables(bank, bits.device)
    B, IN = bits.shape
    S, C, R, dev = bank.n_specs, bank.n_checks, bank.n_raws, bits.device
    if R + C > 32:
        raise ValueError("decl_bank: field rows and check slots must fit "
                         "a warp's lanes (R + C <= 32)")
    n = n_bits.long()
    ns = n if n_store is None else n_store.long()
    known = (sid >= 0) & (sid < S)
    s = torch.where(known, sid, 0).long()
    ok_len, ok_pre, ok_need, frame_off = _stages(bank, tabs, bits, n, s)
    fw, ok_tf = frame_words(bank, tabs, bits, n, ns, s, frame_off)

    # per target lane (field row r: lane r; check slot c: lane R + c) its
    # accumulator; chunk m of each candidate's spec in step m
    start = tabs["chunk_start"].long()
    first, count = start[s], start[s + 1] - start[s]
    ent, cdir = tabs["entries"].long(), tabs["chunk_dir"].long()
    acc = torch.zeros((B, 32), dtype=torch.long, device=dev)
    lanes = torch.arange(CHUNK, device=dev)
    for m in range(int((start[1:] - start[:-1]).max()) if S else 0):
        live = m < count
        ch = torch.where(live, first + m, 0)
        e = ent[(CHUNK * ch)[:, None] + lanes]                # [B, 32, 2]
        j, w = e[..., 0], e[..., 1] & 0xFFFFFFFF
        bit = (fw.gather(1, j >> 5) >> (j & 31)) & 1
        v = bit * w
        d = cdir[ch]
        kind, target = d & 0xFF, d >> 8
        red = torch.where(kind == CH_GF2, xor_reduce(v),
                          v.sum(1) & 0xFFFFFFFF)
        lane = torch.where(kind == CH_RAW, target, R + target)[:, None]
        cur = acc.gather(1, lane)[:, 0]
        new = torch.where(kind == CH_GF2, cur ^ red,
                          (cur + red) & 0xFFFFFFFF)
        acc.scatter_(1, lane, torch.where(live, new, cur)[:, None])

    slot = lambda c: acc[:, R + c]
    ok_mic = _mic_ok(bank, tabs, s, slot, slot)
    raws = acc[:, :R] if R else torch.zeros_like(acc[:, :1])
    raws = ((raws + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    code = _code(ok_len, ok_len & ok_pre & ok_need & ok_tf, ok_mic)
    code = torch.where(known, code, DECODE_ABORT_LENGTH)
    return code, torch.where(known[:, None], raws, 0)


def run_torch(bank: CompiledBank, bits, n_bits, sid, n_store=None):
    """Evaluate a candidate batch against the bank on the tensors' device:
    :func:`run`'s contract (``bits`` uint8 0/1 ``[B, IN]``, ``n_bits``,
    ``sid`` with values in ``[0, n_specs)`` and ``n_store`` int32 ``[B]``)
    as the JAX ``xp=jnp`` path computes it. Returns (code int32 [B], raws
    [B, R] uint32 as int32 storage) on that device. A CUDA tensor launches
    ``csrc/decl_bank.cu`` (which walks the sparse entry tables; a bank
    with more than 1024 frame bits, or more than 32 field rows and check
    slots together, raises), a CPU tensor runs :func:`run_torch_plain`."""
    _check(bank, bits, n_bits, sid, n_store)
    if not bits.is_cuda:
        return run_torch_plain(bank, bits, n_bits, sid, n_store)
    FB, C, R = bank.frame_bits, bank.n_checks, bank.n_raws
    if FB > 1024 or R + C > 32:
        raise ValueError("decl_bank: the kernel holds a frame word and an "
                         "accumulator per lane (FB <= 1024, R + C <= 32)")
    tabs = bank_tables(bank, bits.device)
    B, IN = bits.shape
    bits, n_bits, sid = (t.contiguous() for t in (bits, n_bits, sid))
    ns = n_bits if n_store is None else n_store.contiguous()
    code = torch.empty(B, dtype=torch.int32, device=bits.device)
    raws = (torch.empty if R else torch.zeros)(
        (B, max(R, 1)), dtype=torch.int32, device=bits.device)
    if B:
        spec = tabs["spec"]
        fn = _cuda.launcher("decl_bank")
        with _cuda.launch_device(bits):
            _cuda.LAUNCHES["decl_bank"] += 1
            err = fn(bits.data_ptr(), n_bits.data_ptr(), ns.data_ptr(),
                     sid.data_ptr(), B, IN, spec.data_ptr(), spec.shape[1],
                     bank.n_specs, tabs["entries"].data_ptr(),
                     tabs["chunk_dir"].data_ptr(),
                     tabs["chunk_start"].data_ptr(), FB, C, R,
                     (bank.pat_len + 31) // 32, code.data_ptr(),
                     raws.data_ptr(), _cuda.stream_of(bits))
        _cuda.check(err, "decl_bank")
    return code, raws


def run_on(device, bank: CompiledBank, bits, n_bits, sid, n_store=None):
    """:func:`run`'s NumPy arguments and results: :func:`run` on NumPy
    where ``device`` is None, else :func:`run_torch` on ``device`` (a CUDA
    device must exist)."""
    if device is None:
        return run(bank, bits, n_bits, sid, n_store=n_store)
    dev = _cuda.resolve_device(device)
    args = [torch.from_numpy(np.ascontiguousarray(a, t)).to(dev)
            for a, t in ((bits, np.uint8), (n_bits, np.int32),
                         (sid, np.int32))]
    ns = None if n_store is None else torch.from_numpy(
        np.ascontiguousarray(n_store, np.int32)).to(dev)
    code, raws = run_torch(bank, *args, n_store=ns)
    return code.cpu().numpy(), raws.cpu().numpy().view(np.uint32)

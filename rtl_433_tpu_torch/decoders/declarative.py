"""Declarative decoder specs: protocols as data, decoded by one batched
kernel (ops/decode_bank.py) instead of per-protocol Python.

Each entry in DECL describes a protocol's decode as row selection +
length window + preamble + transform + affine MIC checks + linear field
extraction + an event template — the SURVEY §2 row-12 "jit-compatible
pure function over bitbuffer arrays" plan: the spec lowers to weight
tables, the shared kernel evaluates any batch of (row, protocol)
candidates in one pass (NumPy on the host), and the host formats
events only for the survivors.

The Python decode functions remain registered and authoritative: a
declarative spec SHADOWS its decoder and must produce byte-identical
events (and compatible failure accounting) — enforced for every oracle
vector and under mutation fuzz by tests/test_declarative.py. Rows too
long for the bank fall back to the Python decoder per candidate.

Semantics are cited per spec against the reference decoder source.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import decode_bank as dbk
from ..output.data_model import Event
from .base import (DECODE_ABORT_EARLY, DECODE_ABORT_LENGTH,
                   DECODE_FAIL_SANITY)

# sentinel: candidate must run the Python decoder (row too long etc.)
FALLBACK = object()


@dataclass(frozen=True)
class Check:
    """One MIC check (see ops/decode_bank.py lowering)."""
    algo: str
    off: int = 0                # frame-bit offset of the digest window
    nbytes: int = 0
    p1: int = 0
    p2: int = 0
    xor_out: int = 0
    mask: Optional[int] = None
    cmp_off: int = -1           # frame-bit offset of the expected value
    cmp_width: int = 0
    cmp_const: int = 0
    reflect: bool = False
    negated: bool = False
    add_const: int = 0
    # explicit window-bit -> frame-bit map for scrambled windows
    # (entries of -1 feed constant 0)
    bit_map: Optional[Tuple[int, ...]] = None
    # extra (frame_bit, weight) GF(2) contributions XORed into the compare
    # (e.g. an expected value that is itself a xor of two fields)
    xor_bits: Tuple[Tuple[int, int], ...] = ()
    # extra (frame_bit, weight) contributions SUBTRACTED from an additive
    # sum (expected values at descending/scrambled bit positions)
    sub_bits: Tuple[Tuple[int, int], ...] = ()


@dataclass(frozen=True)
class Raw:
    """One extracted field (unsigned, <= 32 bits)."""
    off: int = 0
    width: int = 0
    rev_bytes: bool = False
    bit_order: Optional[Tuple[int, ...]] = None  # explicit bits, MSB first


@dataclass(frozen=True)
class San:
    """Sanity predicate over a raw: fails with DECODE_FAIL_SANITY.
    ``signed_bits`` sign-extends the raw before comparing. A spec's
    ``sanity`` tuple may also hold TUPLES of San — an OR-group (any
    member passing passes the group); top-level entries AND together."""
    raw: int
    op: str                     # eq ne le ge lt gt in nin
    val: object = 0             # int/float, or a tuple for in/nin
    mask: Optional[int] = None
    signed_bits: int = 0
    # F-style terms replace `raw` when set (combined-value sanity)
    terms: Tuple = ()
    shr: int = 0
    # replicate float range checks exactly: compare float((v+addi) * fmul)
    fmul: Optional[float] = None
    addi: int = 0


@dataclass(frozen=True)
class F:
    """Event field template. kinds:
    const        -> value
    int          -> sum(term values) + add
    float        -> (sum(term values) + add) * mul
    bool         -> int(bool(int value))
    eq           -> int((raw & mask) == val)
    enum         -> map[int value] (KeyError -> default or drop event)
    terms: ((raw_idx, coef, signed_bits),...) — signed_bits 0 = unsigned.
    cond: San-style predicate; field dropped when false (DATA_COND)."""
    key: str
    kind: str = "int"
    value: object = None
    terms: Tuple = ()
    add: float = 0
    mul: float = 1.0
    shr: int = 0                # arithmetic shift applied after terms
    modulo: int = 0             # acc %= modulo after add (wrap idioms)
    mask: int = 0xFFFFFFFF
    val: int = 0
    map: Optional[Dict] = None
    default: object = None
    pretty: Optional[str] = None
    fmt: Optional[str] = None
    cond: Optional[San] = None


@dataclass(frozen=True)
class Variant:
    """Event template variant: first variant whose cond holds formats the
    event (cond None = always)."""
    fields: Tuple[F, ...]
    cond: Optional[San] = None


@dataclass(frozen=True)
class DeclSpec:
    symbol: str
    min_bits: int
    max_bits: int = 1 << 20
    row_mode: str = "any"       # any | row0 | fixed | repeat | all
    fixed_row: int = 0
    min_repeats: int = 1
    repeat_min_bits: int = 0
    # optional host-side precondition over the whole bitbuffer (used for
    # quirks the row machinery can't express, e.g. prologue's short-row-0
    # guard); returns a DECODE_* code to abort or None to continue
    host_guard: Optional[object] = None
    in_bits: int = 0            # bank input width (0 = auto)
    frame_bits: int = 64
    exact_lens: Tuple[int, ...] = ()      # whitelist of exact row lengths
    len_aligns: Tuple[Tuple[int, int], ...] = ()  # (row_len, extra_off)
    preamble: Optional[str] = None   # bit string, 'x' = don't care
    pre_start: int = 0
    align_off: int = 0
    need_bits: int = 0
    transform: str = "none"     # none | invert | manchester
    mc_min: int = 0
    checks: Tuple[Check, ...] = ()
    sanity: Tuple[San, ...] = ()
    raws: Tuple[Raw, ...] = ()
    variants: Tuple[Variant, ...] = ()


_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "in": lambda a, b: a in b,
    "nin": lambda a, b: a not in b,
}


def _lower(spec: DeclSpec) -> dbk.LoweredSpec:
    fb = spec.frame_bits
    gf2 = []
    add = []
    for c in spec.checks:
        if c.algo in dbk._ADD_ALGOS:
            w, mod, tc, neq = dbk.make_add_check(
                c.algo, c.off, c.nbytes, mask=c.mask, cmp_off=c.cmp_off,
                cmp_width=c.cmp_width, cmp_const=c.cmp_const,
                reflect=c.reflect, negated=c.negated, frame_bits=fb,
                add_const=c.add_const, bit_map=c.bit_map,
                sub_bits=c.sub_bits)
            add.append((_pad(w, fb), mod, tc, neq))
        else:
            tab, tc, neq = dbk.make_gf2_check(
                c.algo, c.off, c.nbytes, c.p1, c.p2, xor_out=c.xor_out,
                mask=c.mask, cmp_off=c.cmp_off, cmp_width=c.cmp_width,
                cmp_const=c.cmp_const, reflect=c.reflect,
                negated=c.negated, frame_bits=fb, xor_bits=c.xor_bits,
                bit_map=c.bit_map)
            gf2.append((_pad(tab, fb), tc, neq))
    raws = np.zeros((len(spec.raws), fb), np.uint32)
    for i, r in enumerate(spec.raws):
        raws[i] = dbk.make_raw(r.off, r.width, fb, bit_order=r.bit_order,
                               rev_bytes=r.rev_bytes)
    pat_bits: List[int] = []
    pat_mask: List[int] = []
    if spec.preamble:
        for ch in spec.preamble:
            pat_bits.append(1 if ch == "1" else 0)
            pat_mask.append(0 if ch in "xX" else 1)
    tf = {"none": dbk.TF_NONE, "invert": dbk.TF_INVERT,
          "manchester": dbk.TF_MANCHESTER}[spec.transform]
    in_bits = spec.in_bits or max(
        spec.min_bits, spec.pre_start + len(pat_bits) + spec.align_off
        + (fb * 2 if tf == dbk.TF_MANCHESTER else fb), 64)
    return dbk.LoweredSpec(
        min_bits=spec.min_bits, max_bits=spec.max_bits, in_bits=in_bits,
        frame_bits=fb, pat_bits=pat_bits, pat_mask=pat_mask,
        pre_start=spec.pre_start, align_off=spec.align_off,
        need_bits=spec.need_bits, transform=tf, mc_min=spec.mc_min,
        gf2_tabs=gf2, add_tabs=add, raw_tabs=raws,
        exact_lens=spec.exact_lens, len_aligns=spec.len_aligns)


def _pad(a: np.ndarray, fb: int) -> np.ndarray:
    if a.shape[-1] == fb:
        return a
    out = np.zeros(a.shape[:-1] + (fb,), a.dtype)
    out[..., :a.shape[-1]] = a
    return out


def _sex(v: int, bits: int) -> int:
    if bits and v & (1 << (bits - 1)):
        return v - (1 << bits)
    return v


def _terms(terms, vals) -> int:
    """Sum of (raw_idx, coef, signed_bits[, (gt, sub)]) terms; the optional
    4th element subtracts ``sub`` when the raw exceeds ``gt`` (the
    raw > 2048 two's-complement idiom some decoders use)."""
    acc = 0
    for t in terms:
        ri, coef = t[0], t[1]
        sbits = t[2] if len(t) > 2 else 0
        v = _sex(vals[ri], sbits)
        if len(t) > 3:
            gt, sub = t[3]
            if v > gt:
                v -= sub
        acc += v * coef
    return acc


class DeclRunner:
    """Batched declarative decode over a set of symbols."""

    def __init__(self, specs: Sequence[DeclSpec]):
        self.specs = list(specs)
        self.by_symbol = {s.symbol: i for i, s in enumerate(self.specs)}
        self.bank = dbk.CompiledBank([_lower(s) for s in self.specs])

    # -- candidate building --------------------------------------------------

    def _rows_for(self, spec: DeclSpec, bits) -> object:
        """Row indices the spec inspects, or a direct int ret code."""
        if spec.host_guard is not None:
            # returns None (continue), an int code (abort), an explicit
            # row list (custom row selection, e.g. repeated-prefix
            # modes), or FALLBACK (a shape only the Python twin handles,
            # e.g. fineoffset_WH0530's Alecto length variants)
            g = spec.host_guard(bits)
            if g is FALLBACK:
                return g
            if isinstance(g, (int, list)):
                return g
        if spec.row_mode == "repeat":
            r = bits.find_repeated_row(spec.min_repeats,
                                       spec.repeat_min_bits)
            if r < 0:
                return DECODE_ABORT_EARLY
            return [r]
        if spec.row_mode == "row0":
            return [0]
        if spec.row_mode == "fixed":
            return [spec.fixed_row]
        return list(range(bits.num_rows))

    def _row_bits(self, bits, row: int):
        """Unpack the row's STORED bits (the reference's extract/digest
        helpers read stale storage past bits_per_row, so the kernel gets
        the storage too, zero-padded at the true storage boundary)."""
        n = int(bits.bits_per_row[row])
        if n > self.bank.in_bits:
            return None, 0
        raw = bits.bb[row:].reshape(-1)
        nb = min(raw.size, (self.bank.in_bits + 7) // 8)
        ba = np.unpackbits(raw[:nb])
        out = np.zeros(self.bank.in_bits, np.uint8)
        m = min(ba.size, self.bank.in_bits)
        out[:m] = ba[:m]
        return out, m

    def decode_many(self, items: Sequence[Tuple[str, object]],
                    device=None) -> List[object]:
        """items: (symbol, BitBuffer) pairs. Returns per item: a list of
        Events, a negative DECODE_* code, or FALLBACK (row too long —
        caller must run the Python decoder).

        The candidates are built and the events formatted on the host; the
        bank (``dbk.run_on``) runs on NumPy when ``device`` is None (the
        per-train host dispatch's backend, JAX's ``xp=np``), else as torch
        on ``device`` (the CUDA kernel on a CUDA device, which must exist;
        its plain version on the CPU; JAX's ``xp=jnp``). Both give the same
        result."""
        rets: List[object] = [None] * len(items)
        cand_bits: List[np.ndarray] = []
        cand_n: List[int] = []
        cand_ns: List[int] = []
        cand_sid: List[int] = []
        cand_item: List[int] = []
        for ix, (symbol, bits) in enumerate(items):
            si = self.by_symbol[symbol]
            spec = self.specs[si]
            rows = self._rows_for(spec, bits)
            if rows is FALLBACK:
                rets[ix] = FALLBACK
                continue
            if isinstance(rows, int):
                rets[ix] = rows
                continue
            any_row = False
            for r in rows:
                ba, m = self._row_bits(bits, r)
                if ba is None:
                    rets[ix] = FALLBACK
                    any_row = False
                    break
                cand_bits.append(ba)
                cand_n.append(int(bits.bits_per_row[r]))
                cand_ns.append(m)
                cand_sid.append(si)
                cand_item.append(ix)
                any_row = True
            if not any_row and rets[ix] is None:
                rets[ix] = DECODE_ABORT_EARLY
        if not cand_bits:
            return rets
        code, raws = dbk.run_on(device, self.bank, np.stack(cand_bits),
                                np.asarray(cand_n, np.int32),
                                np.asarray(cand_sid, np.int32),
                                n_store=np.asarray(cand_ns, np.int32))
        code = np.asarray(code)
        raws = np.asarray(raws)
        # group candidate rows back to items, in row order
        for k in range(len(cand_bits)):
            ix = cand_item[k]
            if rets[ix] is FALLBACK:
                continue
            spec = self.specs[cand_sid[k]]
            c = int(code[k])
            if c == 0:
                c, ev = self._format(spec, raws[k])
            else:
                ev = None
            prev = rets[ix]
            if ev is not None:
                if isinstance(prev, list):
                    # only "all" mode accumulates events across rows;
                    # "any" keeps the FIRST decodable row (the reference
                    # returns from its row loop on first success)
                    if spec.row_mode == "all":
                        prev.extend(ev)
                else:
                    rets[ix] = ev
            elif not isinstance(prev, list):
                # keep the most-progressed failure code
                rets[ix] = c if prev is None else min(prev, c)
        return rets

    # -- event formatting ----------------------------------------------------

    @staticmethod
    def _san_ok(s: San, vals) -> bool:
        if s.terms:
            v = _terms(s.terms, vals) >> s.shr
        else:
            v = vals[s.raw] & s.mask if s.mask is not None else vals[s.raw]
            if s.signed_bits:
                v = _sex(v, s.signed_bits)
        if s.fmul is not None:
            v = float((v + s.addi) * s.fmul)
        return _OPS[s.op](v, s.val)

    def _format(self, spec: DeclSpec, raw: np.ndarray):
        vals = [int(v) for v in raw]
        for s in spec.sanity:
            if isinstance(s, tuple):   # OR-group
                if not any(self._san_ok(g, vals) for g in s):
                    return DECODE_FAIL_SANITY, None
            elif not self._san_ok(s, vals):
                return DECODE_FAIL_SANITY, None
        var = None
        for v in spec.variants:
            if v.cond is None or self._san_ok(v.cond, vals):
                var = v
                break
        if var is None:
            return DECODE_FAIL_SANITY, None
        fields = []
        for f in var.fields:
            if f.cond is not None and not self._san_ok(f.cond, vals):
                continue
            val = self._fval(f, vals)
            item = [f.key, val]
            if f.pretty is not None or f.fmt is not None:
                item.append(f.pretty if f.pretty is not None else f.key)
            if f.fmt is not None:
                item.append(f.fmt)
            fields.append(tuple(item))
        return 0, [Event.make(*fields)]

    def _fval(self, f: F, vals: List[int]):
        """acc = (sum(terms) >> shr) + add, then per-kind rendering."""
        if f.kind == "const":
            return f.value
        if f.kind == "fsum":
            # left-to-right FLOAT accumulation of coef*value, then + add:
            # replicates e.g. `10*d1 + d2 + 0.1*d3 - 40.0` bit-exactly
            # (ints < 2^53 are exact in float, so the integer prefix
            # matches Python's int math before the float term joins)
            accf = 0.0
            for t in f.terms:
                ri, coef = t[0], t[1]
                sbits = t[2] if len(t) > 2 else 0
                accf = accf + coef * _sex(vals[ri], sbits)
            return float(accf + f.add)
        acc = (_terms(f.terms, vals) >> f.shr) + f.add
        if f.modulo:
            acc = int(acc) % f.modulo
        if f.kind == "int":
            return int(acc)
        if f.kind == "float":
            return float(acc * f.mul)
        if f.kind == "bool":
            return int(bool(int(acc)))
        if f.kind == "eq":
            return int((int(acc) & f.mask) == f.val)
        if f.kind == "enum":
            return f.map.get(int(acc), f.default)
        if f.kind == "mapf":   # map exceptions, else the value; as float
            return float(f.map.get(int(acc), acc))
        if f.kind == "enumf":  # mapped int, then the float mul chain
            return float(f.map.get(int(acc), f.default) * f.mul)
        if f.kind == "hexs":   # zero-padded lowercase hex string, f.val
            return format(int(acc), "0%dx" % f.val)  # = digit count
        if f.kind == "hexsu":  # uppercase variant
            return format(int(acc), "0%dX" % f.val)
        if f.kind == "tri":    # f.val base-4 digits via alphabet f.value
            v = int(acc)
            return "".join(f.value[(v >> (2 * (f.val - 1 - i))) & 3]
                           for i in range(f.val))
        raise ValueError(f.kind)


# ---------------------------------------------------------------------------
# Spec table. Each spec cites the reference decoder it mirrors; the Python
# twin in this package stays registered and is the differential oracle.
# ---------------------------------------------------------------------------

DECL: Dict[str, DeclSpec] = {}

_RUNNER: Optional[DeclRunner] = None


def _spec(s: DeclSpec):
    DECL[s.symbol] = s
    return s


def get_runner() -> DeclRunner:
    """Process-wide runner over the full DECL table (static; the lowered
    weight tables compile once)."""
    global _RUNNER
    if _RUNNER is None:
        _RUNNER = DeclRunner(list(DECL.values()))
    return _RUNNER


# populate DECL (bottom import: decl_specs needs the IR names above)
from . import decl_specs  # noqa: E402,F401

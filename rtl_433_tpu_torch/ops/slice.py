"""Device slicing: the nine batched slicer scans, each wrapper beside its
plain version.

Every (train, spec) pair of a drain is one *lane*: the lane runs one
reference slicer's state machine over its train's pulses and writes
bitbuffers. ``slice_<family>(pulse, gap, n_pulses, bounds, caps)`` takes
pulse/gap int32 ``[B, N]``, n_pulses int32 ``[B]`` and the family's per-spec
bound columns (``<family>_bounds``, host NumPy, ``[S]`` each), and returns

- ``bytes`` uint8 ``[B, S, E, R, BY]``: packed bit rows;
- ``bits_per_row``, ``syncs`` int32 ``[B, S, E, R]``;
- ``num_rows`` int32 ``[B, S, E]``; ``n_events`` int32 and ``ovf`` bool
  ``[B, S]``.

The contract is the JAX package's ``ops/slice.py``, to the integer: each
family mirrors its host slicer (pulse/slicers.py) statement for statement
while the lane stays inside its caps; a capacity overflow (events, rows,
row bytes) or a float32 rounding near a boundary (PCM) raises the lane's
``ovf`` instead, and an integration routes flagged lanes to the host
slicer. Writes outside the caps are dropped, as the JAX scatters drop them.

For a CUDA tensor each wrapper launches ``csrc/slice.cu`` (a thread group
per lane; the train and each lane's events staged in shared memory, the
launch shaped by :func:`launch_plan`); for a CPU tensor it runs the plain
version: the kernel's phases vectorized over pulses (symbols for DMC and
PIWM-DC) and lanes (what no state decides, MC's walk per piece, DMC's
pending flag and OSV1's Manchester bit from parities, OSV1's phases in
closed form, PCM's rate pass as RZ's closed form and NRZ's rounds of
speculation, PCM's erase by the first reset at or after a pulse, the
cursors from running sums); then the JAX assembly by scatter-adds
(``_lane_scatter_add``, ``_assemble_cols``, ``_assemble_runs``, PCM's
delta-scatter and cumulative sum).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

_BIG = 1 << 30


class SliceCaps(NamedTuple):
    events: int = 4       # events per (package, spec)
    rows: int = 16        # rows per event
    row_bytes: int = 20   # bytes per row


# ---------------------------------------------------------------------------
# per-spec bound columns (host NumPy)
# ---------------------------------------------------------------------------

class _P:  # _timings reads only sample_rate
    def __init__(self, sample_rate):
        self.sample_rate = sample_rate


def ppm_bounds(devices, sample_rate: int):
    """Per-spec PPM windows [S] (mirrors pulse/slicers.py slicer_ppm)."""
    from ..pulse.slicers import _timings

    cols = {k: [] for k in ("zero_l", "zero_u", "one_l", "one_u",
                            "sync_l", "sync_u", "reset", "ok")}
    p = _P(sample_rate)
    for dev in devices:
        t = _timings(p, dev)
        if t is None:
            for k in cols:
                cols[k].append(0 if k != "ok" else False)
            continue
        s_short, s_long = t["short"], t["long"]
        s_gap, s_reset = t["gap"], t["reset"]
        s_sync, s_tol = t["sync"], t["tolerance"]
        sync_l = sync_u = 0
        if s_tol > 0:
            zero_l, zero_u = s_short - s_tol, s_short + s_tol
            one_l, one_u = s_long - s_tol, s_long + s_tol
            if s_sync > 0:
                sync_l, sync_u = s_sync - s_tol, s_sync + s_tol
        else:
            zero_l = 0
            zero_u = (s_short + s_long) // 2 + 1
            one_l = zero_u - 1
            one_u = s_gap if s_gap else s_reset
        for k, v in (("zero_l", zero_l), ("zero_u", zero_u),
                     ("one_l", one_l), ("one_u", one_u),
                     ("sync_l", sync_l), ("sync_u", sync_u),
                     ("reset", s_reset), ("ok", True)):
            cols[k].append(v)
    return {k: np.asarray(v, np.int32 if k != "ok" else bool)
            for k, v in cols.items()}


def pwm_bounds(devices, sample_rate: int):
    """Per-spec PWM windows [S] (mirrors pulse/slicers.py slicer_pwm)."""
    from ..pulse.slicers import _timings

    cols = {k: [] for k in ("one_l", "one_u", "zero_l", "zero_u",
                            "sync_l", "sync_u", "gap", "reset", "ok")}
    p = _P(sample_rate)
    for dev in devices:
        t = _timings(p, dev)
        if t is None:
            for k in cols:
                cols[k].append(0 if k != "ok" else False)
            continue
        s_short, s_long, s_reset = t["short"], t["long"], t["reset"]
        s_gap, s_sync, s_tol = t["gap"], t["sync"], t["tolerance"]
        sync_l = sync_u = 0
        if s_tol > 0:
            one_l, one_u = s_short - s_tol, s_short + s_tol
            zero_l, zero_u = s_long - s_tol, s_long + s_tol
            if s_sync > 0:
                sync_l, sync_u = s_sync - s_tol, s_sync + s_tol
        elif s_sync <= 0:
            one_l, one_u = 0, (s_short + s_long) // 2 + 1
            zero_l, zero_u = one_u - 1, _BIG
        elif s_sync < s_short:
            sync_l, sync_u = 0, (s_sync + s_short) // 2 + 1
            one_l, one_u = sync_u - 1, (s_short + s_long) // 2 + 1
            zero_l, zero_u = one_u - 1, _BIG
        elif s_sync < s_long:
            one_l, one_u = 0, (s_short + s_sync) // 2 + 1
            sync_l, sync_u = one_u - 1, (s_sync + s_long) // 2 + 1
            zero_l, zero_u = sync_u - 1, _BIG
        else:
            one_l, one_u = 0, (s_short + s_long) // 2 + 1
            zero_l, zero_u = one_u - 1, (s_long + s_sync) // 2 + 1
            sync_l, sync_u = zero_u - 1, _BIG
        for k, v in (("one_l", one_l), ("one_u", one_u),
                     ("zero_l", zero_l), ("zero_u", zero_u),
                     ("sync_l", sync_l), ("sync_u", sync_u),
                     ("gap", s_gap), ("reset", s_reset), ("ok", True)):
            cols[k].append(v)
    return {k: np.asarray(v, np.int32 if k != "ok" else bool)
            for k, v in cols.items()}


def pcm_bounds(devices, sample_rate: int):
    """Per-spec PCM parameters [S] (mirrors pulse/slicers.py slicer_pcm).

    Bit-rate seeds ``f0s``/``f0l`` are computed in float64 and cast to
    float32; every rounding site of the scan carries an uncertainty flag
    wide enough to cover the float32-vs-float64 gap, so unflagged lanes
    are bit-exact against the host slicer.
    """
    from ..pulse.slicers import _timings

    cols = {k: [] for k in ("short", "long", "reset", "gap_limit", "tol",
                            "max_zeros", "min_count", "is_rz",
                            "f0s", "f0l", "ok")}
    p = _P(sample_rate)
    spu = np.float32(sample_rate) / np.float32(1.0e6)
    for dev in devices:
        t = _timings(p, dev)
        if t is None:
            for k in cols:
                cols[k].append(False if k == "ok" else 0)
            continue
        s_short, s_long, s_reset = t["short"], t["long"], t["reset"]
        s_gap, s_tol = t["gap"], t["tolerance"]
        f0s = 1.0 / float(np.float32(dev.short_width) * spu) \
            if dev.short_width > 0 else 0.0
        f0l = 1.0 / float(np.float32(dev.long_width) * spu) \
            if dev.long_width > 0 else 0.0
        gap_limit = s_gap if s_gap else s_reset
        max_zeros = gap_limit // s_long if s_long else 0
        if s_tol <= 0:
            s_tol = s_long // 4
        for k, v in (("short", s_short), ("long", s_long),
                     ("reset", s_reset), ("gap_limit", gap_limit),
                     ("tol", s_tol), ("max_zeros", max_zeros),
                     ("min_count", 12 if s_short == s_long else 4),
                     ("is_rz", s_short != s_long),
                     ("f0s", f0s), ("f0l", f0l), ("ok", True)):
            cols[k].append(v)
    out = {}
    for k, v in cols.items():
        if k in ("f0s", "f0l"):
            out[k] = np.asarray(v, np.float32)
        elif k in ("is_rz", "ok"):
            out[k] = np.asarray(v, bool)
        else:
            out[k] = np.asarray(v, np.int32)
    return out


def _timing_cols(devices, sample_rate: int, fields):
    """Shared per-spec timing-column builder: ``fields`` maps a column
    name to a callable over the resolved _timings dict; specs whose
    timings don't resolve get 0/False and ok=False."""
    from ..pulse.slicers import _timings

    p = _P(sample_rate)
    ts = [_timings(p, dev) for dev in devices]
    out = {"ok": np.asarray([t is not None for t in ts], bool)}
    for k, fn in fields.items():
        vals = [fn(t) for t in ts if t is not None]
        isbool = bool(vals) and isinstance(vals[0], (bool, np.bool_))
        full = [fn(t) if t is not None else (False if isbool else 0)
                for t in ts]
        out[k] = np.asarray(full, bool if isbool else np.int32)
    return out


def mc_bounds(devices, sample_rate: int):
    """Per-spec MC-zerobit windows [S]. All comparisons are integer
    (`x > 1.5*s` is evaluated as `2x > 3s`), so the scan is exact with no
    float-boundary flag."""
    return _timing_cols(devices, sample_rate, {
        "short": lambda t: t["short"], "reset": lambda t: t["reset"],
        "tol": lambda t: t["tolerance"],
        "has_tol": lambda t: bool(t["tolerance"] > 0)})


def dmc_bounds(devices, sample_rate: int):
    """Per-spec DMC windows [S]; all comparisons are integer-exact."""
    return _timing_cols(devices, sample_rate, {
        "short": lambda t: t["short"], "long": lambda t: t["long"],
        "reset": lambda t: t["reset"], "tol": lambda t: t["tolerance"]})


def piwm_dc_bounds(devices, sample_rate: int):
    """Per-spec PIWM-DC windows [S]; all comparisons are integer-exact."""
    return _timing_cols(devices, sample_rate, {
        "short": lambda t: t["short"], "long": lambda t: t["long"],
        "reset": lambda t: t["reset"], "tol": lambda t: t["tolerance"]})


def nrzs_bounds(devices, sample_rate: int):
    """Per-spec NRZS parameters [S]; integer-exact. A non-positive
    resolved bit limit is flagged not-ok (as rzi_bounds guards s_long):
    the scan's guarded division would otherwise emit p//1 ones per pulse,
    overflow, and drop the lane to the host slicer_nrzs, which divides by
    zero."""
    cols = _timing_cols(devices, sample_rate, {
        "short": lambda t: t["short"], "reset": lambda t: t["reset"]})
    cols["ok"] = cols["ok"] & (cols["short"] > 0)
    return cols


def rzi_bounds(devices, sample_rate: int):
    """Per-spec RZI parameters [S] (mirrors pulse/slicers.py slicer_rzi,
    which bypasses _timings: zero-width check is per present field only)."""
    cols = {k: [] for k in ("short", "long", "reset", "base", "ok")}
    spu = np.float32(sample_rate) / np.float32(1.0e6)
    for dev in devices:
        s_short = int(np.float32(dev.short_width) * spu)
        s_long = int(np.float32(dev.long_width) * spu)
        s_reset = int(np.float32(dev.reset_limit) * spu)
        bad = ((dev.short_width > 0 and s_short <= 0)
               or (dev.long_width > 0 and s_long <= 0)
               or (dev.reset_limit > 0 and s_reset <= 0)
               or s_long <= 0)
        for k, v in (("short", s_short), ("long", s_long),
                     ("reset", s_reset), ("base", s_long - s_short),
                     ("ok", not bad)):
            cols[k].append(v)
    return {k: np.asarray(v, bool if k == "ok" else np.int32)
            for k, v in cols.items()}


def osv1_bounds(devices, sample_rate: int):
    """Per-spec OSv1 parameters [S]; integer-exact."""
    return _timing_cols(devices, sample_rate, {
        "short": lambda t: t["short"], "reset": lambda t: t["reset"]})


# family -> (the kernel's family id, its bound columns in the kernel's
# order, ok last); csrc/slice.cu reads row s of an int32 [S, NCOLS] table:
# the columns from 0, ok in column NCOLS - 1, float columns (PCM's f0s,
# f0l) as their bits
FAMILIES = {
    "ppm": (0, ("zero_l", "zero_u", "one_l", "one_u", "sync_l", "sync_u",
                "reset", "ok")),
    "pwm": (1, ("one_l", "one_u", "zero_l", "zero_u", "sync_l", "sync_u",
                "gap", "reset", "ok")),
    "pcm": (2, ("short", "long", "reset", "gap_limit", "tol", "max_zeros",
                "min_count", "is_rz", "f0s", "f0l", "ok")),
    "mc": (3, ("short", "reset", "tol", "has_tol", "ok")),
    "dmc": (4, ("short", "long", "reset", "tol", "ok")),
    "piwm_dc": (5, ("short", "long", "reset", "tol", "ok")),
    "nrzs": (6, ("short", "reset", "ok")),
    "rzi": (7, ("long", "reset", "base", "short", "ok")),
    "osv1": (8, ("short", "reset", "ok")),
}
NCOLS = 12


def bound_table(fam: str, bounds) -> np.ndarray:
    """The family's bound columns as the kernel's int32 [S, NCOLS] table."""
    names = FAMILIES[fam][1]
    S = len(np.asarray(bounds["ok"]))
    tab = np.zeros((S, NCOLS), np.int32)
    for i, k in enumerate(names):
        if k == "ok":
            i = NCOLS - 1
        v = np.asarray(bounds[k])
        tab[:, i] = v.view(np.int32) if v.dtype == np.float32 \
            else v.astype(np.int32)
    return tab


def table_columns(fam: str, tab) -> dict:
    """The bound columns of a packed table (NumPy or a tensor), as the
    family's ``<fam>_bounds`` gives them."""
    tab = np.asarray(tab.cpu() if isinstance(tab, torch.Tensor) else tab,
                     np.int32)
    out = {}
    for i, k in enumerate(FAMILIES[fam][1]):
        col = tab[:, NCOLS - 1 if k == "ok" else i].copy()
        if k in ("f0s", "f0l"):
            out[k] = col.view(np.float32)
        elif k in ("ok", "is_rz", "has_tol"):
            out[k] = col != 0
        else:
            out[k] = col
    return out


# ---------------------------------------------------------------------------
# the plain versions (vectorized torch over the [B, S] lane grid)
# ---------------------------------------------------------------------------

def _cols(bounds, device):
    """Bound columns as [1, S] tensors on ``device``."""
    out = {}
    for k, v in bounds.items():
        v = np.asarray(v)
        if v.dtype not in (np.bool_, np.float32):
            v = v.astype(np.int32)
        out[k] = torch.as_tensor(v, device=device)[None, :]
    return out


def _scatter_add(shape, idx_cols, vals, mask):
    """int32 zeros of ``shape`` with ``vals`` added at ``idx_cols`` where
    ``mask`` holds and every index is in range (out-of-range updates are
    dropped, as XLA's FILL_OR_DROP drops them)."""
    ok = mask
    lin = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    for c, d in zip(idx_cols, shape):
        c = torch.as_tensor(c, device=mask.device).to(torch.int64)
        ok = ok & (c >= 0) & (c < d)
        lin = lin * d + c
    out = torch.zeros(math.prod(shape), dtype=torch.int32, device=mask.device)
    vals = torch.broadcast_to(torch.as_tensor(vals, device=mask.device),
                              mask.shape).to(torch.int32)
    out.index_add_(0, lin[ok], vals[ok])
    return out.reshape(shape)


def _lane_scatter_add(B, S, shape, idx_cols, vals, mask):
    """Masked scatter-add over the flattened B*S lane grid (the shared
    assembly primitive): prepends the lane coordinate and returns
    [B, S, *shape] int32 sums. idx_cols/vals/mask are [L, K], L = B*S."""
    L = B * S
    lane = torch.arange(L, device=mask.device)[:, None].expand(mask.shape)
    out = _scatter_add((L,) + tuple(shape), [lane] + list(idx_cols), vals,
                       mask)
    return out.reshape((B, S) + tuple(shape))


def _assemble_cols(cols, B, S, n_ev, ovf, caps: SliceCaps):
    """Per-step emissions -> packed bitbuffers + summaries via
    scatter-adds (each 1-bit's target is unique, so add == or); the
    emissions as [L, steps] columns: is_bit, bitval, b_ev, b_row, b_bir,
    is_sync, s_ev, s_row, is_flush, f_ev, f_rows."""
    E, R, BY = caps
    (is_bit, bitval, b_ev, b_row, b_bir, is_sync, s_ev, s_row,
     is_flush, f_ev, f_rows) = cols

    def scat(shape, idx_cols, vals, mask):
        return _lane_scatter_add(B, S, shape, idx_cols, vals, mask)

    m_bit = is_bit.bool()
    bytes_ = scat((E, R, BY), [b_ev, b_row, b_bir // 8],
                  bitval * _bit(b_bir), m_bit)
    bits_per_row = scat((E, R), [b_ev, b_row], 1, m_bit)
    syncs = scat((E, R), [s_ev, s_row], 1, is_sync.bool())
    num_rows = scat((E,), [f_ev], f_rows, is_flush.bool())
    return {"bytes": bytes_.to(torch.uint8), "bits_per_row": bits_per_row,
            "syncs": syncs, "num_rows": num_rows, "n_events": n_ev,
            "ovf": ovf}


def _bit(pos):
    """The byte value of bit ``pos`` of a row (MSB first)."""
    return torch.ones_like(pos) << (7 - pos % 8)


# ---- the kernel's phases (csrc/slice.cu's groups): what no state decides,
# per step; MC's tsl walked per piece; PCM's rate pass in closed form and
# rounds; the cursors from running sums; the JAX assembly

# MC's pieces also end at a pulse or gap over 1.5 short widths where every
# width of the train is below _TAME and the short width below _SHORT_MAX
_TAME = 1 << 28
_SHORT_MAX = 1 << 26


def _lane_grid(pulse, gap, n_pulses, okm):
    """The [B, S, N] form of a call: pulse and gap [B, 1, N], the active
    steps (inside the train, on an ok spec; ``okm`` is [1, S, 1]) and the
    last step."""
    N = pulse.shape[1]
    i = torch.arange(N, device=pulse.device)[None, :]
    act = (i < n_pulses[:, None])[:, None, :] & okm
    last = (i == n_pulses[:, None] - 1)[:, None, :]
    return (pulse[:, None, :].to(torch.int32),
            gap[:, None, :].to(torch.int32), act, last)


def _csum(x):
    """Inclusive running sum along the pulses, int32."""
    return torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)


def _before(v):
    """The running max of ``v`` over the steps before each step (0 before
    the first): for a running sum that never decreases, kept where a reset
    happens and 0 elsewhere, its value at the last reset before the step."""
    out = torch.zeros_like(v)
    if v.shape[-1] > 1:
        out[..., 1:] = torch.cummax(v[..., :-1], -1).values
    return out


def slice_pwm_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the PWM scan (JAX ``slice_pwm``) in the kernel's
    phases, vectorized over pulses and lanes: each pulse's class and its
    gap's flush and break candidacy; a candidate flushes where something
    touched the event since the previous candidate; bir counts the bits
    since the last sync, row break or candidate, row the new rows since the
    last flush; the JAX assembly."""
    B, N = pulse.shape
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    S = b["reset"].shape[1]
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    # 1. what no state decides
    is1 = act & (b["one_l"] < p) & (p < b["one_u"])
    is0 = act & ~is1 & (b["zero_l"] < p) & (p < b["zero_u"])
    issy = act & ~is1 & ~is0 & (b["sync_l"] < p) & (p < b["sync_u"])
    isrb = act & ~is1 & ~is0 & ~issy & (p > b["one_l"])
    isbit = is1 | is0
    cf = act & ((g > b["reset"]) | last)
    cb = act & (b["gap"] > 0) & (g > b["gap"])
    # 2. nothing: no value carries across pulses
    # 3. the cursors
    touch = _csum(isbit | issy | isrb)
    fl = cf & (touch > _before(torch.where(cf, touch, 0)))
    ev = _csum(fl) - fl.to(torch.int32)
    bits = _csum(isbit)
    birb = bits - isbit.to(torch.int32) - _before(
        torch.where(issy | isrb | cf | cb, bits, 0))
    bir2 = torch.where(issy | isrb, 0, birb)
    bir3 = bir2 + isbit.to(torch.int32)
    up = (issy & (birb > 0)) | isrb
    brk = cb & ~fl & (bir3 > 0)
    inc = up.to(torch.int32) + brk.to(torch.int32)
    rows = _csum(inc)
    row2 = rows - inc - _before(torch.where(fl, rows, 0)) \
        + up.to(torch.int32)
    ovf = (act & ((ev + fl.to(torch.int32) >= E)
                  | (row2 + brk.to(torch.int32) >= R)
                  | (bir3 >= BY * 8))).any(-1)
    # 4. the JAX assembly
    L = B * S

    def lanes(x):
        return torch.broadcast_to(x, (B, S, N)).reshape(L, N)

    return _assemble_cols(
        [lanes(x) for x in (isbit, is1, ev, row2, bir2, issy, ev, row2, fl,
                            ev, row2 + 1)],
        B, S, fl.sum(-1, dtype=torch.int32), ovf, caps)


def slice_ppm_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the PPM scan (JAX ``slice_ppm``) in the kernel's
    phases, vectorized over gaps and lanes: each gap's class (0, 1, sync,
    row break) and its flush candidacy (at or over the reset limit, or the
    last pulse); a candidate flushes where a bit or a row break touched
    the event since the previous candidate, this gap included (one that
    does not flush finds every cursor at zero); bir counts the bits since
    the last sync, row break or candidate, row the new rows since the last
    candidate (a row break, or a sync after a bit, before the gap's bit);
    the JAX assembly."""
    B, N = pulse.shape
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    S = b["reset"].shape[1]
    _p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    # 1. what no state decides
    is0 = act & (b["zero_l"] < g) & (g < b["zero_u"])
    is1 = act & ~is0 & (b["one_l"] < g) & (g < b["one_u"])
    issy = act & ~is0 & ~is1 & (b["sync_l"] < g) & (g < b["sync_u"])
    isrb = act & ~is0 & ~is1 & ~issy & (g < b["reset"])
    isbit = is0 | is1
    cf = act & ((g >= b["reset"]) | last)
    # 2. nothing: no value carries across gaps but the cursors
    # 3. the cursors
    touch = _csum(isbit | isrb)
    fl = cf & (touch > _before(torch.where(cf, touch, 0)))
    ev = _csum(fl) - i32(fl)
    bits = _csum(isbit)
    birb = bits - i32(isbit) - _before(
        torch.where(issy | isrb | cf, bits, 0))
    bir2 = torch.where(issy | isrb, 0, birb)
    bir3 = bir2 + i32(isbit)
    up = (issy & (birb > 0)) | isrb
    ups = _csum(up)
    row2 = ups - _before(torch.where(cf, ups, 0))
    ovf = (act & ((ev + i32(fl) >= E) | (row2 >= R)
                  | (bir3 >= BY * 8))).any(-1)
    # 4. the JAX assembly
    L = B * S

    def lanes(x):
        return torch.broadcast_to(x, (B, S, N)).reshape(L, N)

    return _assemble_cols(
        [lanes(x) for x in (isbit, is1, ev, row2, bir2, issy, ev, row2, fl,
                            ev, row2 + 1)],
        B, S, fl.sum(-1, dtype=torch.int32), ovf, caps)


_F32 = torch.float32


def _trunc05(v):
    """int(v + 0.5) with trunc-toward-zero, plus a boundary flag wide
    enough to absorb float32-vs-float64 evaluation differences."""
    x = v + torch.tensor(0.5, dtype=_F32, device=v.device)
    n = torch.trunc(x).to(torch.int32)
    eps = torch.tensor(1e-6, dtype=_F32, device=v.device) \
        + x.abs() * torch.tensor(2e-6, dtype=_F32, device=v.device)
    near = (x - torch.round(x)).abs() < eps
    return n, near


def _shift(x):
    """``x`` one step later along the last axis (zero at the first)."""
    out = torch.zeros_like(x)
    out[..., 1:] = x[..., :-1]
    return out


def _at_last(v, mask):
    """The value of ``v`` at the last step before each step where ``mask``
    holds (0 where none does), along the last axis; ``v`` need not grow."""
    shape = torch.broadcast_shapes(v.shape, mask.shape)
    idx = torch.arange(shape[-1], device=v.device)
    j = _before(torch.where(mask, idx + 1, 0).expand(shape))
    vz = torch.cat([torch.zeros(shape[:-1] + (1,), dtype=v.dtype,
                                device=v.device), v.expand(shape)], -1)
    return torch.gather(vz, -1, j)


def _pcm_rates(pulse, gap, n_pulses, b):
    """Pass 1 (JAX ``_pcm_rates``) in the kernel's form: the preamble
    estimator's runs and acceptances, then the order-free fallbacks;
    ``b`` holds [1, S, 1] bound columns. Returns fs, fl [B, S, 1] and the
    float-boundary flag [B, S].

    A run ends at a pulse out of the run class after one in it (one step
    past the train's end ends a run still open there) and is accepted where
    its count reaches mc, which only an acceptance moves, to that run's
    count. RZ's class reads no state, so its acceptances have a closed
    form: every run end whose count reaches mc0 and every earlier end's; fs
    and fl come from the last accepted run whose width sum is positive.
    NRZ's class reads the running fs and fl: each round classifies the
    pulses not yet final with the rates in force and takes the first
    acceptance among them, which makes every pulse up to it final (the
    flag counts there) and gives the rates of the next round."""
    B, N = pulse.shape
    dev = pulse.device
    w = torch.where
    sh, lo, tol, is_rz = b["short"], b["long"], b["tol"], b["is_rz"]
    S = sh.shape[1]
    pad = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    p = torch.cat([pulse.to(torch.int32), pad], 1)[:, None, :]
    g = torch.cat([gap.to(torch.int32), pad], 1)[:, None, :]
    idx = torch.arange(N + 1, device=dev)
    valid = (idx[None, :] < n_pulses[:, None])[:, None, :]
    c_rz = valid & ((p >= sh - tol) & (p <= sh + tol)
                    & (p + g >= lo - tol) & (p + g <= lo + tol))
    dc = w(is_rz, 1, 2).to(torch.int32)
    v_sw = w(is_rz, p, p + g)
    fs = b["f0s"].expand(B, S, 1)
    fl = b["f0l"].expand(B, S, 1)
    mc = b["min_count"].expand(B, S, 1)
    plen = torch.zeros((B, S, 1), dtype=torch.int32, device=dev)
    flag = torch.zeros((B, S, 1), dtype=torch.bool, device=dev)
    start = torch.zeros((B, S, 1), dtype=torch.int64, device=dev)
    open_ = torch.ones((B, S, 1), dtype=torch.bool, device=dev)
    c = torch.zeros((B, S, N + 1), dtype=torch.bool, device=dev)
    gat = lambda x, k: torch.gather(x, -1, k.clamp(min=0))

    def run_sum(v, c, j):
        # the sum of v over the run that ends before each step (from step
        # j on), wrapped as the scan's int32 sums wrap
        cs = torch.cumsum(w(c, v, 0).to(torch.int64), -1)
        ex = _shift(cs)
        return (ex - torch.gather(ex, -1, j)).to(torch.int32)

    while True:
        hp, near_p = _trunc05(p.to(_F32) * fs)
        hg, near_g = _trunc05(g.to(_F32) * fl)
        spec = open_ & (idx >= start)
        c = w(spec, valid & w(is_rz, c_rz, (hp == 1) & (hg == 1)), c)
        ff = valid & ~is_rz & ((near_p & (hp <= 2)) | (near_g & (hg <= 2)))
        # the run that ends before each step
        ended = _shift(c) & ~c
        j = _before(w(c, 0, idx + 1))
        cnt = (idx - j).to(torch.int32) * dc
        sw = run_sum(v_sw, c, j)
        lw = run_sum(p + g, c, j)
        # RZ: every end whose count reaches every earlier end's and mc;
        # NRZ: the first end (not yet final) whose count reaches mc
        pm = _before(w(ended, cnt, torch.iinfo(torch.int32).min))
        acc = spec & ended & (cnt >= w(is_rz, torch.maximum(mc, pm), mc))
        acc = acc & (is_rz | (_csum(acc) == 1))
        hit = acc.any(-1, keepdim=True)
        k = w(acc, idx, -1).amax(-1, keepdim=True)
        final = spec & (is_rz | ~hit | (idx <= k))
        flag = flag | (ff & final).any(-1, keepdim=True)
        ks = w(acc & (sw > 0), idx, -1).amax(-1, keepdim=True)
        kl = w(acc & (lw > 0), idx, -1).amax(-1, keepdim=True)
        fs2 = w(ks >= 0, gat(cnt, ks).to(_F32) / gat(sw, ks).to(_F32), fs)
        fl2 = w(is_rz, w(kl >= 0, gat(cnt, kl).to(_F32)
                         / gat(lw, kl).to(_F32), fl), fs2)
        fs, fl = w(hit, fs2, fs), w(hit, fl2, fl)
        mc = w(hit, gat(cnt, k), mc)
        plen = w(hit, gat(cnt, k), plen)
        start = w(hit, k + 1, start)
        open_ = hit & ~is_rz
        if not bool(open_.any()):
            break

    # fallbacks (anywhere-in-stream, order-free)
    isum = lambda x: x.sum(-1, keepdim=True, dtype=torch.int32)
    rzc = isum(c_rz)
    rzs = isum(w(c_rz, p, 0))
    rzl = isum(w(c_rz, p + g, 0))
    use_rzfb = is_rz & (plen == 0) & (rzc > 8)
    fs = w(use_rzfb, rzc.to(_F32) / rzs.clamp(min=1).to(_F32), fs)
    fl = w(use_rzfb, rzc.to(_F32) / rzl.clamp(min=1).to(_F32), fl)
    # NRZ fallback: four independent windows, each pulse/gap may add twice
    w1 = valid & (p >= sh - tol) & (p <= sh + tol)
    w2 = valid & (p >= 2 * sh - tol) & (p <= 2 * sh + tol)
    w3 = valid & (g >= lo - tol) & (g <= lo + tol)
    w4 = valid & (g >= 2 * lo - tol) & (g <= 2 * lo + tol)
    nw = (isum(w(w1, p, 0)) + isum(w(w2, p, 0)) + isum(w(w3, g, 0))
          + isum(w(w4, g, 0)))
    nc = isum(w1) + 2 * isum(w2) + isum(w3) + 2 * isum(w4)
    use_nrzfb = ~is_rz & (plen == 0) & (nc > 20)
    fnrz = nc.to(_F32) / nw.clamp(min=1).to(_F32)
    return w(use_nrzfb, fnrz, fs), w(use_nrzfb, fnrz, fl), flag[..., 0]


def _runs_to_bits(lead, starts, lens, mask, width, BITS):
    """Runs of 1-bits (``lens`` long from ``starts``, where ``mask``) into
    a packed [*lead_shape, BITS // 8] uint8 plane: +1/-1 deltas at the
    clipped run ends, a cumulative sum, bytes. ``lead`` is the list of
    leading index columns with their sizes in ``width``."""
    delta_shape = tuple(width) + (BITS + 1,)
    a = _scatter_add(delta_shape, lead + [starts.clamp(0, BITS)], 1, mask)
    b = _scatter_add(delta_shape, lead + [(starts + lens).clamp(0, BITS)], 1,
                     mask)
    ind = (torch.cumsum(a - b, dim=-1)[..., :BITS] > 0).to(torch.int32)
    wts = _bit(torch.arange(8, dtype=torch.int32, device=ind.device))
    return (ind.reshape(delta_shape[:-1] + (BITS // 8, 8)) * wts).sum(-1)\
        .to(torch.uint8)


def _next_at(mask):
    """The first step at or after each step where ``mask`` holds (the
    axis' length where none does), along the last axis."""
    N = mask.shape[-1]
    idx = torch.arange(N, device=mask.device)
    x = torch.where(mask, idx, N).flip(-1)
    return torch.cummin(x, -1).values.flip(-1)


def slice_pcm_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the PCM scan (JAX ``slice_pcm``) in the kernel's
    phases, vectorized over pulses and lanes: the rate pass
    (:func:`_pcm_rates`); with the rates fixed, each pulse's ones and
    zeros, clear and row break; clears and flush candidates reset the
    cursors, and a candidate flushes where bits or a row break touched the
    event since the last reset, this pulse included (one that does not
    finds every cursor at zero); row counts the breaks, bir the bits since
    the last reset or break; ``bitbuffer_clear`` keeps a pulse's run where
    the first reset at or after it is a flush (the last pulse is a
    candidate); float32 roundings near a boundary flagged; the JAX
    assembly (variable bits per pulse as runs)."""
    B, N = pulse.shape
    dev = pulse.device
    E, R, BY = caps
    BITS = BY * 8
    b = {k: v[..., None] for k, v in _cols(bounds, dev).items()}
    S = b["short"].shape[1]
    sh, lo, rst, gpl = b["short"], b["long"], b["reset"], b["gap_limit"]
    tol, mz, is_rz = b["tol"], b["max_zeros"], b["is_rz"]
    fs, fl, flag = _pcm_rates(pulse, gap, n_pulses, b)
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    w = torch.where
    i32 = lambda x: x.to(torch.int32)
    # 1. what no state decides, the rates fixed
    h, near_h = _trunc05(p.to(_F32) * fs)
    l0, near_l = _trunc05((g + sh - lo).to(_F32) * fl)
    near = act & (near_h | (near_l & (l0 <= mz + 1)))
    h = w(act, h.clamp(min=0), 0)
    d = w(act, h + torch.minimum(l0.clamp(min=0), mz), 0)
    clr = act & is_rz & ((p - sh).abs() > tol)
    brk = act & ~clr & (g > gpl) & (g <= rst)
    cand = act & ((g > rst) | last)
    rs = clr | cand
    # 3. the cursors
    tm = _csum((d > 0) | brk)
    fl_ = cand & ~clr & (tm > _at_last(tm, rs))
    ev = _csum(fl_) - i32(fl_)
    ks = _csum(brk)
    row = ks - i32(brk) - _at_last(ks, rs)
    run = torch.cumsum(d.to(torch.int64), -1)
    bir = (run - d - _at_last(run, rs | brk)).to(torch.int32)
    row2 = w(clr, 0, row + i32(brk))
    ovf = (act & (near | (ev + i32(fl_) >= E) | (torch.maximum(row2, row) >= R)
                  | (bir + d >= BITS))).any(-1) | flag
    # the erase: a run is kept where the first reset at or after it flushes
    nxt = _next_at(rs)
    keep = torch.gather(torch.cat([fl_, torch.zeros_like(fl_[..., :1])], -1),
                        -1, nxt)
    live = act & keep & (d > 0)
    # 4. the JAX assembly
    L = B * S

    def lanes(x):
        return torch.broadcast_to(x, (B, S, N)).reshape(L, N)

    lane = torch.arange(L, device=dev)[:, None].expand(L, N)
    bytes_ = _runs_to_bits([lane, lanes(ev), lanes(row)], lanes(bir),
                           lanes(h), lanes(live & (h > 0)), (L, E, R),
                           BITS).reshape(B, S, E, R, BY)
    bits_per_row = _lane_scatter_add(B, S, (E, R), [lanes(ev), lanes(row)],
                                     lanes(d), lanes(live))
    num_rows = _lane_scatter_add(B, S, (E,), [lanes(ev)], lanes(row2 + 1),
                                 lanes(fl_))
    syncs = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    return {"bytes": bytes_, "bits_per_row": bits_per_row, "syncs": syncs,
            "num_rows": num_rows, "n_events": fl_.sum(-1, dtype=torch.int32),
            "ovf": ovf}


def _mc_tsl(p, g, act, out, fl, sh, tame):
    """MC phase 2: c1_mid and c3 per step from tsl, walked once per piece:
    a piece starts where tsl is 0 (the train's first step, after a gap that
    flushes or, where the train is tame, exceeds 1.5 short widths) or does
    not matter (a pulse that is out or, tame, exceeds them); its k-th steps
    are walked together."""
    Bn, S, N = act.shape
    vf = tame[:, None, None] & (sh >= 0) & (sh < _SHORT_MAX)
    pf = out | (vf & (2 * p > 3 * sh))
    gf = fl | (vf & (2 * g > 3 * sh))
    prev = torch.ones_like(gf)
    prev[..., 1:] = gf[..., :-1]
    start = act & (pf | prev)
    idx = torch.arange(N, device=act.device).expand(Bn, S, N)
    pos = (idx - torch.cummax(torch.where(start, idx, -1), -1).values)
    flat = lambda x: torch.broadcast_to(x, (Bn, S, N)).reshape(-1)
    p_, g_, sh_, out_, fl_ = (flat(x) for x in (p, g, sh, out, fl))
    c1m = torch.zeros(Bn * S * N, dtype=torch.bool, device=act.device)
    c3 = torch.zeros_like(c1m)
    ts = torch.zeros(Bn * S * N, dtype=torch.int32, device=act.device)
    ix = flat(act).nonzero().squeeze(1)
    k_of = flat(pos)[ix]
    order = torch.argsort(k_of, stable=True)
    counts = torch.bincount(k_of, minlength=1).tolist() if len(ix) else []
    for k, at in enumerate(ix[order].split(counts)):
        a = (ts[at - 1] if k else 0) + p_[at]
        o = out_[at]
        x1 = ~o & (2 * a > 3 * sh_[at])
        bb = torch.where(o | x1, 0, a) + g_[at]
        f = fl_[at]
        x3 = ~f & (2 * bb > 3 * sh_[at])
        ts[at] = torch.where(f | x3, 0, bb)
        c1m[at], c3[at] = x1, x3
    return c1m.reshape(Bn, S, N), c3.reshape(Bn, S, N)


def slice_mc_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the Manchester-zerobit scan (JAX ``slice_mc``) in
    the kernel's phases, vectorized over pulses and lanes: out, the resync
    1 and the flush per pulse; the mid-bit 1 and 0 from tsl walked per
    piece (:func:`_mc_tsl`); row counts the outs since the last flush, bir
    the bits since the last out or flush; the JAX assembly: every buffer
    starts with a hardcoded 0 bit, up to three bits per pulse (sync-resync
    1, post-row 0, mid-bit 1/0)."""
    B, N = pulse.shape
    dev = pulse.device
    E, R, BY = caps
    BITS = BY * 8
    b = {k: v[..., None] for k, v in _cols(bounds, dev).items()}
    S = b["short"].shape[1]
    sh, rst, tol = b["short"], b["reset"], b["tol"]
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    # 1. what no state decides
    out = act & b["has_tol"].bool() & ((p < sh - tol) | (p > 2 * sh + tol)
                                | (g < sh - tol) | (g > 2 * sh + tol))
    c1o = out & (2 * p > 3 * sh) & (p <= 2 * sh + tol)
    fl = act & ((g > rst) | last)
    # 2. tsl
    inside = torch.arange(N, device=dev)[None, :] < n_pulses[:, None]
    tame = (((pulse >= 0) & (pulse < _TAME) & (gap >= 0) & (gap < _TAME))
            | ~inside).all(-1)
    c1m, c3 = _mc_tsl(p, g, act, out, fl, sh, tame)
    c1 = c1o | c1m
    # 3. the cursors
    i32 = lambda x: x.to(torch.int32)
    ev = _csum(fl) - i32(fl)
    outs = _csum(out)
    row2 = outs - _before(torch.where(fl, outs, 0))
    row = row2 - i32(out)
    x, y = _csum(c1), _csum(c3)
    z = x + y - i32(c3)
    bir = 1 + z - i32(c1) - _before(torch.where(out | fl, z, 0))
    bir2 = bir + i32(c1)
    bir4 = torch.where(out, 1, bir2) + i32(c3)
    ovf = (act & ((row2 >= R) | (bir4 > BITS) | (bir2 > BITS)
                  | (fl & (ev + 1 >= E)))).any(-1)
    # 4. the JAX assembly
    L = B * S

    def lanes(*xs):
        return torch.cat([torch.broadcast_to(x, (B, S, N)).reshape(L, N)
                          for x in xs], dim=1)

    bits_per_row = _lane_scatter_add(
        B, S, (E, R), [lanes(ev, ev, ev, ev + 1),
                       lanes(row, row2, row2, torch.zeros_like(row))], 1,
        lanes(c1, out, c3, fl))    # flush: the next event's leading 0
    # event 0's hardcoded leading 0
    bits_per_row[:, :, 0, 0] += b["ok"][..., 0].to(torch.int32)
    bytes_ = _lane_scatter_add(B, S, (E, R, BY), [lanes(ev), lanes(row),
                                                  lanes(bir) // 8],
                               _bit(lanes(bir)), lanes(c1))
    num_rows = _lane_scatter_add(B, S, (E,), [lanes(ev)], lanes(row2 + 1),
                                 lanes(fl))
    syncs = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    return {"bytes": bytes_.to(torch.uint8), "bits_per_row": bits_per_row,
            "syncs": syncs, "num_rows": num_rows,
            "n_events": fl.sum(-1, dtype=torch.int32), "ovf": ovf}


# ---- the phase form of DMC and PIWM-DC (csrc/slice.cu's groups over the
# symbol axis)

def _symbol_grid(pulse, gap, n_pulses, okm):
    """The [B, S, 2N] form of a call over the interleaved pulse/gap symbol
    axis (symbol 2k is pulse k, 2k + 1 gap k): the symbols [B, 1, 2N], the
    active steps (inside the train, on an ok spec; ``okm`` is [1, S, 1])
    and the last step."""
    B, N = pulse.shape
    sym = torch.stack([pulse, gap], -1).reshape(B, 2 * N).to(torch.int32)
    i = torch.arange(2 * N, device=pulse.device)[None, :]
    act = (i < 2 * n_pulses[:, None])[:, None, :] & okm
    last = (i == 2 * n_pulses[:, None] - 1)[:, None, :]
    return sym[:, None, :], act, last


def _symbol_planes(isbit, one, ev, row, bir, fl, f_rows, n_ev, ovf, caps):
    """The JAX assembly of a symbol family's [B, S, 2N] emissions (no
    syncs)."""
    B, S, M = isbit.shape
    cols = [torch.broadcast_to(x, (B, S, M)).reshape(B * S, M)
            for x in (isbit, one, ev, row, bir, torch.zeros_like(isbit), ev,
                      row, fl, ev, f_rows)]
    return _assemble_cols(cols, B, S, n_ev, ovf, caps)


def slice_dmc_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the differential-Manchester scan (JAX
    ``slice_dmc``) in the kernel's phases, vectorized over symbols and
    lanes. The carried ``pending`` flag has a closed form: a pending
    symbol that falls through (mistimed, at a reset) is never in_short, so
    every resolution but a 1 clears the flag and pend' = in_short & ~pend;
    pend is the parity of the run of in_short symbols that ends just
    before the symbol (from the index of the last one that is not). Then a
    flush candidate (a normal symbol out of both classes at a reset)
    flushes where a bit fell since the previous one; a break candidate (a
    pending mistimed symbol below the reset) breaks where a bit fell since
    the previous break or flush candidate; bir counts the bits since
    either, row the breaks since the last flush; the JAX assembly."""
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    sym, act, _last = _symbol_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    # 1. what no state decides
    d_short = (sym - b["short"]).abs()
    in_short = d_short < b["tol"]
    in_long = (sym - b["long"]).abs() < b["tol"]
    is_rst = sym >= b["reset"] - b["tol"]
    mist = d_short > b["tol"]
    # 2. the pending flag: the run of in_short symbols before each symbol
    IS = act & in_short
    idx = torch.arange(sym.shape[-1], device=sym.device, dtype=torch.int32)
    pend = ((idx - _before(torch.where(IS, 0, idx + 1))) & 1).bool()
    # 3. what it decides, and the cursors
    norm = act & (~pend | (mist & is_rst))
    one = act & ~pend & in_short
    isbit = one | (norm & ~in_short & in_long)
    fc = norm & ~in_short & ~in_long & is_rst
    bc = act & pend & mist & ~is_rst
    bits = _csum(isbit)
    fl = fc & (bits > _before(torch.where(fc, bits, 0)))
    bir = bits - i32(isbit) - _before(torch.where(fc | bc, bits, 0))
    brk = bc & (bir > 0)
    ev = _csum(fl) - i32(fl)
    brks = _csum(brk)
    row = brks - i32(brk) - _before(torch.where(fl, brks, 0))
    ovf = (act & ((row + i32(brk) >= R) | (bir + i32(isbit) > BY * 8)
                  | (fl & (ev + 1 >= E)))).any(-1)
    # 4. the JAX assembly
    return _symbol_planes(isbit, one, ev, row, bir, fl, row + 1,
                          fl.sum(-1, dtype=torch.int32), ovf, caps)


def slice_piwm_dc_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the PIWM-DC scan (JAX ``slice_piwm_dc``) in the
    kernel's phases, vectorized over symbols and lanes: a symbol in the
    short class is a 1, in the long class a 0; a flush candidate (over the
    reset limit, or the last symbol) flushes where a bit fell since the
    previous one, this symbol's included; a non-bit symbol below the reset
    limit is a break candidate and breaks where a bit fell since the
    previous candidate of either kind; bir counts the bits since either,
    row the breaks since the last flush (a break before a flush on the
    same symbol is that event's last row); the JAX assembly."""
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    sym, act, last = _symbol_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    # 1. what no state decides
    in1 = act & ((sym - b["short"]).abs() < b["tol"])
    isbit = in1 | (act & ((sym - b["long"]).abs() < b["tol"]))
    rbc = act & ~isbit & (sym < b["reset"])
    cf = act & ((sym > b["reset"]) | last)
    # 2. nothing: no value carries across symbols but the cursors
    # 3. the cursors
    bits = _csum(isbit)
    fl = cf & (bits > _before(torch.where(cf, bits, 0)))
    bir = bits - i32(isbit) - _before(torch.where(cf | rbc, bits, 0))
    isrb = rbc & (bir > 0)
    ev = _csum(fl) - i32(fl)
    rbs = _csum(isrb)
    row2 = rbs - _before(torch.where(fl, rbs, 0))
    ovf = (act & ((row2 >= R) | (bir + i32(isbit) > BY * 8)
                  | (fl & (ev + 1 >= E)))).any(-1)
    # 4. the JAX assembly
    return _symbol_planes(isbit, in1, ev, row2 - i32(isrb), bir, fl,
                          row2 + 1, fl.sum(-1, dtype=torch.int32), ovf, caps)


def _assemble_runs(B, S, caps: SliceCaps, cols, ev_f, ovf):
    """Shared assembly for slicers that only ever write row 0: per-step
    runs of ``ones`` 1-bits at ``start`` followed by ``zeros`` 0-bits,
    packed by the same delta-scatter and cumulative sum as PCM. ``cols``
    holds (ones, zeros, b_ev, start, flush, f_ev, f_rows) as [L, steps]
    columns."""
    E, R, BY = caps
    BITS = BY * 8
    L = B * S
    dev = ev_f.device
    hl, zl, ev_l, sl, flush, f_ev, f_rows = (c.to(dev) for c in cols)
    lane = torch.arange(L, device=dev)[:, None].expand(hl.shape)
    row0 = _runs_to_bits([lane, ev_l], sl, hl, hl > 0, (L, E), BITS)
    bytes_ = torch.zeros((B, S, E, R, BY), dtype=torch.uint8, device=dev)
    bytes_[:, :, :, 0, :] = row0.reshape(B, S, E, BY)
    bits_per_row = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    bits_per_row[:, :, :, 0] = _lane_scatter_add(B, S, (E,), [ev_l], hl + zl,
                                                 hl + zl > 0)
    num_rows = _lane_scatter_add(B, S, (E,), [f_ev], f_rows, flush.bool())
    syncs = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    return {"bytes": bytes_, "bits_per_row": bits_per_row, "syncs": syncs,
            "num_rows": num_rows, "n_events": ev_f, "ovf": ovf}


def slice_nrzs_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the NRZS scan (JAX ``slice_nrzs``) in the kernel's
    phases, vectorized over pulses and lanes: a pulse longer than the bit
    limit emits ``pulse // limit`` ones then a zero, a shorter one a zero,
    an exact-limit one nothing; every reset gap (or the final pulse) is a
    flush candidate and flushes, empty events included; the cursor is the
    running sum of the bits minus its value at the last candidate; the
    JAX assembly."""
    B, N = pulse.shape
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    S = b["short"].shape[1]
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    sh = b["short"]
    # 1. what no state decides
    h = torch.where(act & (p > sh), torch.div(p, sh.clamp(min=1),
                                              rounding_mode="floor"), 0)
    z = i32(act & (p != sh))
    fc = act & ((g >= b["reset"]) | last)
    # 2. the cursor before each pulse (summed in int64, then wrapped as the
    # scan's int32 cursor wraps) and its event
    d = h + z
    run = torch.cumsum(d.to(torch.int64), -1)
    bir = (run - d - _at_last(run, fc)).to(torch.int32)
    ev = _csum(fc) - i32(fc)
    ovf = (act & ((bir + d > BY * 8) | (fc & (ev + 1 >= E)))).any(-1)
    # 3. the JAX assembly
    L = B * S

    def lanes(x):
        return torch.broadcast_to(x, (B, S, N)).reshape(L, N)

    return _assemble_runs(
        B, S, caps, [lanes(x) for x in (h, z, ev, bir, fc, ev,
                                        i32(bir + d > 0))],
        fc.sum(-1, dtype=torch.int32), ovf)


# ---- the phase form of RZI and OSV1 (csrc/slice.cu's groups, a pulse per
# thread)

def slice_rzi_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the RZI scan (JAX ``slice_rzi``) in the kernel's
    phases, vectorized over pulses and lanes: each pulse emits
    ``round(high / long)`` ones (the first pulse of a message, after a
    flush candidate or at the train's start, without the base offset),
    each sub-reset gap a zero; a reset gap or the final pulse is a flush
    candidate, which flushes where the event holds a bit. The cursor is
    the running sum of the bits minus its value at the last candidate (a
    candidate that does not flush finds it at zero); the JAX assembly."""
    B, N = pulse.shape
    E, R, BY = caps
    b = {k: v[..., None] for k, v in _cols(bounds, pulse.device).items()}
    S = b["long"].shape[1]
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    lo = b["long"]
    half = torch.div(lo, 2, rounding_mode="floor")
    # 1. what no state decides
    fc = act & ((g > b["reset"]) | last)
    at_start = torch.ones_like(fc)
    at_start[..., 1:] = fc[..., :-1]
    num = torch.where(at_start, p + half, p - b["base"] + half)
    ones = torch.where(act, torch.div(num, lo.clamp(min=1),
                                      rounding_mode="floor").clamp(min=0), 0)
    zz = i32(act & ~fc)
    # 2. the cursor before each pulse: the bits since the last candidate
    # (summed in int64, then wrapped as the scan's int32 cursor wraps)
    d = ones + zz
    run = torch.cumsum(d.to(torch.int64), -1)
    bir = (run - d - _before(torch.where(fc, run, 0))).to(torch.int32)
    emitted = fc & (bir + ones > 0)
    ev = _csum(emitted) - i32(emitted)
    ovf = (act & ((bir + ones + zz > BY * 8)
                  | (emitted & (ev + 1 >= E)))).any(-1)
    # 3. the JAX assembly
    L = B * S

    def lanes(x):
        return torch.broadcast_to(x, (B, S, N)).reshape(L, N)

    return _assemble_runs(
        B, S, caps, [lanes(x) for x in (ones, zz, ev, bir, emitted, ev,
                                        torch.ones_like(ev))],
        emitted.sum(-1, dtype=torch.int32), ovf)


# OSV1's preamble: pulses 0 to _OSV1_PREAMBLE - 1, the sync the next
# (csrc/slice.cu kPreamble)
_OSV1_PREAMBLE = 12


def slice_osv1_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the OSv1 scan (JAX ``slice_osv1``) in the kernel's
    phases, vectorized over pulses and lanes. The phase machine has a
    closed form: phase 0 leads to phase 1 only where pulses 0-10 pass
    with their gap at most 1.5 short widths and pulse 11 passes with a
    longer gap, so phase 1 is pulse 12; it passes into phase 2 (with a 0
    and the Manchester bit set where its gap is the longer) or ends the
    lane. Phase 2 runs from pulse 13 to the first flush candidate (the
    event is always touched there). The Manchester bit before a phase-2
    pulse is its start value XOR the parity of the earlier phase-2 pulses
    whose pulse and gap disagree on being long; the cursor counts the 0 of
    the sync and every bit since. At most one event, all bits in row 0;
    the JAX assembly scatter-adds each 1 at its position clipped to the
    row's last bit (the clipped ones add up in the last byte)."""
    B, N = pulse.shape
    E, R, BY = caps
    BITS = BY * 8
    dev = pulse.device
    K = _OSV1_PREAMBLE
    if N <= K:      # steps past the train are inactive
        pad = torch.zeros((B, K + 1 - N), dtype=pulse.dtype, device=dev)
        pulse, gap = torch.cat([pulse, pad], 1), torch.cat([gap, pad], 1)
    b = {k: v[..., None] for k, v in _cols(bounds, dev).items()}
    S = b["short"].shape[1]
    sh = b["short"]
    hmin = torch.div(sh, 2, rounding_mode="floor")
    hmax = torch.div(sh * 3, 2, rounding_mode="floor")
    sync_min = 2 * hmax
    p, g, act, last = _lane_grid(pulse, gap, n_pulses, b["ok"])
    i32 = lambda x: x.to(torch.int32)
    # 1. the preamble and the sync: what no state decides
    pass0 = act & (p > hmin) & (g > hmin)
    pre = (pass0 & (g <= hmax))[..., :K - 1].all(-1) \
        & (pass0 & (g > hmax))[..., K - 1]
    ps, gs = p[..., K], g[..., K]
    sync = pre & act[..., K] & (ps >= sync_min[..., 0]) \
        & (gs >= sync_min[..., 0])
    sync0 = i32(sync & (gs > ps))[..., None]
    # 2. phase 2, from pulse 13 up to and with the first flush candidate
    idx = torch.arange(p.shape[-1], device=dev)
    cand = act & (idx > K) & sync[..., None]
    fc = cand & (last | (g > b["reset"]))
    ph2 = cand & (_csum(fc) - i32(fc) == 0)
    flush = fc & ph2
    phit, ghit = p > hmax, g > hmax
    x = i32(ph2 & (phit ^ ghit))
    m = sync0 ^ ((_csum(x) - x) & 1)
    c1 = ph2 & (phit | (m == 0))
    mp = torch.where(phit, m, 1 - m)
    c0 = ph2 & ~flush & (ghit | (mp == 0))
    # 3. the cursor before each pulse's 1
    bits = i32(c1) + i32(c0)
    pos = sync0 + _csum(bits) - bits
    nbits = sync0[..., 0] + bits.sum(-1, dtype=torch.int32)
    # 4. the JAX assembly
    L = B * S
    M = p.shape[-1]

    def lanes(x):
        return torch.broadcast_to(x, (B, S, M)).reshape(L, M)

    bp = lanes(pos).clamp(0, BITS - 1)
    row0 = _lane_scatter_add(B, S, (BY,), [bp // 8], _bit(bp), lanes(c1))
    bytes_ = torch.zeros((B, S, E, R, BY), dtype=torch.uint8, device=dev)
    bytes_[:, :, 0, 0, :] = row0.to(torch.uint8)
    bits_per_row = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    bits_per_row[:, :, 0, 0] = nbits
    n_ev = i32(flush.any(-1))
    num_rows = torch.zeros((B, S, E), dtype=torch.int32, device=dev)
    num_rows[:, :, 0] = n_ev
    syncs = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    return {"bytes": bytes_, "bits_per_row": bits_per_row, "syncs": syncs,
            "num_rows": num_rows, "n_events": n_ev, "ovf": nbits > BITS}


PLAIN = {"ppm": slice_ppm_plain, "pwm": slice_pwm_plain,
         "pcm": slice_pcm_plain, "mc": slice_mc_plain,
         "dmc": slice_dmc_plain, "piwm_dc": slice_piwm_dc_plain,
         "nrzs": slice_nrzs_plain, "rzi": slice_rzi_plain,
         "osv1": slice_osv1_plain}


# ---------------------------------------------------------------------------
# the kernel (csrc/slice.cu) and the wrappers
# ---------------------------------------------------------------------------

def _check(pulse, gap, n_pulses, caps):
    if pulse.dim() != 2 or gap.shape != pulse.shape:
        raise ValueError("slice: pulse and gap must be [B, N]")
    if n_pulses.shape != (pulse.shape[0],):
        raise ValueError("slice: n_pulses must be [B]")
    if any(t.dtype != torch.int32 for t in (pulse, gap, n_pulses)):
        raise ValueError("slice: pulse, gap and n_pulses must be int32")
    if min(caps) < 1:
        raise ValueError(f"slice: caps must be positive, not {caps}")


# the slicer kernel's shared memory: a block may use 227 KB of an SM's
# 228 KB, and each resident block takes 1 KB more
SMEM_MAX = 232448
SMEM_SM = 233472
# csrc/slice.cu runs every family as thread groups, a group per lane; DMC
# and PIWM-DC step over the 2N symbols of the interleaved pulse/gap axis
GROUP_FAMILIES = tuple(FAMILIES)
SYMBOL_FAMILIES = ("dmc", "piwm_dc")


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def stage_bytes(caps: SliceCaps) -> int:
    """Shared bytes of one lane's stage in ``csrc/slice.cu``: its events'
    rows padded to 4-byte words, then their bits_per_row, syncs and
    num_rows, each part rounded up to 16 bytes; the stride between lanes
    is made an odd multiple of 16 so that the 16-byte accesses of eight
    neighbouring lanes fall in distinct banks."""
    E, R, BY = (int(c) for c in caps)
    sb = _r16(E * R * -(-BY // 4) * 4) + _r16(8 * E * R) + _r16(4 * E)
    return sb + 16 if sb % 32 == 0 else sb


def launch_plan(S: int, N: int, caps: SliceCaps, fam: str):
    """The slicer kernel's launch for trains of N pulses and S specs of
    family ``fam``: (lanes per block, threads per lane, stage bytes per
    lane, shared bytes per block); a block takes one train's pulses and
    gaps (``8 N`` bytes) and its lanes' stages.

    The threads per lane follow the lane's steps (N pulses, or 2N
    symbols for DMC and PIWM-DC): 8 where they are at most 8, 16 where at
    most 16, else a warp; up to four warps of lanes per block (fewer where
    S is smaller), each lane staging every event, so that several blocks
    share an SM; fewer warps, and then a warp per lane, where that does
    not fit the 227 KB a block may use, raising where one lane of a warp
    does not."""
    sb = stage_bytes(caps)
    pulses = _r16(8 * N)
    steps = 2 * N if fam in SYMBOL_FAMILIES else N
    g0 = 8 if steps <= 8 else 16 if steps <= 16 else 32
    for g in dict.fromkeys((g0, 32)):
        per_warp = 32 // g
        for warps in range(min(4, max(1, -(-S // per_warp))), 0, -1):
            smem = pulses + warps * per_warp * sb
            if smem <= SMEM_MAX:
                return warps * per_warp, g, sb, smem
    raise ValueError(f"slice: caps {tuple(caps)} with N={N} pulses do not "
                     f"fit one block's shared memory")


def slice_cuda(fam: str, pulse, gap, n_pulses, bounds,
               caps: SliceCaps = SliceCaps()) -> dict:
    """Launch ``csrc/slice.cu`` for family ``fam``; same contract as the
    family's plain version (``bounds`` as its ``<fam>_bounds`` gives them,
    or already packed by :func:`bound_table`). The kernel writes every
    element of the outputs, so they are allocated uninitialized."""
    _check(pulse, gap, n_pulses, caps)
    dev = pulse.device
    if not all(t.is_cuda and t.device == dev for t in (gap, n_pulses)) \
            or not pulse.is_cuda:
        raise ValueError("slice: pulse, gap and n_pulses must be CUDA "
                         "tensors on one device")
    pulse, gap, n_pulses = (t.contiguous() for t in (pulse, gap, n_pulses))
    tab = bounds if isinstance(bounds, torch.Tensor) \
        else torch.from_numpy(bound_table(fam, bounds))
    tab = tab.to(dev, torch.int32).contiguous()
    if tab.dim() != 2 or tab.shape[1] != NCOLS:
        raise ValueError(f"slice: the bound table must be [S, {NCOLS}]")
    B, N = pulse.shape
    S = tab.shape[0]
    E, R, BY = (int(c) for c in caps)
    lanes, group, sb, smem = launch_plan(S, N, caps, fam)
    e = lambda *sh, dt=torch.int32: torch.empty(sh, dtype=dt, device=dev)
    out = {"bytes": e(B, S, E, R, BY, dt=torch.uint8),
           "bits_per_row": e(B, S, E, R), "syncs": e(B, S, E, R),
           "num_rows": e(B, S, E), "n_events": e(B, S),
           "ovf": e(B, S, dt=torch.uint8)}
    if B and S:
        fn = _cuda.launcher("slice")
        with _cuda.launch_device(pulse):
            _cuda.LAUNCHES["slice_" + fam] += 1
            err = fn(FAMILIES[fam][0], pulse.data_ptr(), gap.data_ptr(),
                     n_pulses.data_ptr(), B, N, tab.data_ptr(), S, E, R, BY,
                     lanes, group, sb, smem, out["bytes"].data_ptr(),
                     out["bits_per_row"].data_ptr(), out["syncs"].data_ptr(),
                     out["num_rows"].data_ptr(), out["n_events"].data_ptr(),
                     out["ovf"].data_ptr(), _cuda.stream_of(pulse))
        _cuda.check(err, "slice_" + fam)
    out["ovf"] = out["ovf"].view(torch.bool)
    return out


def _wrapper(fam):
    plain = PLAIN[fam]

    def run(pulse, gap, n_pulses, bounds, caps: SliceCaps = SliceCaps()):
        if pulse.is_cuda:
            return slice_cuda(fam, pulse, gap, n_pulses, bounds, caps)
        _check(pulse, gap, n_pulses, caps)
        return plain(pulse, gap, n_pulses, bounds, caps)

    run.__name__ = run.__qualname__ = f"slice_{fam}"
    run.__doc__ = (f"{fam.upper()} slicing: ``csrc/slice.cu`` for CUDA "
                   f"tensors (``bounds`` as ``{fam}_bounds`` gives them or "
                   f"as their :func:`bound_table`), :func:`{plain.__name__}` "
                   f"for CPU tensors.")
    return run


slice_ppm = _wrapper("ppm")
slice_pwm = _wrapper("pwm")
slice_pcm = _wrapper("pcm")
slice_mc = _wrapper("mc")
slice_dmc = _wrapper("dmc")
slice_piwm_dc = _wrapper("piwm_dc")
slice_nrzs = _wrapper("nrzs")
slice_rzi = _wrapper("rzi")
slice_osv1 = _wrapper("osv1")

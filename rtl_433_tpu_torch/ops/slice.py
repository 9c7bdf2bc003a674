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

For a CUDA tensor each wrapper launches ``csrc/slice.cu`` (one thread per
lane for PCM and NRZS, a thread group per lane for the seven families of
:data:`GROUP_FAMILIES`; the train and each lane's events staged in shared
memory, the launch shaped by :func:`launch_plan`); for a CPU tensor it
runs the plain version: for PCM and NRZS the JAX ``step`` as vectorized
torch over the ``[B, S]`` lane grid in a Python loop over the pulses
(stopping at the longest train: padded steps are inactive), for the
group families the kernel's phases vectorized over pulses (symbols for
DMC and PIWM-DC) and lanes (what no state decides, MC's walk per piece,
DMC's pending flag and OSV1's Manchester bit from parities, OSV1's phases
in closed form, the cursors from running sums); then the JAX assembly by
scatter-adds (``_lane_scatter_add``, ``_assemble_cols``,
``_assemble_runs``, PCM's delta-scatter and cumulative sum).
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


def _steps(n_pulses) -> int:
    return int(n_pulses.max()) if n_pulses.numel() else 0


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


def _flat(ys, i, B, S):
    """Component ``i`` of the per-step outputs as [L, steps]."""
    if not ys:
        return torch.zeros((B * S, 0), dtype=torch.int32)
    return torch.stack([y[i] for y in ys], dim=-1).reshape(B * S, len(ys))


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


def _zeros(B, S, dev):
    return torch.zeros((B, S), dtype=torch.int32, device=dev)


def _falses(B, S, dev):
    return torch.zeros((B, S), dtype=torch.bool, device=dev)


def _step_inputs(pulse, gap, n_pulses, n):
    """Column ``n`` of pulse and gap, and the valid and last masks, as
    [B, 1]."""
    return (pulse[:, n:n + 1].to(torch.int32), gap[:, n:n + 1].to(torch.int32),
            (n < n_pulses)[:, None], (n == n_pulses - 1)[:, None])


# ---- the phase form of PPM, MC and PWM (csrc/slice.cu's groups): what no
# state decides, per pulse; MC's tsl walked per piece; the cursors from
# running sums; the JAX assembly

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


def _pcm_rates(pulse, gap, n_pulses, b):
    """Pass 1: preamble bit-rate re-estimation -> per-lane f_short/f_long
    and the float-boundary flag (JAX ``_pcm_rates``): RZ/NRZ preamble runs
    in a loop, then the order-free anywhere-in-stream fallbacks."""
    B, N = pulse.shape
    dev = pulse.device
    sh, lo, tol = b["short"], b["long"], b["tol"]
    is_rz, mc0 = b["is_rz"], b["min_count"]
    S = sh.shape[1]
    w = torch.where
    fs = b["f0s"].expand(B, S)
    fl = b["f0l"].expand(B, S)
    z = _zeros(B, S, dev)
    cnt = sw = lw = plen = z
    mc = mc0.expand(B, S)
    prev_c = flag = _falses(B, S, dev)

    def eval_run(cnt, sw, lw, mc, fs, fl, plen):
        acc = cnt >= mc
        cntf = cnt.to(_F32)
        fs_rz = w(sw > 0, cntf / sw.to(_F32), fs)
        fl_rz = w(lw > 0, cntf / lw.to(_F32), fl)
        f_nrz = w(sw > 0, cntf / sw.to(_F32), fs)
        fs2 = w(acc, w(is_rz, fs_rz, f_nrz), fs)
        fl2 = w(acc, w(is_rz, fl_rz, f_nrz), fl)
        return w(acc, cnt, mc), fs2, fl2, w(acc, cnt, plen)

    for n in range(_steps(n_pulses)):
        p, g, vm, _last = _step_inputs(pulse, gap, n_pulses, n)
        c_rz = ((p >= sh - tol) & (p <= sh + tol)
                & (p + g >= lo - tol) & (p + g <= lo + tol))
        hp, near_p = _trunc05(p.to(_F32) * fs)
        hg, near_g = _trunc05(g.to(_F32) * fl)
        c_nrz = (hp == 1) & (hg == 1)
        c = vm & w(is_rz, c_rz, c_nrz)
        flag = flag | (vm & ~is_rz & ((near_p & (hp <= 2))
                                      | (near_g & (hg <= 2))))
        ended = prev_c & ~c
        new = eval_run(cnt, sw, lw, mc, fs, fl, plen)
        mc, fs, fl, plen = (w(ended, a, o) for a, o in
                            zip(new, (mc, fs, fl, plen)))
        d_sw = w(is_rz, p, p + g)
        d_lw = p + g
        d_cnt = w(is_rz, 1, 2)
        cnt = w(c, cnt + d_cnt, 0)
        sw = w(c, sw + d_sw, 0)
        lw = w(c, lw + d_lw, 0)
        prev_c = c
    # a run still open at the train's end (evaluated at the first padded
    # step of the JAX scan, or after its last step)
    new = eval_run(cnt, sw, lw, mc, fs, fl, plen)
    mc, fs, fl, plen = (w(cnt > 0, a, o) for a, o in
                        zip(new, (mc, fs, fl, plen)))

    # fallbacks (anywhere-in-stream, order-free)
    p3 = pulse[:, :, None].to(torch.int32)
    g3 = gap[:, :, None].to(torch.int32)
    vm3 = torch.arange(N, device=dev)[None, :, None] < n_pulses[:, None, None]
    sh3, lo3, tol3 = sh[:, None], lo[:, None], tol[:, None]
    c_rz3 = vm3 & ((p3 >= sh3 - tol3) & (p3 <= sh3 + tol3)
                   & (p3 + g3 >= lo3 - tol3) & (p3 + g3 <= lo3 + tol3))
    isum = lambda x: x.sum(dim=1, dtype=torch.int32)
    rzc = isum(c_rz3)
    rzs = isum(w(c_rz3, p3, 0))
    rzl = isum(w(c_rz3, p3 + g3, 0))
    use_rzfb = is_rz & (plen == 0) & (rzc > 8)
    fs = w(use_rzfb, rzc.to(_F32) / rzs.clamp(min=1).to(_F32), fs)
    fl = w(use_rzfb, rzc.to(_F32) / rzl.clamp(min=1).to(_F32), fl)
    # NRZ fallback: four independent windows, each pulse/gap may add twice
    w1 = vm3 & (p3 >= sh3 - tol3) & (p3 <= sh3 + tol3)
    w2 = vm3 & (p3 >= 2 * sh3 - tol3) & (p3 <= 2 * sh3 + tol3)
    w3 = vm3 & (g3 >= lo3 - tol3) & (g3 <= lo3 + tol3)
    w4 = vm3 & (g3 >= 2 * lo3 - tol3) & (g3 <= 2 * lo3 + tol3)
    nw = (isum(w(w1, p3, 0)) + isum(w(w2, p3, 0)) + isum(w(w3, g3, 0))
          + isum(w(w4, g3, 0)))
    nc = isum(w1) + 2 * isum(w2) + isum(w3) + 2 * isum(w4)
    use_nrzfb = ~is_rz & (plen == 0) & (nc > 20)
    fnrz = nc.to(_F32) / nw.clamp(min=1).to(_F32)
    return w(use_nrzfb, fnrz, fs), w(use_nrzfb, fnrz, fl), flag


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


def slice_pcm_plain(pulse, gap, n_pulses, bounds, caps=SliceCaps()):
    """Plain version of the PCM scan (JAX ``slice_pcm``): variable
    bits-per-pulse emitted as runs, ``bitbuffer_clear`` handled by a
    segment id per run (only runs of the segment an event flushed are
    kept), float32 roundings near a boundary flagged."""
    B, N = pulse.shape
    dev = pulse.device
    E, R, BY = caps
    BITS = BY * 8
    b = _cols(bounds, dev)
    S = b["short"].shape[1]
    fs, fl, fflag = _pcm_rates(pulse, gap, n_pulses, b)
    sh, lo, rst, gpl = b["short"], b["long"], b["reset"], b["gap_limit"]
    tol, mz, is_rz, okm = b["tol"], b["max_zeros"], b["is_rz"], b["ok"]
    w = torch.where
    ev = row = bir = frb = seg = _zeros(B, S, dev)
    ovf = _falses(B, S, dev)
    ys = []
    for n in range(_steps(n_pulses)):
        p, g, valid, last = _step_inputs(pulse, gap, n_pulses, n)
        act = valid & okm
        h, near_h = _trunc05(p.to(_F32) * fs)
        l0, near_l = _trunc05((g + sh - lo).to(_F32) * fl)
        near_l = near_l & (l0 <= mz + 1)
        h = w(act, h.clamp(min=0), 0)
        l = w(act, torch.minimum(l0.clamp(min=0), mz), 0)
        ovf2 = ovf | (act & (near_h | near_l))
        b_ev, b_row, b_start = ev, row, bir
        bir2 = bir + h + l
        frb2 = w(row == 0, frb + h + l, frb)
        do_clear = act & is_rz & ((p - sh).abs() > tol)
        do_break = act & ~do_clear & (g > gpl) & (g <= rst)
        seg2 = w(do_clear, seg + 1, seg)
        row2 = w(do_clear, 0, w(do_break, row + 1, row))
        bir3 = w(do_clear | do_break, 0, bir2)
        frb3 = w(do_clear, 0, frb2)
        flush = act & ((g > rst) | last) & ((frb3 > 0) | (row2 > 0))
        f_rows = row2 + 1
        ev2 = w(flush, ev + 1, ev)
        ovf = ovf2 | (ev2 >= E) | (torch.maximum(row2, row) >= R) \
            | (bir2 >= BITS)
        ys.append((h, l, b_ev, b_row, b_start, seg, flush, ev, f_rows))
        ev, row = ev2, w(flush, 0, row2)
        bir, frb, seg = w(flush, 0, bir3), w(flush, 0, frb3), \
            w(flush, 0, seg2)
    ovf = ovf | fflag

    L = B * S

    def flat(i):
        return _flat(ys, i, B, S).to(dev)

    h, l, ev_l, b_row, b_start, seg_l, flush, f_ev, f_rows = \
        (flat(i) for i in range(9))
    lane = torch.arange(L, device=dev)[:, None].expand(h.shape)
    m_flush = flush.bool()
    # final segment id per (lane, event); -1 for never-flushed events
    fseg = _scatter_add((L, E), [lane, f_ev], seg_l + 1, m_flush) - 1
    sel = torch.gather(fseg, 1, ev_l.clamp(0, E - 1).to(torch.int64))
    live = (seg_l == sel) & (ev_l < E)
    m_bits = live & (h + l > 0)
    bytes_ = _runs_to_bits([lane, ev_l, b_row], b_start, h, live & (h > 0),
                           (L, E, R), BITS).reshape(B, S, E, R, BY)
    bits_per_row = _lane_scatter_add(B, S, (E, R), [ev_l, b_row], h + l,
                                     m_bits)
    num_rows = _lane_scatter_add(B, S, (E,), [f_ev], f_rows, m_flush)
    syncs = torch.zeros((B, S, E, R), dtype=torch.int32, device=dev)
    return {"bytes": bytes_, "bits_per_row": bits_per_row, "syncs": syncs,
            "num_rows": num_rows, "n_events": ev, "ovf": ovf}


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
    """Plain version of the NRZS scan (JAX ``slice_nrzs``): a pulse longer
    than the bit limit emits ``pulse // limit`` ones then a zero, a
    shorter one a zero, an exact-limit one nothing; every reset gap (or
    the final pulse) flushes an event, empty ones included."""
    B, N = pulse.shape
    dev = pulse.device
    E, R, BY = caps
    BITS = BY * 8
    b = _cols(bounds, dev)
    S = b["short"].shape[1]
    sh, rst, okm = b["short"], b["reset"], b["ok"]
    w = torch.where
    ev = bir = _zeros(B, S, dev)
    ovf = _falses(B, S, dev)
    ys = []
    for n in range(_steps(n_pulses)):
        p, g, valid, last = _step_inputs(pulse, gap, n_pulses, n)
        act = valid & okm
        h = w(act & (p > sh), torch.div(p, sh.clamp(min=1),
                                        rounding_mode="floor"), 0)
        z = w(act & (p != sh), 1, 0)
        bir2 = bir + h + z
        flush = act & ((g >= rst) | last)
        f_rows = w(bir2 > 0, 1, 0)
        ev2 = w(flush, ev + 1, ev)
        ovf = ovf | (bir2 > BITS) | (flush & (ev2 >= E))
        ys.append((h, z, ev, bir, flush, ev, f_rows))
        ev, bir = ev2, w(flush, 0, bir2)
    return _assemble_runs(B, S, caps, [_flat(ys, i, B, S) for i in range(7)],
                          ev, ovf)


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
# the families csrc/slice.cu runs as thread groups, a group per lane (the
# others, PCM and NRZS, walk a lane on one thread); DMC and PIWM-DC step
# over the 2N symbols of the interleaved pulse/gap axis
GROUP_FAMILIES = ("ppm", "mc", "pwm", "dmc", "piwm_dc", "rzi", "osv1")
SYMBOL_FAMILIES = ("dmc", "piwm_dc")


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def stage_bytes(caps: SliceCaps, events: int) -> int:
    """Shared bytes of one lane's stage in ``csrc/slice.cu`` holding
    ``events`` events: their rows padded to 4-byte words, then their
    bits_per_row, syncs and num_rows, each part rounded up to 16 bytes;
    the stride between lanes is made an odd multiple of 16 so that the
    16-byte accesses of eight neighbouring lanes fall in distinct banks."""
    _E, R, BY = (int(c) for c in caps)
    sb = _r16(events * R * -(-BY // 4) * 4) + _r16(8 * events * R) \
        + _r16(4 * events)
    return sb + 16 if sb % 32 == 0 else sb


def launch_plan(B: int, S: int, N: int, caps: SliceCaps, sms: int = 132,
                fam: str | None = None):
    """The slicer kernel's launch for B trains of N pulses and S specs on
    a card of ``sms`` SMs: (lanes per block, mode, stage bytes per lane,
    shared bytes per block); a block takes one train's pulses and gaps
    (``8 N`` bytes) and its lanes' stages.

    For PPM, MC, PWM, DMC, PIWM-DC, RZI and OSV1 (``fam`` in
    :data:`GROUP_FAMILIES`; the kernel's groups) the mode is the threads
    per lane, by the lane's steps (N pulses, or 2N symbols for DMC and
    PIWM-DC): 8 where they are
    at most 8, 16 where at most 16, else a warp; up to four warps of lanes
    per block (fewer where S is smaller), each lane staging every event,
    so that several blocks share an SM; fewer warps, and then a warp per
    lane, where that does not fit the 227 KB a block may use, raising
    where one lane of a warp does not.

    For PCM and NRZS (the walk) the mode is whether every event of
    a lane is staged: up to 64 specs per block (32 where S <= 32), a
    multiple of 32, each lane with its stage. Every event is staged
    (nothing leaves before the lane ends) where the whole grid then fits
    on the card at once: such a call is bound by its slowest lane, whose
    walk would otherwise stop at each event's write-out. Otherwise a lane
    stages one event, for more lanes per SM. Raises where not even 32
    lanes with one event fit."""
    E = int(caps[0])
    pulses = _r16(8 * N)
    if fam in GROUP_FAMILIES:
        sb = stage_bytes(caps, E)
        steps = 2 * N if fam in SYMBOL_FAMILIES else N
        g0 = 8 if steps <= 8 else 16 if steps <= 16 else 32
        for g in dict.fromkeys((g0, 32)):
            per_warp = 32 // g
            for warps in range(min(4, max(1, -(-S // per_warp))), 0, -1):
                smem = pulses + warps * per_warp * sb
                if smem <= SMEM_MAX:
                    return warps * per_warp, g, sb, smem
        raise ValueError(f"slice: caps {tuple(caps)} with N={N} pulses do "
                         f"not fit one block's shared memory")
    for every in (True, False):
        sb = stage_bytes(caps, E if every else 1)
        for lanes in ((64, 32) if S > 32 else (32,)):
            smem = pulses + min(S, lanes) * sb
            if smem > SMEM_MAX:
                continue
            if every and B * -(-S // lanes) > \
                    sms * (SMEM_SM // (smem + 1024)):
                continue
            return lanes, every, sb, smem
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
    lanes, mode, sb, smem = launch_plan(
        B, S, N, caps, torch.cuda.get_device_properties(
            dev).multi_processor_count, fam)
    e = lambda *sh, dt=torch.int32: torch.empty(sh, dtype=dt, device=dev)
    out = {"bytes": e(B, S, E, R, BY, dt=torch.uint8),
           "bits_per_row": e(B, S, E, R), "syncs": e(B, S, E, R),
           "num_rows": e(B, S, E), "n_events": e(B, S),
           "ovf": e(B, S, dt=torch.uint8)}
    if B and S:
        fn = _cuda.launcher("slice")
        _cuda.LAUNCHES["slice_" + fam] += 1
        err = fn(FAMILIES[fam][0], pulse.data_ptr(), gap.data_ptr(),
                 n_pulses.data_ptr(), B, N, tab.data_ptr(), S, E, R, BY,
                 lanes, int(mode), sb, smem, out["bytes"].data_ptr(),
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

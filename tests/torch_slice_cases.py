"""Pulse trains and spec lists for the device-slicing scans, made from a
seed with numpy.

Shared by the CPU tests (the port's plain versions against the JAX
package's scans), ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (the
CUDA kernel against the plain version). Imports only the port. The
generators are those of ``tests/test_device_slice.py``, one per family,
plus PCM trains whose widths sit on a rounding boundary of the bit-rate
products (so that the float-boundary flag fires) and capacities small
enough to flag lanes for events, rows and row bytes.
"""

from __future__ import annotations

import numpy as np

from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.decoders.device_dispatch import _FAM_MODS
from rtl_433_tpu_torch.ops.slice import SliceCaps

RATE = 250_000
SPU = RATE / 1e6

# the caps DeviceBank gives each family
BANK_CAPS = {"ppm": SliceCaps(4, 16, 20), "pwm": SliceCaps(4, 16, 20),
             "pcm": SliceCaps(4, 16, 40), "mc": SliceCaps(8, 24, 20),
             "dmc": SliceCaps(8, 24, 20), "piwm_dc": SliceCaps(8, 24, 20),
             "nrzs": SliceCaps(4, 16, 40), "rzi": SliceCaps(4, 16, 40),
             "osv1": SliceCaps(4, 16, 40)}
# caps small enough to flag lanes on events, rows and row bytes
SMALL_CAPS = SliceCaps(2, 3, 2)


def family_devices(fam, k=12):
    """Specs of family ``fam`` with a decode function: a mix of those with
    and without a tolerance (and, for PCM, of RZ and NRZ), at most ``k``."""
    mods = _FAM_MODS[fam]
    devs = [d for d in Registry().slots
            if d is not None and d.decode_fn and d.modulation in mods]
    if fam == "pcm":
        rz = [d for d in devs if d.short_width != d.long_width][: k // 2]
        return rz + [d for d in devs
                     if d.short_width == d.long_width][: k - len(rz)]
    tol = [d for d in devs if d.tolerance > 0][: k // 2]
    return tol + [d for d in devs if d.tolerance == 0][: k - len(tol)]


def _w(us):
    return max(1, int(us * SPU))


def _ppm(dev, rng):
    n = int(rng.integers(6, 60))
    cands = [dev.short_width, dev.long_width, dev.sync_width or 0,
             dev.reset_limit * 1.2, dev.short_width + dev.long_width]
    gaps = [max(1, int(cands[int(rng.integers(len(cands)))]
                       * (1 + rng.uniform(-0.15, 0.15)) * SPU))
            for _ in range(n)]
    pulses = [max(1, int(dev.short_width * SPU * 0.5))] * n
    gaps[-1] = int(dev.reset_limit * SPU * 1.5) + 10
    return pulses, gaps


def _pwm(dev, rng):
    n = int(rng.integers(6, 60))
    pc = [dev.short_width, dev.long_width, dev.sync_width or 0,
          dev.short_width * 0.2, dev.long_width * 2.5]
    gc = [dev.short_width, dev.gap_limit * 1.2 or dev.short_width,
          dev.reset_limit * 1.2]
    pulses, gaps = [], []
    for _ in range(n):
        p = pc[int(rng.integers(len(pc)))]
        g = gc[int(rng.integers(len(gc)))]
        pulses.append(max(1, int(p * (1 + rng.uniform(-0.15, 0.15)) * SPU)))
        gaps.append(max(1, int(g * (1 + rng.uniform(-0.15, 0.15)) * SPU)))
    gaps[-1] = int(dev.reset_limit * SPU * 1.5) + 10
    return pulses, gaps


def _pcm(dev, rng):
    s, lg = _w(dev.short_width), _w(dev.long_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(0, 20))):       # a preamble run
        pulses.append(s)
        gaps.append(max(1, lg - s))
    for _ in range(int(rng.integers(4, 40))):
        p = int(s * int(rng.integers(1, 4)) * (1 + rng.uniform(-0.1, 0.1)))
        g = int(lg * int(rng.integers(1, 5)) * (1 + rng.uniform(-0.1, 0.1)))
        if rng.uniform() < 0.1:
            g = rst + int(rng.integers(1, rst))     # mid-train end of package
        pulses.append(max(1, p))
        gaps.append(max(1, g))
    gaps[-1] = rst * 2 + 10
    return pulses, gaps


def _pcm_boundary(dev, rng):
    """PCM widths at k + 1/2 bit periods: ``p * f + 0.5`` lands on an
    integer, inside the float-boundary flag's band."""
    s, lg = _w(dev.short_width), _w(dev.long_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(6, 30))):
        k = int(rng.integers(0, 3))
        pulses.append(max(1, (2 * k + 1) * s // 2 if rng.uniform() < 0.5
                          else s * (k + 1)))
        kg = int(rng.integers(0, 3))
        gaps.append(max(1, (2 * kg + 1) * lg // 2 + lg - s
                        if rng.uniform() < 0.5 else lg * (kg + 1)))
    gaps[-1] = rst * 2 + 10
    return pulses, gaps


def _mc(dev, rng):
    s = _w(dev.short_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(6, 60))):
        kp = [1, 1, 2, 2, 3][int(rng.integers(5))]
        kg = [1, 1, 2, 2, 4][int(rng.integers(5))]
        pulses.append(max(1, int(s * kp * (1 + rng.uniform(-0.2, 0.2)))))
        g = max(1, int(s * kg * (1 + rng.uniform(-0.2, 0.2))))
        if rng.uniform() < 0.06:
            g = rst + int(rng.integers(1, rst))
        gaps.append(g)
    gaps[-1] = rst * 2 + 10
    return pulses, gaps


def _dmc(dev, rng, i=1, jitter=0.08):
    s, lg = _w(dev.short_width), _w(dev.long_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(6, 60))):
        pw = [s, s, lg, lg, int(lg * 1.7)][int(rng.integers(5))]
        gw = [s, s, lg, lg, rst + 5][int(rng.integers(5))]
        pulses.append(max(1, int(pw * (1 + rng.uniform(-jitter, jitter)))))
        gaps.append(max(1, int(gw * (1 + rng.uniform(-jitter, jitter)))))
    if i % 3:
        gaps[-1] = rst * 2 + 10
    return pulses, gaps


def _nrzs(dev, rng, i):
    s = _w(dev.short_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(6, 30))):
        pulses.append(max(1, [s, s - 1, s + 1, s * 3, s * 7][
            int(rng.integers(5))]))
        gaps.append(max(1, [s, s * 2, rst + 3][int(rng.integers(3))]))
    if i % 3:
        gaps[-1] = rst + 10
    return pulses, gaps


def _rzi(dev, rng, i):
    s, lg = _w(dev.short_width), _w(dev.long_width)
    rst = max(2, int(dev.reset_limit * SPU))
    pulses, gaps = [], []
    for _ in range(int(rng.integers(6, 30))):
        pw = [s, lg, lg * 2, lg * 3, max(1, s // 2)][int(rng.integers(5))]
        pulses.append(max(1, int(pw * (1 + rng.uniform(-0.1, 0.1)))))
        gaps.append(max(1, [s, lg, rst + 3][int(rng.integers(3))]))
    if i % 3:
        gaps[-1] = rst + 10
    return pulses, gaps


def _osv1(dev, rng, i):
    s = _w(dev.short_width)
    rst = max(2, int(dev.reset_limit * SPU))
    hmax = s * 3 // 2
    sync = 2 * hmax + 5
    pulses, gaps = [], []
    npre = 12 if i % 4 else int(rng.integers(8, 15))
    for j in range(npre):
        pulses.append(int(s * (1 + rng.uniform(-0.2, 0.2))))
        g = int(s * (1 + rng.uniform(-0.2, 0.2)))
        gaps.append(min(g, hmax) if j < npre - 1 else hmax + 3)
    if i % 5 == 3:                                   # a corrupt preamble
        pulses[int(rng.integers(npre))] = max(1, s // 4)
    pulses.append(sync + int(rng.integers(0, 20)))
    gaps.append(sync + int(rng.integers(0, 20)) if i % 7 else max(1, s))
    for _ in range(int(rng.integers(8, 40))):
        pulses.append([s, 2 * s][int(rng.integers(2))])
        gaps.append([s, 2 * s][int(rng.integers(2))])
    if i % 3:
        gaps[-1] = rst + 10
    return pulses, gaps


def family_trains(fam, devs, seed, n=24):
    """``n`` trains for family ``fam``, the i-th shaped by spec i mod S."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dev = devs[i % len(devs)]
        if fam == "ppm":
            out.append(_ppm(dev, rng))
        elif fam == "pwm":
            out.append(_pwm(dev, rng))
        elif fam == "pcm":
            out.append((_pcm_boundary if i % 4 == 3 else _pcm)(dev, rng))
        elif fam == "mc":
            out.append(_mc(dev, rng))
        elif fam in ("dmc", "piwm_dc"):
            out.append(_dmc(dev, rng, i, 0.08 if fam == "dmc" else 0.1))
        else:
            out.append({"nrzs": _nrzs, "rzi": _rzi, "osv1": _osv1}[fam](
                dev, rng, i))
    return out


def pack(trains, n_min=1):
    """Trains as int32 pulse/gap [B, N] (zero-padded) and n_pulses [B]."""
    N = max([n_min] + [len(p) for p, _g in trains])
    B = len(trains)
    pulse = np.zeros((B, N), np.int32)
    gap = np.zeros((B, N), np.int32)
    n_pulses = np.zeros((B,), np.int32)
    for i, (p, g) in enumerate(trains):
        pulse[i, :len(p)] = p
        gap[i, :len(g)] = g
        n_pulses[i] = len(p)
    return pulse, gap, n_pulses


def mixed_trains(devs, seed, n=12):
    """Trains of every family's shape, for one bank over ``devs``."""
    rng = np.random.default_rng(seed)
    fams = list(_FAM_MODS)
    out = []
    for i in range(n):
        fam = fams[i % len(fams)]
        fd = [d for d in devs if d.modulation in _FAM_MODS[fam]] or devs
        out += family_trains(fam, fd, int(rng.integers(1 << 30)), n=1)
    return out


def dup_planes(seed, B=3, J=4, E=6, R=5, W=7, plant=True):
    """Slicer-output planes (NumPy: bytes, num_rows, bits_per_row, syncs)
    in which events repeat earlier events of their lane; the repeats'
    rows at or past the row count differ (they are scratch). Without
    ``plant`` every event of a lane is distinct."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 4, (B, J, E, R, W)).astype(np.uint8)
    nr = rng.integers(0, R + 2, (B, J, E)).astype(np.int32)
    bpr = rng.integers(0, 3, (B, J, E, R)).astype(np.int32)
    sy = rng.integers(0, 2, (B, J, E, R)).astype(np.int32)
    if plant:
        for _ in range(3 * B * J):
            b, j = rng.integers(B), rng.integers(J)
            e2, e = sorted(rng.choice(E, 2, replace=False))
            nr[b, j, e] = nr[b, j, e2]
            rows = min(nr[b, j, e2], R)
            nb[b, j, e, :rows] = nb[b, j, e2, :rows]
            bpr[b, j, e, :rows] = bpr[b, j, e2, :rows]
            sy[b, j, e, :rows] = sy[b, j, e2, :rows]
            nb[b, j, e, rows:] = rng.integers(0, 255, (R - rows, W))
    else:
        nb[:, :, :, 0, 0] = np.arange(E, dtype=np.uint8)
        nr[:] = np.maximum(nr, 1)
    return {"bytes": nb, "num_rows": nr, "bits_per_row": bpr, "syncs": sy}



def dup_edge_planes(seed, B=4, J=5, E=6, R=5, W=13, plant=True):
    """Slicer-output planes for the content dedup's edges: counts of -1, 0,
    1, R and R + 1 (a count is compared raw; its rows clamp to [0, R]);
    the first lane all zeros; with ``plant``, repeats of earlier events
    (their scratch rows, at or past the clamped count, differ) and near
    repeats that differ in one value of their live prefix only: the last
    byte of the last live row, a bit count or a sync of the last live
    row. Without ``plant`` no two events of a lane are equal."""
    rng = np.random.default_rng(seed)
    counts = np.array([-1, 0, 1, R, R + 1], np.int32)
    nb = rng.integers(0, 4, (B, J, E, R, W)).astype(np.uint8)
    nr = counts[rng.integers(0, len(counts), (B, J, E))]
    bpr = rng.integers(0, 3, (B, J, E, R)).astype(np.int32)
    sy = rng.integers(0, 2, (B, J, E, R)).astype(np.int32)
    if plant:
        for _ in range(3 * B * J):
            b, j = rng.integers(B), rng.integers(J)
            if E < 2:
                break
            e2, e = sorted(rng.choice(E, 2, replace=False))
            nr[b, j, e] = nr[b, j, e2]
            rows = min(max(int(nr[b, j, e2]), 0), R)
            for a in (nb, bpr, sy):
                a[b, j, e, :rows] = a[b, j, e2, :rows]
            nb[b, j, e, rows:] = rng.integers(0, 255, (R - rows, W))
            kind = int(rng.integers(4))
            if rows and kind == 1:
                nb[b, j, e, rows - 1, W - 1] ^= 0x80
            elif rows and kind == 2:
                bpr[b, j, e, rows - 1] += 1
            elif rows and kind == 3:
                sy[b, j, e, rows - 1] += 1
    else:
        nr = np.where(np.arange(E) % 2 == 0, 1, R + 1).astype(np.int32)\
            * np.ones((B, J, 1), np.int32)
        nb[:, :, :, 0, 0] = np.arange(E, dtype=np.uint8)
    nb[0, 0], bpr[0, 0], sy[0, 0], nr[0, 0] = 0, 0, 0, 0
    if not plant:
        nr[0, 0] = np.arange(E)
    return {"bytes": nb, "num_rows": nr, "bits_per_row": bpr, "syncs": sy}

def drain_shaped(fam, seed, B=256, N=64, S=125):
    """Lanes at the 4096-channel drain's largest slicer call: B trains of
    the family's shape cut to at most N pulses (padded to N), and the
    family's specs repeated to S, so that one train spans several blocks
    of lanes. Returns (pulse, gap, n_pulses numpy), devices."""
    devs = family_devices(fam)
    trains = [(p[:N], g[:N]) for p, g in family_trains(fam, devs, seed, n=B)]
    return pack(trains, n_min=N), (devs * S)[:S]


def pcm_open_erased(dev):
    """RZ PCM trains for ``dev`` (short != long): a valid run of short
    pulses whose last pulse is long, so the lane's open event is cleared
    at the last step and never flushed; the same after a first event that
    flushes on a reset gap; and the first run ending on the reset gap
    instead, whose event is kept."""
    s, lg = _w(dev.short_width), _w(dev.long_width)
    rst = max(2, int(dev.reset_limit * SPU))
    run = ([s] * 24, [max(1, lg - s)] * 24)
    kept = (run[0], run[1][:-1] + [rst * 2 + 10])
    erased = (run[0] + [3 * s + 7 * max(1, s // 4)], run[1] + [rst * 2 + 10])
    return [erased, (kept[0] + erased[0], kept[1] + erased[1]), kept]


def ppm_overflow(dev, caps):
    """A PPM train for ``dev`` that passes every cap of ``caps`` in its
    first event already: events + 2 events, each of rows + 2 rows of
    8 * row_bytes + 4 bits, rows split by a gap that is no bit and no
    sync but below the reset limit, events by a gap past it."""
    from rtl_433_tpu_torch.ops.slice import ppm_bounds
    b = {k: int(v[0]) for k, v in ppm_bounds([dev], RATE).items()}
    zero = (b["zero_l"] + b["zero_u"]) // 2
    one = (b["one_l"] + b["one_u"]) // 2

    def free(g):
        return not any(b[f"{w}_l"] < g < b[f"{w}_u"]
                       for w in ("zero", "one", "sync"))
    brk = next(g for g in range(b["reset"] - 1, 0, -1) if free(g))
    E, R, BY = caps
    gaps = []
    for _e in range(E + 2):
        for r in range(R + 2):
            gaps += [one if (i + r) % 3 else zero for i in range(8 * BY + 4)]
            gaps.append(brk)
        gaps[-1] = b["reset"] + 10
    return [max(1, _w(dev.short_width) // 2)] * len(gaps), gaps


# ---- planted trains for MC and PWM (the kernel's group design): each
# family's edge cases, trains that cross every cap, and trains of set
# lengths around a tile of 32 pulses

def _bounds_of(fam, dev):
    from rtl_433_tpu_torch.ops import slice as sl
    return {k: int(v[0]) for k, v in
            getattr(sl, f"{fam}_bounds")([dev], RATE).items()}


def pwm_edge_dev():
    """A PWM spec with a sync window and a gap limit below its reset
    limit, so that every class and both gap candidacies can be planted."""
    for dev in family_devices("pwm", k=1000):
        b = _bounds_of("pwm", dev)
        if 0 < b["sync_l"] < b["sync_u"] and 0 < b["gap"] < b["reset"] \
                and b["one_l"] > 1:
            return dev
    raise LookupError("no PWM spec with a sync window and a gap limit")


def pwm_widths(dev):
    """A pulse width of each PWM class for ``dev`` (as the scan classifies
    it) and the gaps: inside a row, a break candidate, a flush candidate."""
    b = _bounds_of("pwm", dev)

    def cls(p):
        if b["one_l"] < p < b["one_u"]:
            return "one"
        if b["zero_l"] < p < b["zero_u"]:
            return "zero"
        if b["sync_l"] < p < b["sync_u"]:
            return "sync"
        return "spur" if p <= b["one_l"] else "rb"
    top = max(v for k, v in b.items() if v < (1 << 29)) + 2
    w = {}
    for p in range(1, top):
        w.setdefault(cls(p), p)
    assert sorted(w) == ["one", "rb", "spur", "sync", "zero"], w
    return w, {"in": 1, "brk": b["gap"] + 1, "flush": b["reset"] + 1}


def pwm_edges(dev):
    """PWM trains for ``dev`` (pwm_edge_dev): a flush candidate with
    nothing touched since the previous one (a spurious pulse after a
    flush); syncs at bir 0 (a train opening on two syncs, a sync after a
    break); break candidates at bir3 0 (after a sync and after a row
    break); spurious pulses between bits; then all of them in one train
    of over two tiles."""
    w, gp = pwm_widths(dev)
    one, zero, sync, spur, rb = (w[k] for k in ("one", "zero", "sync",
                                                "spur", "rb"))
    g_in, g_brk, g_fl = gp["in"], gp["brk"], gp["flush"]
    no_touch = ([one, zero, one, spur, spur, one, zero],
                [g_in, g_in, g_fl, g_fl, g_brk, g_in, g_in])
    sync0 = ([sync, sync, one, zero, sync, sync, one, one, zero, sync, one],
             [g_in, g_in, g_in, g_brk, g_in, g_in, g_in, g_in, g_in, g_in,
              g_fl])
    brk0 = ([one, one, sync, rb, one, zero, spur, one],
            [g_in, g_brk, g_brk, g_brk, g_brk, g_in, g_brk, g_in])
    spurs = ([one, spur, zero, spur, spur, one, spur, zero, zero, spur],
             [g_in] * 9 + [g_fl])
    trains = [no_touch, sync0, brk0, spurs]
    trains.append(tuple(sum((list(t[k]) * 2 for t in trains), [])
                        for k in (0, 1)))
    return trains


def mc_edge_devs():
    """An MC spec with a tolerance (its out can fire) and one without."""
    devs = family_devices("mc", k=1000)
    return ([d for d in devs if d.tolerance > 0][0],
            [d for d in devs if d.tolerance == 0][0])


def mc_edges(dev, dev_notol):
    """MC trains: every pulse out (short pulses, long gaps, the resync 1 of
    a pulse in the window before a long gap) ending on a flush at the last
    pulse; a tsl chain across a whole train that no out, flush or width
    over 1.5 short widths resets (for ``dev`` and for ``dev_notol``); a
    train of one pulse; and trains whose widths are not tame (negative,
    and past 2^28), where only out and the flush end a piece."""
    b = _bounds_of("mc", dev)
    sh, tol = b["short"], b["tol"]
    long_g = 2 * sh + tol + 1
    assert long_g <= b["reset"]
    outs = ([max(1, sh - tol - 1), 2 * sh, 2 * sh, max(1, sh - tol - 1),
             2 * sh + 1] * 8,
            [long_g, long_g, sh, long_g, long_g] * 8)
    outs[1][-1] = sh
    chain = [max(sh - tol, (3 * sh) // 4)] * 150
    sh0 = _bounds_of("mc", dev_notol)["short"]
    chain0 = [max(1, sh0 // 3)] * 150
    wild = ([sh, -5, sh, 2 * sh, sh, 1 << 29, sh, sh],
            [sh, sh, -3, sh, sh, sh, 1 << 29, sh])
    return [outs, (chain, list(chain)), (chain0, list(chain0)),
            ([sh], [sh]), wild]


def cap_trains(fam, dev, caps):
    """Trains for ``dev`` that cross each cap of ``caps`` on its own: more
    events than E, more rows in one event than R, more bits in one row
    than 8 * BY; every lane that runs them is flagged on the cursors
    before the flush."""
    E, R, BY = caps
    if fam == "pwm":
        w, gp = pwm_widths(dev)
        one, zero, rb = w["one"], w["zero"], w["rb"]
        events = ([one, zero, one] * (E + 3),
                  [gp["in"], gp["in"], gp["flush"]] * (E + 3))
        rows = ([one, zero, rb] * (R + 3) + [one],
                [gp["in"]] * (3 * R + 9) + [gp["flush"]])
        bits = ([one, zero] * (4 * BY + 5), [gp["in"]] * (8 * BY + 10))
        bits[1][-1] = gp["flush"]
        return [events, rows, bits]
    b = _bounds_of("mc", dev)
    sh, tol, rst = b["short"], b["tol"], b["reset"]
    long_g = 2 * sh + tol + 1
    events = ([sh, 2 * sh, sh] * (E + 3), [sh, sh, rst + 1] * (E + 3))
    rows = ([sh, 2 * sh] * (R + 3), [sh, long_g] * (R + 3))
    bits = ([2 * sh, sh] * (4 * BY + 5), [sh] * (8 * BY + 10))
    return [events, rows, bits]


def length_trains(fam, devs, seed, lengths=(1, 31, 32, 33, 1200)):
    """One train of each length in ``lengths``: the family's fuzz trains
    end to end, cut to the length (over one, two and more tiles of 32).
    For OSV1 each fuzz train is a frame whose preamble and sync pass (the
    second of family_trains), so that a train of 14 pulses or more holds
    one event."""
    out = []
    pick = 1 if fam == "osv1" else 0
    for i, n in enumerate(lengths):
        p, g = [], []
        k = 0
        while len(p) < n:
            tp, tg = family_trains(fam, devs, seed + 1000 * i + k,
                                   n=pick + 1)[pick]
            p += tp
            g += tg
            k += 1
        out.append((p[:n], g[:n]))
    return out


# ---- planted trains for DMC and PIWM-DC (thread groups over the symbol
# axis): planted specs whose windows let every case be built, each family's
# edge cases, trains past each cap

# bound columns of the planted specs (samples). DMC's long window reaches
# past its reset threshold (reset - tol = 220), so that a pending mistimed
# symbol can fall through to a 0; PIWM-DC's second spec has a long window
# over its reset limit, so that a bit can also flush
DMC_SPECS = ({"short": 100, "long": 200, "reset": 250, "tol": 30},)
PIWM_DC_SPECS = ({"short": 100, "long": 200, "reset": 250, "tol": 30},
                 {"short": 100, "long": 240, "reset": 250, "tol": 30})
# symbols for them: DMC S in_short, X at d_short == tol, L in_long, F0 in
# long and at the reset threshold, M mistimed below it and in neither
# class, RF a reset in neither class; PIWM-DC ONE, ZERO, RB a non-bit below
# the reset limit, EQ a non-bit at it, OVER a non-bit over it (on the
# second spec, OVER is a 0 over the reset limit)
DMC_SYMS = {"S": 100, "X": 130, "L": 200, "F0": 225, "M": 160, "RF": 400}
PIWM_DC_SYMS = {"ONE": 100, "ZERO": 200, "RB": 150, "EQ": 250, "OVER": 260}


def symbol_edge_bounds(fam):
    """The planted specs of DMC or PIWM-DC (lanes 0 and up), then the
    family's specs in the registry, as ``<fam>_bounds`` gives them."""
    from rtl_433_tpu_torch.ops import slice as sl
    planted = DMC_SPECS if fam == "dmc" else PIWM_DC_SPECS
    reg = getattr(sl, f"{fam}_bounds")(family_devices(fam), RATE)
    out = {k: np.concatenate([np.asarray([p[k] for p in planted],
                                         np.int32), reg[k]])
           for k in ("short", "long", "reset", "tol")}
    out["ok"] = np.concatenate([np.ones(len(planted), bool), reg["ok"]])
    return out


def from_symbols(syms):
    """A train from its interleaved symbols (pulse, gap, pulse, ...)."""
    assert len(syms) % 2 == 0, len(syms)
    return list(syms[0::2]), list(syms[1::2])


def dmc_edges():
    """DMC trains (symbols of DMC_SYMS): in_short runs of 31, 32, 33 and
    64 symbols from offsets 0, 1 and 7 of a tile, each followed by a
    symbol that the run's parity decides (a break where it leaves a 1
    pending, a 0 where not); a pending symbol at exactly d_short == tol
    (consumed; not pending, nothing); a pending mistimed reset in the long
    class (falls through to a 0) and in neither (to a flush); breaks after
    one bit and after many, back to back; flush candidates with nothing
    since the previous one, one opening the train; then all of them in
    one train."""
    S, X, L, F0, M, RF = (DMC_SYMS[k] for k in ("S", "X", "L", "F0", "M",
                                                   "RF"))
    runs = []
    for n in (31, 32, 33, 64):
        for off in (0, 1, 7):
            sy = [L] * off + [S] * n + [L, S, M, RF]
            runs.append(sy + [RF] * (len(sy) % 2))
    exact = [S, X, S, S, X, L, S, X, X, L, L, RF]
    fall = [S, F0, L, S, RF, L, S, F0, S, RF, S, S]
    brk = [S, M, S, M, L, L, S, M, L, S, L, L, S, M, RF, L]
    empty = [RF, RF, S, L, RF, RF, RF, M, RF, L, RF, RF]
    trains = [from_symbols(s) for s in runs + [exact, fall, brk, empty]]
    return trains + [from_symbols(sum(runs + [exact, fall, brk, empty],
                                      []))]


def piwm_dc_edges():
    """PIWM-DC trains (symbols of PIWM_DC_SYMS): the last symbol a break
    that also flushes (the event keeps the row it opened); a bit over the
    reset limit (the second spec: it emits, then flushes); a non-bit at
    exactly the reset limit (nothing where it is not the last symbol);
    breaks with and without bits since the previous candidate; flush
    candidates with nothing since the previous one; then all of them in
    one train."""
    ONE, ZERO, RB, EQ, OVER = (PIWM_DC_SYMS[k] for k in (
        "ONE", "ZERO", "RB", "EQ", "OVER"))
    last_brk = [ONE, ZERO, ONE, RB]
    over = [ONE, OVER, ZERO, ONE, OVER, OVER, ONE, RB, ZERO, OVER]
    at_rst = [ONE, EQ, ZERO, EQ, EQ, ONE, ONE, RB, EQ, ZERO]
    brks = [RB, ONE, RB, RB, ZERO, ZERO, RB, EQ, RB, ONE, OVER, RB]
    empty = [OVER, OVER, ONE, OVER, OVER, RB, OVER, ZERO, OVER, OVER]
    parts = [last_brk, over, at_rst, brks, empty]
    return [from_symbols(s) for s in parts] + [
        from_symbols(sum(parts * 4, []))]


def symbol_cap_trains(fam, caps):
    """Trains past each cap of ``caps`` on their own, for the planted spec
    of DMC or PIWM-DC (lane 0): more events than E, more rows in one event
    than R, more bits in one row than 8 * BY."""
    E, R, BY = caps
    if fam == "dmc":
        S, L, M, RF = (DMC_SYMS[k] for k in ("S", "L", "M", "RF"))
        return [from_symbols([S, S, L, RF] * (E + 3)),
                from_symbols([S, M] * (R + 3) + [L, RF]),
                from_symbols([L, L] * (4 * BY + 5) + [RF, RF])]
    ONE, ZERO, RB, OVER = (PIWM_DC_SYMS[k] for k in ("ONE", "ZERO", "RB",
                                                    "OVER"))
    return [from_symbols([ONE, ZERO, ONE, OVER] * (E + 3)),
            from_symbols([ONE, RB] * (R + 3) + [ONE, OVER]),
            from_symbols([ONE, ZERO] * (4 * BY + 5) + [ONE, OVER])]


# ---- planted trains for PPM (thread groups over the gaps): planted specs
# whose windows let every case be built, the edge cases, trains past each
# cap

# bound columns of the planted specs (samples): spec 0 has every window
# below its reset limit; spec 1 a zero window over it, so that a gap is a
# 0 and a flush candidate at once (zero_u > reset); spec 2 a sync window
# over it
PPM_SPECS = ({"zero_l": 90, "zero_u": 110, "one_l": 190, "one_u": 210,
              "sync_l": 290, "sync_u": 310, "reset": 400},
             {"zero_l": 390, "zero_u": 450, "one_l": 190, "one_u": 210,
              "sync_l": 290, "sync_u": 310, "reset": 400},
             {"zero_l": 90, "zero_u": 110, "one_l": 190, "one_u": 210,
              "sync_l": 390, "sync_u": 450, "reset": 400})
# gaps for them (spec 0): Z a 0, O a 1, SY a sync, RB a row break, RST at
# the reset limit (a flush candidate: the compare is >=), OVER past it, ZB
# over it and in spec 1's zero window (spec 2's sync window); the window
# edges themselves are row breaks (the compares are strict)
PPM_GAPS = {"Z": 100, "O": 200, "SY": 300, "RB": 150, "RST": 400,
            "OVER": 500, "ZB": 420}
PPM_EDGE_GAPS = (90, 110, 190, 210, 290, 310, 399)


def ppm_edge_bounds():
    """The planted PPM specs (lanes 0-2), then the registry's, as
    ``ppm_bounds`` gives them."""
    from rtl_433_tpu_torch.ops import slice as sl
    reg = sl.ppm_bounds(family_devices("ppm"), RATE)
    out = {k: np.concatenate([np.asarray([p[k] for p in PPM_SPECS],
                                         np.int32), reg[k]])
           for k in PPM_SPECS[0]}
    out["ok"] = np.concatenate([np.ones(len(PPM_SPECS), bool), reg["ok"]])
    return out


def _gaps(gaps):
    """A PPM train from its gaps (PPM reads no pulse width)."""
    return [50] * len(gaps), list(gaps)


def ppm_edges():
    """PPM trains (gaps of PPM_GAPS): syncs before any bit, and after bits
    (a new row) at bir 0 again; a row break at row 0 with no bits, which
    touches the event (it flushes two empty rows); flush candidates on an
    untouched event, a sync between them (counted, never flushed on its
    own); a flush on the last pulse after a bit, a row break and a sync;
    gaps on every window edge and at the reset limit; gaps that are a bit
    (spec 1) or a sync (spec 2) and a flush candidate at once; then all of
    them in one train over several tiles."""
    Z, O, SY, RB, RST, OVER, ZB = (PPM_GAPS[k] for k in (
        "Z", "O", "SY", "RB", "RST", "OVER", "ZB"))
    sync0 = [SY, SY, Z, O, SY, SY, Z, O, OVER]
    rb0 = [RB, OVER, RB, RB, Z, OVER, Z, O]
    untouched = [OVER, OVER, SY, OVER, Z, OVER, OVER, SY, RST]
    last = [[Z, O, Z], [Z, O, RB], [Z, O, SY], [SY]]
    edges = [Z, *PPM_EDGE_GAPS, O, RST, Z, O, RST, RST, O]
    both = [O, ZB, O, O, RST, ZB, ZB, SY, O, ZB, O]
    parts = [sync0, rb0, untouched, *last, edges, both]
    return [_gaps(g) for g in parts] + [_gaps(sum(parts * 3, []))]


def ppm_cap_trains(caps):
    """Trains past each cap of ``caps`` on their own, for the planted spec
    0 of PPM (lane 0): more events than E, more rows in one event than R,
    more bits in one row than 8 * BY."""
    E, R, BY = caps
    Z, O, RB, OVER = (PPM_GAPS[k] for k in ("Z", "O", "RB", "OVER"))
    return [_gaps([Z, O, OVER] * (E + 3)),
            _gaps([Z, RB] * (R + 3) + [Z, OVER]),
            _gaps([Z, O] * (4 * BY + 5) + [OVER])]


# ---- planted trains for RZI and OSV1 (thread groups over the pulses):
# planted specs, each family's edge cases, trains past each cap

# bound columns of the planted specs (samples). RZI's spec 0 takes a pulse
# of k long widths (+- half) as k ones, the base offset 50 where a pulse
# does not open a message; spec 1's base of 300 makes num negative for
# short pulses that do not open one. OSV1's spec: hmin 50, hmax 150, a
# sync at 300 or more
RZI_SPECS = ({"short": 50, "long": 100, "reset": 1000, "base": 50},
             {"short": -200, "long": 100, "reset": 1000, "base": 300})
OSV1_SPECS = ({"short": 100, "reset": 1000},)
# OSV1 (pulse, gap) pairs for it: PRE a preamble pulse (phase 0 goes on),
# BRK the preamble's last (its gap over hmax), EDGE a preamble pulse with
# its gap at hmax (no break), BAD below hmin; SY a sync whose gap is the
# longer (a 0, the Manchester bit 1), SYN one whose gap is not, SYF one
# that fails; L/S long and short halves; RST a gap past the reset limit
OSV1_PAIRS = {"PRE": (100, 100), "BRK": (100, 200), "EDGE": (100, 150),
              "BAD": (50, 100), "SY": (350, 400), "SYN": (400, 350),
              "SYF": (250, 400)}
OSV1_RST = 1500


def pulse_edge_bounds(fam):
    """The planted specs of RZI or OSV1 (lanes 0 and up), then the
    family's specs in the registry, as ``<fam>_bounds`` gives them."""
    from rtl_433_tpu_torch.ops import slice as sl
    planted = RZI_SPECS if fam == "rzi" else OSV1_SPECS
    reg = getattr(sl, f"{fam}_bounds")(family_devices(fam), RATE)
    out = {k: np.concatenate([np.asarray([p[k] for p in planted],
                                         np.int32), reg[k]])
           for k in planted[0]}
    out["ok"] = np.concatenate([np.ones(len(planted), bool), reg["ok"]])
    return out


def rzi_edges():
    """RZI trains for the planted specs: runs of 29 to 99 ones that span
    several 32-bit words, share their edge words and pass 320 bits; a
    flush that emits nothing (a reset gap before any 1, twice, and at the
    last pulse); pulses that open a message (after a flush candidate, 1
    one) beside pulses that do not (0 ones); short pulses whose num is
    negative on spec 1; an event of zeros alone; then all of them in one
    train."""
    wide = ([3250, 4000, 2990, 7000, 9999, 6400, 120, 3300],
            [200] * 7 + [1500])
    empty = ([10, 10, 150, 60, 20], [1500, 1500, 200, 1500, 1500])
    start = ([60, 60, 60, 60, 160, 60], [200, 1500, 200, 1500, 200, 1500])
    neg = ([150, 20, 100, 250, 400, 30, 299], [200] * 6 + [1500])
    zeros = ([10, 10, 10, 10], [200, 200, 200, 1500])
    parts = [wide, empty, start, neg, zeros]
    return parts + [tuple(sum((list(t[k]) for t in parts * 3), [])
                          for k in (0, 1))]


def _osv1_frame(pre, sync, data, end_gap):
    """An OSV1 train: the preamble pairs, the sync pair, then the data
    pulses and gaps (widths), the last gap replaced by ``end_gap``."""
    pairs = [OSV1_PAIRS[k] for k in pre] + [OSV1_PAIRS[sync]]
    p = [a for a, _b in pairs] + list(data[0])
    g = [b for _a, b in pairs] + list(data[1])
    if end_gap is not None:
        g[-1] = end_gap
    return p, g


def _osv1_data(rng, n):
    """``n`` Manchester half-bit pulses and gaps, short (100) or long."""
    return ([int(x) for x in rng.choice([100, 200], n)],
            [int(x) for x in rng.choice([100, 200], n)])


def osv1_edges(seed=3):
    """OSV1 trains for the planted spec: preambles of 11, 12 and 13 pulses
    (the break on pulse 10, 11 or 12; only 12 leads to the sync); pulse 11
    passing with its gap at hmax (no break there: phase 0 goes on past
    it); a corrupt preamble (a pulse at hmin); a sync whose gap is not the
    longer (no 0, the first data pulse a 1); a failed sync; a flush at the
    last pulse and at a reset gap (a second frame after it is not read);
    a train that ends on its sync; and frames of more than 320 bits whose
    ones past the row's last bit are added into its last byte (two, and
    over a hundred)."""
    rng = np.random.default_rng(seed)
    pre = ["PRE"] * 11 + ["BRK"]
    d = lambda n: _osv1_data(rng, n)
    trains = [_osv1_frame(["PRE"] * 10 + ["BRK"], "SY", d(20), OSV1_RST),
              _osv1_frame(pre, "SY", d(20), OSV1_RST),
              _osv1_frame(["PRE"] * 12 + ["BRK"], "SY", d(20), OSV1_RST),
              _osv1_frame(["PRE"] * 11 + ["EDGE", "BRK"], "SY", d(20),
                          OSV1_RST),
              _osv1_frame(["PRE"] * 4 + ["BAD"] + ["PRE"] * 6 + ["BRK"],
                          "SY", d(20), OSV1_RST),
              _osv1_frame(pre, "SYN", d(30), OSV1_RST),
              _osv1_frame(pre, "SYF", d(30), OSV1_RST),
              _osv1_frame(pre, "SY", d(40), None),
              _osv1_frame(pre, "SY", (d(9)[0] + [200] + d(30)[0],
                                      d(9)[1] + [OSV1_RST] + d(30)[1]),
                          None),
              _osv1_frame(pre, "SY", ([], []), None)]
    # every pulse a 1 and every gap a 0 (no 0 from the sync): bit 2k is a
    # 1, so 162 pulses put two ones past bit 319, 225 over a hundred
    trains += [_osv1_frame(pre, "SYN", ([200] * n, [200] * n), OSV1_RST)
               for n in (162, 225)]
    trains += [_osv1_frame(pre, "SY", d(260), None)]
    return trains


def pulse_cap_trains(fam, caps):
    """Trains past each cap of ``caps`` that the family can pass, for the
    planted spec 0 of RZI or OSV1 (lane 0); both write row 0 alone, and
    OSV1 at most one event. RZI: more events than E, one pulse whose run
    passes 8 * BY bits, more bits in one row than 8 * BY. OSV1: more than
    8 * BY bits ending on a reset gap, at the last pulse, and with ones
    clipped into the last byte."""
    E, R, BY = caps
    if fam == "rzi":
        return [([150] * (E + 3), [1500] * (E + 3)),
                ([100 * (8 * BY + 20)], [1500]),
                ([150, 60] * (4 * BY + 5), [200] * (8 * BY + 9) + [1500])]
    n = 4 * BY + 8
    pre = ["PRE"] * 11 + ["BRK"]
    return [_osv1_frame(pre, "SY", ([100, 200] * n, [200, 100] * n),
                        OSV1_RST),
            _osv1_frame(pre, "SY", ([100] * 2 * n, [100] * 2 * n), None),
            _osv1_frame(pre, "SYN", ([200] * n, [200] * n), OSV1_RST)]


# ---- planted trains for PCM and NRZS (thread groups over the pulses):
# planted specs, the edge cases of the rate pass and of the step pass,
# trains past each cap

# bound columns of the planted PCM specs (samples): spec 0 RZ (short 10,
# long 30: its run class a pulse of 7-13 whose period is 27-33, its clear a
# pulse off 10 by more than 3), specs 1-3 NRZ at rate seeds of 1/20, 1/26
# and 1/40 (a pulse and a gap of one bit each are a run step); a gap over
# 100 and up to 400 breaks a row, one over 400 is a flush candidate
PCM_SPECS = (
    {"short": 10, "long": 30, "reset": 400, "gap_limit": 100, "tol": 3,
     "max_zeros": 3, "min_count": 4, "is_rz": True, "f0s": 1 / 10,
     "f0l": 1 / 30},
    {"short": 20, "long": 20, "reset": 400, "gap_limit": 100, "tol": 5,
     "max_zeros": 5, "min_count": 12, "is_rz": False, "f0s": 1 / 20,
     "f0l": 1 / 20},
    {"short": 26, "long": 26, "reset": 400, "gap_limit": 100, "tol": 6,
     "max_zeros": 5, "min_count": 12, "is_rz": False, "f0s": 1 / 26,
     "f0l": 1 / 26},
    {"short": 40, "long": 40, "reset": 400, "gap_limit": 100, "tol": 10,
     "max_zeros": 5, "min_count": 12, "is_rz": False, "f0s": 1 / 40,
     "f0l": 1 / 40})
# NRZS: a bit limit of 10 samples, flush candidates at gaps of 100 or more
NRZS_SPECS = ({"short": 10, "reset": 100},)


def pcm_edge_bounds():
    """The planted PCM specs (lanes 0-3), then the registry's, as
    ``pcm_bounds`` gives them."""
    from rtl_433_tpu_torch.ops import slice as sl
    reg = sl.pcm_bounds(family_devices("pcm"), RATE)
    out = {}
    for k, v in reg.items():
        if k == "ok":
            continue
        planted = np.asarray([p[k] for p in PCM_SPECS], v.dtype)
        out[k] = np.concatenate([planted, v])
    out["ok"] = np.concatenate([np.ones(len(PCM_SPECS), bool), reg["ok"]])
    return out


def nrzs_edge_bounds():
    """The planted NRZS spec (lane 0), then the registry's."""
    from rtl_433_tpu_torch.ops import slice as sl
    reg = sl.nrzs_bounds(family_devices("nrzs"), RATE)
    out = {k: np.concatenate([np.asarray([p[k] for p in NRZS_SPECS],
                                         np.int32), reg[k]])
           for k in ("short", "reset")}
    out["ok"] = np.concatenate([np.ones(len(NRZS_SPECS), bool), reg["ok"]])
    return out


def _pairs(*parts):
    """A train from runs of (pulse, gap) pairs: (count, pulse, gap)."""
    p, g = [], []
    for n, a, b in parts:
        p += [a] * n
        g += [b] * n
    return p, g


def pcm_edges():
    """PCM trains for the planted specs. NRZ (spec 1, seed 1/20): three
    runs accepted, two of them inside one tile of 32 pulses, each at a
    width that only the rate the run before accepted puts in the run class
    (24, then 34, then 44 samples a bit; spec 3, seed 1/40, accepts a run
    at 44 first, so that its lane takes a round more), and a run that stays
    below the count (not accepted) between them; an accepted run that
    spans pulses 26-33 (a tile's edge) after pulses out of the class; runs
    of ones over word edges and past the row's bits. RZ (spec 0): two runs
    of equal length, the later accepted too; a clear in a later tile
    erasing an event begun in the tile before, then the event kept from
    the clear on; a clear after a flush in one tile; a clear that is also
    a flush candidate (nothing flushes there); a row break at the last
    pulse (the event flushes with the row it opened); then all of them in
    one train."""
    OUT = (80, 80)                 # out of the NRZ class at every rate here
    nrz3 = _pairs((7, 44, 44), (1, 160, 160), (7, 24, 24), (1, *OUT),
                  (8, 34, 34), (1, 100, 100),
                  (3, 44, 44), (1, *OUT), (9, 44, 44), (1, 44, 150),
                  (3, 88, 44), (1, 132, 500))
    span = _pairs((26, *OUT), (8, 24, 24), (1, *OUT), (8, 34, 34),
                  (2, 68, 68), (1, 34, 500))
    wide = _pairs((6, 24, 24), (1, *OUT), (1, 24 * 37, 24),
                  (1, 24 * 29, 48), (1, 24 * 33, 24), (6, 24 * 40, 24),
                  (1, 24, 500))
    rz_eq = _pairs((5, 10, 20), (1, 10, 60), (5, 11, 21), (1, 10, 60),
                   (4, 10, 20), (6, 10, 50), (1, 10, 500))
    rz_clear = _pairs((5, 10, 20), (38, 10, 50), (1, 24, 20), (10, 10, 80),
                      (1, 10, 500), (3, 10, 50), (1, 10, 500), (2, 10, 20),
                      (1, 24, 20), (3, 10, 50), (1, 10, 500))
    rz_both = _pairs((5, 10, 20), (6, 10, 50), (1, 24, 500), (4, 10, 80),
                     (1, 10, 500), (1, 10, 20), (1, 24, 500))
    rz_last = _pairs((5, 10, 20), (4, 10, 50), (1, 10, 200), (3, 10, 80),
                     (1, 10, 200))
    parts = [nrz3, span, wide, rz_eq, rz_clear, rz_both, rz_last]
    return parts + [tuple(sum((list(t[k]) for t in parts), [])
                          for k in (0, 1))]


def pcm_cap_trains(caps):
    """Trains for the planted RZ spec (lane 0) past each cap of ``caps``
    on its own: more events than E, more rows in one event than R, more
    bits in one row than 8 * BY (a bit a pulse)."""
    E, R, BY = caps
    pre = (5, 10, 20)
    return [_pairs(pre, *[(1, 10, 50), (1, 10, 500)] * (E + 3)),
            _pairs(pre, *[(1, 10, 50), (1, 10, 200)] * (R + 3),
                   (1, 10, 500)),
            _pairs(pre, (8 * BY + 5, 10, 20), (1, 10, 500))]


def nrzs_edges():
    """NRZS trains for the planted spec: pulses at exactly the bit limit
    (no bit), an event of them alone (flushed empty), empty flushes back
    to back, a zero alone, runs of ones over word edges (37, 29, 33 and 40
    ones) and past the row's bits, and the flush at the last pulse; then
    all of them in one train."""
    exact = _pairs((3, 10, 5), (1, 10, 100), (2, 35, 5), (1, 10, 5),
                   (1, 9, 100))
    empty = _pairs((2, 10, 100), (1, 9, 150), (3, 10, 100), (1, 9, 5))
    wide = _pairs((1, 370, 5), (1, 290, 5), (1, 335, 5), (1, 10, 5),
                  (1, 400, 5), (1, 9, 100), (9, 405, 5), (1, 9, 100))
    parts = [exact, empty, wide]
    return parts + [tuple(sum((list(t[k]) for t in parts * 3), [])
                          for k in (0, 1))]


def nrzs_cap_trains(caps):
    """Trains for the planted NRZS spec past each cap it can pass (one row
    an event): more events than E, and more bits in one row than 8 * BY."""
    E, R, BY = caps
    return [_pairs(*[(1, 35, 5), (1, 9, 100)] * (E + 3)),
            _pairs((2 * BY + 3, 45, 5), (1, 9, 100))]

"""Per-sample pulse-detector scan: the CUDA kernel's wrapper and its plain
version.

The scan is the 4-state OOK hysteresis machine (ref
src/pulse_detect.c:199-483) with the classic or min/max FSK tracker (ref
src/pulse_detect_fsk.c) over the filtered am/fm streams of one block. It
emits, per 128-sample chunk, the chunk's ring of committed pulse/gap
records and its EOP metadata: the record log that ``dsp.engine``'s drain
publishes from, in the JAX engine's layout and key encoding.

:func:`detector_scan` launches ``csrc/detector.cu`` for a CUDA tensor and
runs :func:`detector_scan_plain` for a CPU tensor. The plain version is a
sequential loop over Python ints per channel, written in the same order
as the kernel's ``detector_step.cuh``.

Registers travel packed as int32 ``[NREG, C]`` rows in :data:`REG_KEYS`
order (``csrc/detector_step.cuh`` enumerates the same order).

With ``lane_t0`` (int32 ``[C]``) each channel runs from its own block-frame
position (the time-shard segments and hedge candidates of
``parallel/timeshard.py`` as the channels of one launch); the plain version
of such a call is one plain call per distinct origin.

Quiet chunks: the kernel skips the FSM for a chunk in which every channel
of its warp is IDLE and provably stays below threshold
(:func:`quiet_chunk_ok`), running only the noise EWMA
(:func:`quiet_chunk_update`). Both versions return, per channel, the count
of chunks at whose start that channel's own test held, as a diagnostic;
the plain version evaluates the same test but always runs the full step,
so the count checks the kernel's test and the outputs check the soundness
of every skip it took.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

# Detector constants (ref src/pulse_detect.c:23-27, include/pulse_data.h:21-27)
OOK_MAX_HIGH_LEVEL = 16384   # DB_TO_AMP(0)
OOK_EST_HIGH_RATIO = 64
OOK_EST_LOW_RATIO = 1024
PD_MAX_PULSES = 1200
PD_MIN_PULSES = 16
PD_MIN_PULSE_SAMPLES = 10
PD_MIN_GAP_MS = 10
PD_MAX_GAP_MS = 100
PD_MAX_GAP_RATIO = 10

# FSK constants (ref src/pulse_detect_fsk.c:22-24)
FSK_DEFAULT_FM_DELTA = 6000
FSK_EST_SLOW = 64
FSK_EST_FAST = 16

# OOK state machine states (ref src/pulse_detect.c:36-41)
ST_IDLE, ST_PULSE, ST_GAP_START, ST_GAP = 0, 1, 2, 3
# FSK states (ref include/pulse_detect_fsk.h)
FSK_INIT, FSK_FH, FSK_FL, FSK_ERR = 0, 1, 2, 3

# published package types
PKG_NONE, PKG_OOK, PKG_FSK = 0, 1, 2

# out_meta / EOP record field indices
(M_TYPE, M_NUM, M_LOW, M_HIGH, M_F1, M_F2, M_START, M_END, M_GEN) = range(9)
META_FIELDS = 9

# Record key layout (int32): [ fsk | relgen | idx ], relgen = gen - gen0
KEY_IDX_BITS = 12      # idx <= PD_MAX_PULSES < 2^12
KEY_FSK_SHIFT = 1 << 29
KEY_INVALID = 1 << 30

# kernel limits on the per-chunk ring and EOP slots
RING_MAX = 64
EOPS_MAX = 8

# scalar FSM registers, then the 4-deep classic-rewind history
SCALAR_KEYS = (
    "ook_state", "plen", "max_pulse", "lead_in", "low_est", "high_est",
    "min_high", "num", "cur_pulse", "ook_f1", "pkg_start", "eop_spur", "gen",
    "fsk_state", "flen", "f1", "f2", "vmax", "vmin", "skip", "fsk_num",
    "fsk_cur_pulse", "n_ring_ovf", "n_pkg_drop", "n_fsk_ovf")
HIST = 4
REG_KEYS = SCALAR_KEYS + tuple(f"hist_p{i}" for i in range(HIST)) + \
    tuple(f"hist_g{i}" for i in range(HIST))
NREG = len(REG_KEYS)
_NS = len(SCALAR_KEYS)


def pack_regs(state) -> torch.Tensor:
    """Detector-state dict -> int32 [NREG, C] register rows."""
    rows = [state[k].to(torch.int32) for k in SCALAR_KEYS]
    rows += list(state["hist_p"].to(torch.int32).t())
    rows += list(state["hist_g"].to(torch.int32).t())
    return torch.stack(rows).contiguous()


def unpack_regs(regs: torch.Tensor, state) -> dict:
    """int32 [NREG, C] register rows -> updated copy of the state dict."""
    out = dict(state)
    for i, k in enumerate(SCALAR_KEYS):
        out[k] = regs[i]
    out["hist_p"] = regs[_NS:_NS + HIST].t().contiguous()
    out["hist_g"] = regs[_NS + HIST:_NS + 2 * HIST].t().contiguous()
    return out


def _tdiv(a: int, b: int) -> int:
    """C truncating division by a positive constant."""
    return a // b if a >= 0 else -((-a) // b)


def _i32(v: int) -> int:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def quiet_chunk_ok(ook_state, low_est, high_est, min_high, am_max, am_min,
                   fixed, whole=True):
    """Whether a chunk may skip the FSM (csrc/detector_step.cuh
    ``quiet_chunk_ok``): the channel is IDLE, the chunk lies wholly below
    n_valid, and no sample can cross a lower bound of the hysteresis
    threshold. The JAX engine's test (its dsp/engine.py:1110-1125),
    with ``high_est`` also bounding ``high_lb``: never looser. Over such a
    chunk ``low_est`` stays at or above ``min(low_est, am_min) - 1`` and idle
    ``high_est`` at or above ``min_high``, so every sample takes the IDLE
    EWMA branch."""
    if not whole or ook_state != ST_IDLE:
        return False
    low_lb = min(low_est, am_min) - 2
    high_lb = min(high_est, min_high, OOK_MAX_HIGH_LEVEL)
    thr_lb = fixed - 1 if fixed else _tdiv(low_lb + high_lb, 2) - 1
    return thr_lb >= 0 and am_max <= thr_lb


def quiet_chunk_update(low_est, lead_in, min_high, ratio, am_chunk):
    """The quiet path over one chunk: the IDLE noise EWMA (ref
    src/pulse_detect.c:326-333) and nothing else. Returns (low_est,
    high_est, lead_in)."""
    for a in am_chunk:
        d = a - low_est
        low_est = low_est + _tdiv(d, OOK_EST_LOW_RATIO) + (1 if d > 0 else -1)
    lead_in += min(max(OOK_EST_LOW_RATIO + 1 - lead_in, 0), len(am_chunk))
    return low_est, max(ratio * low_est, min_high), lead_in


def _fsk_classic(fm, st, flen, f1, f2, num, cur, hp, hg, ovf):
    """Classic dual-EWMA FSK tracker, one gated sample
    (ref src/pulse_detect_fsk.c:34-141). ``hp``/``hg`` (rewind history,
    newest first) are updated in place. Returns the new registers and the
    committed (idx, pulse, gap) record or None."""
    f1d = abs(fm - f1)
    f2d = abs(fm - f2)
    flen1 = flen + 1
    rec = None
    nflen = flen1
    if st == FSK_INIT:                                   # ref :41-70
        if flen1 < PD_MIN_PULSE_SAMPLES:
            f1 = _tdiv(f1, 2) + _tdiv(fm, 2)
        elif f1d > FSK_DEFAULT_FM_DELTA // 2:
            if fm > f1:              # initial freq was low -> gap first
                st, f2, f1 = FSK_FH, f1, fm
                rec = (0, 0, flen1)
                num, nflen = 1, 0
                hp[:] = [0] + hp[:-1]
                hg[:] = [flen1] + hg[:-1]
            else:                    # pulse first
                st, f2, cur, nflen = FSK_FL, fm, flen1, 0
        else:
            f1 = f1 + _tdiv(fm, FSK_EST_FAST) - _tdiv(f1, FSK_EST_FAST)
    elif st == FSK_FH:                                   # ref :71-99
        if f1d > f2d:
            st = FSK_FL
            if flen1 >= PD_MIN_PULSE_SAMPLES:
                cur, nflen = flen1, 0
            else:                    # rewind: restore the last pair
                nflen = flen1 + hg[0]
                num -= 1
                cur = hp[0]
                if num == 0 and hp[0] == 0:
                    f1, st = f2, FSK_INIT
                hp[:] = hp[1:] + hp[-1:]
                hg[:] = hg[1:] + hg[-1:]
        elif fm > f1:
            f1 = f1 + _tdiv(fm, FSK_EST_FAST) - _tdiv(f1, FSK_EST_FAST)
        else:
            f1 = f1 + _tdiv(fm, FSK_EST_SLOW) - _tdiv(f1, FSK_EST_SLOW)
    elif st == FSK_FL:                                   # ref :100-134
        if f2d > f1d:
            st = FSK_FH
            if flen1 >= PD_MIN_PULSE_SAMPLES:
                rec = (num, cur, flen1)
                hp[:] = [cur] + hp[:-1]
                hg[:] = [flen1] + hg[:-1]
                num, nflen = num + 1, 0
                if num >= PD_MAX_PULSES:
                    num = PD_MAX_PULSES - 1
                    ovf += 1
            else:                    # rewind
                nflen = flen1 + cur
                if num == 0:
                    st = FSK_INIT
        elif fm < f2:
            f2 = f2 + _tdiv(fm, FSK_EST_FAST) - _tdiv(f2, FSK_EST_FAST)
        else:
            f2 = f2 + _tdiv(fm, FSK_EST_SLOW) - _tdiv(f2, FSK_EST_SLOW)
    return st, nflen, f1, f2, num, cur, ovf, rec


def _fsk_minmax(fm, st, flen, f1, f2, num, cur, vmax, vmin, skip, ovf):
    """Min/max FSK tracker, one gated sample
    (ref src/pulse_detect_fsk.c:158-221)."""
    if skip > 0:
        return st, flen, f1, f2, num, cur, vmax, vmin, skip - 1, ovf, None
    vmax = fm if fm > vmax else vmax
    vmin = fm if fm < vmin else vmin
    mid = _tdiv(vmax + vmin, 2)
    if fm > mid:
        vmax -= 10
    if fm < mid:
        vmin += 10
    flen += 1
    rec = None
    if st == FSK_INIT:
        st = FSK_FH if fm > mid else FSK_FL
    elif st == FSK_FH:
        if fm < mid:                 # FH -> FL: store the pulse
            st, cur, flen = FSK_FL, flen, 0
        f2 = f2 + _tdiv(fm, FSK_EST_SLOW) - _tdiv(f2, FSK_EST_SLOW)
    elif st == FSK_FL:
        if fm > mid:                 # FL -> FH: commit the pair
            st = FSK_FH
            rec = (num, cur, flen)
            num, flen = num + 1, 0
            if num >= PD_MAX_PULSES:
                num = PD_MAX_PULSES - 1
                ovf += 1
        f1 = f1 + _tdiv(fm, FSK_EST_SLOW) - _tdiv(f1, FSK_EST_SLOW)
    return st, flen, f1, f2, num, cur, vmax, vmin, skip, ovf, rec


def _scan_channel(am, fm, regs, gen0, *, N, t0, n_valid, chunk, R, E, spm,
                  fixed, ratio, maxp, minmax):
    """One channel's scan over its [N] am/fm Python-int streams.

    Returns (regs, keys [R][G], ring_p [R][G], ring_g [R][G], eops
    {row: meta}, quiet [G]) with rows g*E + slot of the [G*E, 9] EOP log
    and quiet[g] whether :func:`quiet_chunk_ok` held at chunk g's start."""
    (ook_state, plen, max_pulse, lead_in, low_est, high_est, min_high, num,
     cur_pulse, ook_f1, pkg_start, eop_spur, gen, fsk_state, flen, f1, f2,
     vmax, vmin, skip, fsk_num, fsk_cur_pulse, n_ring_ovf, n_pkg_drop,
     n_fsk_ovf) = regs[:_NS]
    hp = list(regs[_NS:_NS + HIST])
    hg = list(regs[_NS + HIST:_NS + 2 * HIST])
    G = N // chunk
    keys = [[KEY_INVALID] * G for _ in range(R)]
    lp = [[0] * G for _ in range(R)]
    lg = [[0] * G for _ in range(R)]
    eops = {}
    ring_idx, ring_p, ring_g, ring_tag = [0] * R, [0] * R, [0] * R, [0] * R
    n_act = min(max(n_valid - t0, 0), N)
    lo_thr = OOK_EST_LOW_RATIO
    quiet = [False] * G
    for g in range(G):
        wpos = 0
        epos = 0
        lo = g * chunk
        if (g + 1) * chunk <= n_act:
            seg = am[lo:lo + chunk]
            quiet[g] = quiet_chunk_ok(ook_state, low_est, high_est, min_high,
                                      max(seg), min(seg), fixed)
        for k in range(g * chunk, min(g * chunk + chunk, n_act)):
            a = am[k]
            t = t0 + k
            s = low_est + (high_est if high_est < OOK_MAX_HIGH_LEVEL
                           else OOK_MAX_HIGH_LEVEL)
            thr = fixed if fixed else (s >> 1 if s >= 0 else -((-s) >> 1))
            hyst = thr >> 3 if thr >= 0 else -((-thr) >> 3)
            above = a > thr + hyst
            st = ook_state
            idle_mask = start_mask = False
            if st == ST_IDLE:
                if above and lead_in > lo_thr:
                    start_mask = True
                else:
                    idle_mask = True
            else:
                f = fm[k]
                below = a < thr - hyst
                rec = None
                fsk_publish = ook_eop = False
                gate = False
                new_st = st
                if st == ST_PULSE:                       # ref :336-375
                    p_len = plen + 1
                    if below:
                        if p_len < PD_MIN_PULSE_SAMPLES:
                            plen = p_len
                            if num <= 1:
                                new_st = ST_IDLE
                            else:
                                eop_spur = 1
                                new_st = ST_GAP
                        else:
                            cur_pulse = p_len
                            if p_len > max_pulse:
                                max_pulse = p_len
                            plen = 0
                            new_st = ST_GAP_START
                    else:
                        h = high_est + _tdiv(a, OOK_EST_HIGH_RATIO) - \
                            _tdiv(high_est, OOK_EST_HIGH_RATIO)
                        high_est = h if h > min_high else min_high
                        ook_f1 = ook_f1 + _tdiv(f, OOK_EST_HIGH_RATIO) - \
                            _tdiv(ook_f1, OOK_EST_HIGH_RATIO)
                        plen = p_len
                    gate = num == 0
                elif st == ST_GAP_START:                 # ref :376-421
                    plen += 1
                    if above:
                        plen += cur_pulse
                        new_st = ST_PULSE
                    elif plen >= PD_MIN_PULSE_SAMPLES:
                        new_st = ST_GAP
                        if fsk_num > PD_MIN_PULSES:
                            fsk_publish = True
                            new_st = ST_IDLE
                    gate = not fsk_publish and num == 0
                else:                                    # GAP, ref :422-469
                    plen += 1
                    g_maxp = g_eop_gap = False
                    if above:
                        rec = (num, cur_pulse, plen, 0)
                        num += 1
                        if num >= maxp:
                            g_maxp = True
                        else:
                            plen = cur_pulse = 0
                            new_st = ST_PULSE
                    if not g_maxp and (
                            eop_spur > 0
                            or (plen > PD_MAX_GAP_RATIO * max_pulse
                                and plen > PD_MIN_GAP_MS * spm)
                            or plen > PD_MAX_GAP_MS * spm):
                        g_eop_gap = True
                        if rec is None:
                            rec = (num, cur_pulse, plen, 0)
                    if g_maxp or g_eop_gap:
                        ook_eop = True
                        ook_final_num = num + 1 if g_eop_gap else num
                        new_st = ST_IDLE
                        eop_spur = 0
                if gate:
                    if minmax:
                        (fsk_state, flen, f1, f2, fsk_num, fsk_cur_pulse,
                         vmax, vmin, skip, n_fsk_ovf, frec) = _fsk_minmax(
                            f, fsk_state, flen, f1, f2, fsk_num,
                            fsk_cur_pulse, vmax, vmin, skip, n_fsk_ovf)
                    else:
                        (fsk_state, flen, f1, f2, fsk_num, fsk_cur_pulse,
                         n_fsk_ovf, frec) = _fsk_classic(
                            f, fsk_state, flen, f1, f2, fsk_num,
                            fsk_cur_pulse, hp, hg, n_fsk_ovf)
                    if frec is not None:
                        rec = frec + (1,)
                if fsk_publish:
                    fsk_final_num = fsk_num
                    if not minmax and fsk_num < maxp:    # classic wrap_up
                        wlen = flen + 1
                        if fsk_state == FSK_FH:
                            rec = (fsk_num, wlen, 0, 1)
                        else:
                            rec = (fsk_num, fsk_cur_pulse, wlen, 1)
                        fsk_final_num = fsk_num + 1
                ook_state = new_st
                if rec is not None:
                    if wpos >= R:
                        n_ring_ovf += 1
                    else:
                        ring_idx[wpos], ring_p[wpos], ring_g[wpos] = rec[:3]
                        ring_tag[wpos] = 1 + rec[3] * 2 + (gen << 2)
                    wpos += 1
                if ook_eop or fsk_publish:
                    if epos >= E:
                        n_pkg_drop += 1
                    elif fsk_publish:
                        eops[g * E + epos] = (PKG_FSK, fsk_final_num, low_est,
                                              high_est, f1, f2, pkg_start, t,
                                              gen)
                    else:
                        eops[g * E + epos] = (PKG_OOK, ook_final_num, low_est,
                                              high_est, ook_f1, 0, pkg_start,
                                              t, gen)
                    epos += 1
                    # the publish sample is processed again in IDLE
                    # (ref src/pulse_detect.c:293-476 returns before the
                    # data_counter increment)
                    if above and lead_in > lo_thr:
                        start_mask = True
                    else:
                        idle_mask = True
            if idle_mask:                                # ref :326-333
                d = a - low_est
                low_est = low_est + _tdiv(d, OOK_EST_LOW_RATIO) + \
                    (1 if d > 0 else -1)
                h = ratio * low_est
                high_est = h if h > min_high else min_high
                if lead_in <= lo_thr:
                    lead_in += 1
            elif start_mask:                             # ref :312-323
                plen = max_pulse = num = cur_pulse = ook_f1 = 0
                pkg_start = t
                gen += 1
                fsk_state, flen, f1, f2 = FSK_INIT, 0, 0, 0
                vmax, vmin, skip = -32768, 32767, 40
                fsk_num = fsk_cur_pulse = 0
                ook_state = ST_PULSE
        # emit the chunk's ring (slots past the write count keep stale
        # pulse/gap values and an invalid key, as in the JAX engine)
        for i in range(R):
            if i < wpos:
                tag = ring_tag[i]
                keys[i][g] = _i32(((tag >> 1) & 1) * KEY_FSK_SHIFT
                                  + ((tag >> 2) - gen0) * (1 << KEY_IDX_BITS)
                                  + ring_idx[i])
            lp[i][g] = ring_p[i]
            lg[i][g] = ring_g[i]
    regs = [ook_state, plen, max_pulse, lead_in, low_est, high_est, min_high,
            num, cur_pulse, ook_f1, pkg_start, eop_spur, gen, fsk_state, flen,
            f1, f2, vmax, vmin, skip, fsk_num, fsk_cur_pulse, n_ring_ovf,
            n_pkg_drop, n_fsk_ovf] + hp + hg
    return regs, keys, lp, lg, eops, quiet


def _scan_args(params, n_valid, t0, N, lane_t0=None):
    ch, R, E = params.chunk, params.ring, params.eops
    if N % ch:
        raise ValueError("detector_scan: N must be a multiple of chunk")
    if not (1 <= R <= RING_MAX and 1 <= E <= EOPS_MAX):
        raise ValueError(f"detector_scan: ring must be 1..{RING_MAX} and "
                         f"eops 1..{EOPS_MAX}")
    if lane_t0 is not None and n_valid is None:
        raise ValueError("detector_scan: lane_t0 needs a block-frame n_valid")
    nv = (t0 + N) if n_valid is None else int(n_valid)
    return dict(chunk=ch, R=R, E=E, spm=params.sample_rate // 1000,
                fixed=params.ook_fixed_high_level,
                ratio=params.ook_high_low_ratio, maxp=params.max_pulses,
                minmax=bool(params.fsk_minmax), n_valid=nv, t0=int(t0))


def detector_scan_plain(am, fm, regs, gen0, *, params, n_valid=None, t0=0,
                        lane_t0=None):
    """Plain version of the kernel; same contract as :func:`detector_scan`.
    With ``lane_t0``, one call per distinct origin."""
    N, C = am.shape
    a = _scan_args(params, n_valid, t0, N, lane_t0)
    R, E = a["R"], a["E"]
    G = N // a["chunk"]
    if lane_t0 is not None:
        outs = [regs.new_empty((NREG, C)), regs.new_empty((C * R, G)),
                regs.new_empty((C * R, G)), regs.new_empty((C * R, G)),
                regs.new_empty((C, G * E, META_FIELDS)), regs.new_empty(C)]
        for lt0, idx in _cuda.origin_groups(lane_t0):
            got = detector_scan_plain(am[:, idx], fm[:, idx], regs[:, idx],
                                      gen0[idx], params=params,
                                      n_valid=n_valid, t0=lt0)
            rows = (idx[:, None] * R + torch.arange(R, device=idx.device)
                    ).reshape(-1)
            outs[0][:, idx] = got[0]
            for o, g in zip(outs[1:4], got[1:4]):
                o[rows] = g
            outs[4][idx] = got[4]
            outs[5][idx] = got[5]
        return tuple(outs)
    am_l = am.t().cpu().tolist()
    fm_l = fm.t().cpu().tolist()
    regs_l = regs.t().cpu().tolist()
    gen0_l = gen0.cpu().tolist()
    new_regs = np.zeros((C, NREG), np.int32)
    log_key = np.zeros((C * R, G), np.int32)
    log_p = np.zeros((C * R, G), np.int32)
    log_g = np.zeros((C * R, G), np.int32)
    eop_log = np.zeros((C, G * E, META_FIELDS), np.int32)
    ok = np.zeros((C, G), bool)
    for j in range(C):
        rg, keys, lp, lg, eops, ok[j] = _scan_channel(
            am_l[j], fm_l[j], regs_l[j], gen0_l[j], N=N, **a)
        new_regs[j] = rg
        log_key[j * R:(j + 1) * R] = keys
        log_p[j * R:(j + 1) * R] = lp
        log_g[j * R:(j + 1) * R] = lg
        for row, meta in eops.items():
            eop_log[j, row] = meta
    quiet = ok.sum(1).astype(np.int32)
    dev = am.device
    return (torch.from_numpy(new_regs.T.copy()).to(dev),
            torch.from_numpy(log_key).to(dev), torch.from_numpy(log_p).to(dev),
            torch.from_numpy(log_g).to(dev), torch.from_numpy(eop_log).to(dev),
            torch.from_numpy(quiet).to(dev))


def detector_scan_cuda(am, fm, regs, gen0, *, params, n_valid=None, t0=0,
                       lane_t0=None):
    """Launch ``csrc/detector.cu``; same contract as :func:`detector_scan`."""
    N, C = am.shape
    dev = am.device
    if not am.is_cuda or am.dtype != torch.int16 or not am.is_contiguous():
        raise ValueError("detector_scan: am must be contiguous CUDA int16 "
                         "[N, C]")
    if fm.shape != am.shape or fm.dtype not in (torch.int16, torch.int32) \
            or fm.device != dev or not fm.is_contiguous():
        raise ValueError("detector_scan: fm must be contiguous int16/int32 "
                         "[N, C] on am's device")
    if regs.shape != (NREG, C) or regs.dtype != torch.int32 \
            or regs.device != dev:
        raise ValueError("detector_scan: regs must be int32 [NREG, C]")
    if gen0.shape != (C,) or gen0.dtype != torch.int32 or gen0.device != dev:
        raise ValueError("detector_scan: gen0 must be int32 [C]")
    a = _scan_args(params, n_valid, t0, N, lane_t0)
    t0v = _cuda.check_lane_t0(lane_t0, C, dev, "detector_scan")
    R, E = a["R"], a["E"]
    G = N // a["chunk"]
    regs = regs.contiguous().clone()
    gen0 = gen0.contiguous()
    log_key = torch.empty((C * R, G), dtype=torch.int32, device=dev)
    log_p = torch.empty((C * R, G), dtype=torch.int32, device=dev)
    log_g = torch.empty((C * R, G), dtype=torch.int32, device=dev)
    eop_log = torch.empty((C, G * E, META_FIELDS), dtype=torch.int32,
                          device=dev)
    quiet = torch.zeros((C,), dtype=torch.int32, device=dev)
    if C and G:
        fn = _cuda.launcher("detector_scan")
        with _cuda.launch_device(am):
            _cuda.LAUNCHES["detector_scan"] += 1
            err = fn(am.data_ptr(), fm.data_ptr(),
                     int(fm.dtype == torch.int32), N, C, regs.data_ptr(),
                     gen0.data_ptr(), log_key.data_ptr(), log_p.data_ptr(),
                     log_g.data_ptr(), eop_log.data_ptr(), quiet.data_ptr(),
                     a["n_valid"], a["t0"],
                     None if t0v is None else t0v.data_ptr(), a["chunk"], R,
                     E, a["spm"], a["fixed"], a["ratio"], a["maxp"],
                     int(a["minmax"]), _cuda.stream_of(am))
        _cuda.check(err, "detector_scan")
    return regs, log_key, log_p, log_g, eop_log, quiet


def detector_scan(am, fm, regs, gen0, *, params, n_valid=None, t0=0,
                  lane_t0=None):
    """Run the detector over one region's filtered streams.

    am: int16 ``[N, C]``; fm: int16 ``[N, C]`` (int32 with FM off: the raw
    envelope); regs: int32 ``[NREG, C]`` (not modified); gen0: int32
    ``[C]``, the block-incoming package generation the record keys are made
    relative to. ``t0`` is the block-frame position of sample 0 and
    ``n_valid`` (block frame) freezes every sample at or past it; with
    ``lane_t0`` (int32 ``[C]``, ``n_valid`` then required) channel ``c``
    starts at ``lane_t0[c]`` instead.

    Returns ``(regs, log_key, log_p, log_g, eop_log, quiet)``: log planes
    int32 ``[C*R, G]`` (row ``c*R + slot``, column = chunk), ``eop_log``
    int32 ``[C, G*E, 9]`` and ``quiet`` int32 ``[C]``, the chunks at whose
    start the channel's :func:`quiet_chunk_ok` held (a diagnostic, not part
    of the state). Launches the CUDA kernel for a CUDA tensor, and runs the
    plain version for a CPU tensor.
    """
    run = detector_scan_cuda if am.is_cuda else detector_scan_plain
    return run(am, fm, regs, gen0, params=params, n_valid=n_valid, t0=t0,
               lane_t0=lane_t0)

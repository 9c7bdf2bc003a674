"""Adversarial inputs for the detector scan's quiet-chunk path, made with
numpy from a seed: each case is filtered am/fm streams plus the registers
to start from, so the kernel and its plain version can be held against
each other on the card (tests/test_torch_cuda.py, chip_smoke.py phase 4).

Every builder returns ``dict(am=int16 [N, C], fm=int16 [N, C],
regs=int32 [NREG, C], gen0=int32 [C], params=DetectorParams,
n_valid=int or None)`` as CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from rtl_433_tpu_torch.dsp.engine import DetectorParams, detector_init
from rtl_433_tpu_torch.ops import detector as det

# samples per batch of the detector's runs (csrc/detector_step.cuh RUN_U)
RUN_U = 8


def _regs(p, C, **rows):
    st = detector_init(p, C, "cpu")
    # the engine raises high_est to min_high at every block start
    st["high_est"] = torch.maximum(st["high_est"], st["min_high"])
    for k, v in rows.items():
        st[k] = torch.full((C,), int(v), dtype=torch.int32)
    return det.pack_regs(st), st["gen"].clone()


def bursts(rng, N, C, *, level=(20, 60), amp=(2000, 8000), gap=(3000, 9000)):
    """Filtered-looking streams: a noise floor with OOK PWM and FSK bursts
    (am high, fm alternating tones) at random times per channel."""
    am = rng.integers(level[0], level[1], (N, C)).astype(np.int16)
    fm = rng.integers(-300, 300, (N, C)).astype(np.int16)
    for c in range(C):
        t = int(rng.integers(200, 3000))
        while t < N - 10000:
            a = int(rng.integers(*amp))
            for _ in range(int(rng.integers(12, 40))):
                w = int(rng.choice([40, 120]))
                am[t:t + w, c] = a + rng.integers(-200, 200, w)
                fm[t:t + w, c] = np.where((np.arange(w) // 25) % 2, 4000,
                                          -4000)
                t += w + int(rng.choice([40, 120]))
            t += int(rng.integers(*gap))
    return am, fm


def case_c33(N, seed=1):
    """33 channels: one full warp group and a group of one."""
    rng = np.random.default_rng(seed)
    p = DetectorParams()
    am, fm = bursts(rng, N, 33)
    regs, gen0 = _regs(p, 33, lead_in=1025)
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


def case_fixed(N, seed=2):
    """The fixed high level (-F style manual override): thr_lb is
    fixed - 1 whatever low_est does."""
    rng = np.random.default_rng(seed)
    p = DetectorParams(fixed_high_level=-20.0)
    am, fm = bursts(rng, N, 4, amp=(800, 3000))
    regs, gen0 = _regs(p, 4, lead_in=1025)
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


def case_ramp(N, seed=3, C=2):
    """A slow ramp of the noise floor whose chunk maximum sits exactly on
    the quiet test's threshold bound thr_lb in even chunks and on
    thr_lb + 1 in odd ones. Built chunk by chunk from the plain scan's
    registers at each chunk start."""
    rng = np.random.default_rng(seed)
    p = DetectorParams()
    ch = p.chunk
    regs, gen0 = _regs(p, C, lead_in=1025, low_est=40)
    am = np.zeros((N, C), np.int16)
    fm = rng.integers(-300, 300, (N, C)).astype(np.int16)
    a = det._scan_args(p, None, 0, ch)
    cur = regs.t().tolist()
    idx = {k: i for i, k in enumerate(det.REG_KEYS)}
    for g in range(N // ch):
        for c in range(C):
            r = cur[c]
            base = 40 + (g * 3) // 8
            seg = rng.integers(base - 4, base + 5, ch)
            low_lb = min(r[idx["low_est"]], int(seg.min())) - 2
            high_lb = min(r[idx["high_est"]], r[idx["min_high"]],
                          det.OOK_MAX_HIGH_LEVEL)
            thr_lb = det._tdiv(low_lb + high_lb, 2) - 1
            seg[int(rng.integers(0, ch))] = thr_lb + (g % 2)
            am[g * ch:(g + 1) * ch, c] = seg
            cur[c] = det._scan_channel(
                am[g * ch:(g + 1) * ch, c].tolist(),
                fm[g * ch:(g + 1) * ch, c].tolist(), r, int(gen0[c]), N=ch,
                **a)[0]
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


def case_mid_nvalid(N, seed=4):
    """n_valid inside a chunk: the chunks wholly below it may be quiet, the
    one it cuts takes the full path, the rest change nothing."""
    rng = np.random.default_rng(seed)
    p = DetectorParams()
    am, fm = bursts(rng, N, 3)
    regs, gen0 = _regs(p, 3, lead_in=1025)
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=N - 3 * p.chunk - 57)


def case_lead_in(N, seed=5):
    """A fresh state whose lead_in crosses 1024 inside a quiet chunk (and,
    in channel 1, exactly at a chunk end)."""
    rng = np.random.default_rng(seed)
    p = DetectorParams()
    am, fm = bursts(rng, N, 2)
    regs, gen0 = _regs(p, 2, low_est=40)
    li = det.REG_KEYS.index("lead_in")
    regs[li, 0] = 1000
    regs[li, 1] = 1025 - 2 * p.chunk
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


def case_wide_ring(N, seed=6):
    """512-sample chunks with a 64-record ring: the kernel's staging plan
    (csrc/detector.cu::plan) narrows its channel groups to 16, so 40
    channels vote in groups of 16, 16 and 8."""
    rng = np.random.default_rng(seed)
    p = DetectorParams(chunk=512, ring=64, eops=4)
    am, fm = bursts(rng, N, 40, gap=(20000, 40000))
    regs, gen0 = _regs(p, 40, lead_in=1025)
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


def case_run_bound(N, seed=7, C=8):
    """Exits of the batched runs (csrc/detector_step.cuh) on every offset of
    a batch. Channel c alternates OOK and FSK packages, starting with OOK
    when c is even. Package q starts at chunk offset c + 5q (mod 8), ending
    an idle run there. The OOK pulse widths and gaps step through every
    residue mod 8, which ends pulse and gap runs at every offset. The last
    OOK pulse is stretched so that the gap-limit EOP falls on offset
    c + 3m (mod 8) of the channel's m-th OOK package. The FSK tone segments
    also step through every residue, which ends FSK runs on tone switches
    at every offset. :func:`run_exits` checks the offsets."""
    rng = np.random.default_rng(seed)
    p = DetectorParams()
    # the end-of-package gap while every pulse is under 250 samples
    lim = det.PD_MIN_GAP_MS * (p.sample_rate // 1000)
    am = rng.integers(36, 45, (N, C)).astype(np.int16)
    fm = rng.integers(-300, 300, (N, C)).astype(np.int16)

    def on(c, t, w, tone=None):
        am[t:t + w, c] = rng.integers(2950, 3050, w)
        if tone is not None:
            fm[t:t + w, c] = tone + rng.integers(-100, 100, w)

    for c in range(C):
        t, m = 300, 0
        for q in range(N):
            t += (c + 5 * q - t) % RUN_U          # the idle run's exit
            if t + 4000 > N:
                break
            if (q + c) % 2 == 0:                  # OOK, 12 pulses
                for i in range(12):
                    w = 14 + (i + c + q) % 8
                    if i == 11:                   # place the gap-limit EOP
                        w += (c + 3 * m - (t + w + lim + 1)) % RUN_U
                    on(c, t, w)
                    t += w + (0 if i == 11 else 24 + (3 * i + c) % 16)
                t += lim + 1 + 300
                m += 1
            else:                                 # FSK, 40 tone segments
                for i in range(40):
                    w = 40 if i == 0 else 16 + (3 * i + c + q) % 16
                    on(c, t, w, 4000 if i % 2 == 0 else -4000)
                    t += w
                t += 300
    regs, gen0 = _regs(p, C, lead_in=1025, low_est=40)
    return dict(am=torch.from_numpy(am), fm=torch.from_numpy(fm), regs=regs,
                gen0=gen0, params=p, n_valid=None)


CASES = {"c33": case_c33, "fixed": case_fixed, "ramp": case_ramp,
         "mid_nvalid": case_mid_nvalid, "lead_in": case_lead_in,
         "wide_ring": case_wide_ring, "run_bound": case_run_bound}

def run_exits(case):
    """Where the kernel's batched runs end, traced with the plain step one
    sample at a time: ``{run: set of (exit - run start) % RUN_U}`` over the
    exits that fall in a whole batch, for the runs idle, gap (ended by a
    pulse), gap_limit (ended by the end-of-package gap), pulse and fsk.

    Mirrors csrc/detector.cu's chunk loop for one lane: each chunk starts
    at k = 0; a run applies by the registers before sample k (the kernel's
    dispatch order) and ends at the first sample that changes the OOK or
    FSK state or emits a record or EOP; that sample and every following one
    to which no run applies take fsm_step."""
    am, fm, regs, gen0, p = (case[k] for k in ("am", "fm", "regs", "gen0",
                                               "params"))
    N, C = am.shape
    ch = p.chunk
    ix = {k: i for i, k in enumerate(det.REG_KEYS)}
    one = det._scan_args(p._replace(chunk=1), None, 0, 1)

    def kind(r):
        st = r[ix["ook_state"]]
        if st == det.ST_IDLE:
            return "idle"
        if st == det.ST_GAP and r[ix["eop_spur"]] == 0:
            return "gap"
        if st == det.ST_GAP_START and r[ix["num"]] > 0:
            return "gap_start"
        if st == det.ST_PULSE and r[ix["num"]] > 0:
            return "pulse"
        if st == det.ST_PULSE and not p.fsk_minmax and \
                r[ix["fsk_state"]] in (det.FSK_FH, det.FSK_FL):
            return "fsk"
        return None

    out = {k: set() for k in ("idle", "gap", "gap_limit", "pulse", "fsk")}
    for c in range(C):
        r = regs[:, c].tolist()
        A, F, g0 = am[:, c].tolist(), fm[:, c].tolist(), int(gen0[c])
        trace = []                    # (run before k, k leaves, state after)
        for k in range(N):
            nr, keys, _, _, eops, _ = det._scan_channel(
                [A[k]], [F[k]], r, g0, N=1, **dict(one, t0=k, n_valid=k + 1))
            leaves = (keys[0][0] != det.KEY_INVALID or bool(eops)
                      or nr[ix["ook_state"]] != r[ix["ook_state"]]
                      or nr[ix["fsk_state"]] != r[ix["fsk_state"]])
            trace.append((kind(r), leaves, nr[ix["ook_state"]]))
            r = nr
        for lo in range(0, N - ch + 1, ch):
            k = 0
            while k < ch:
                run = trace[lo + k][0]
                if run is not None:
                    e = k
                    while e < ch and not trace[lo + e][1]:
                        e += 1
                    if e >= ch:
                        break
                    whole = k + (e - k) // RUN_U * RUN_U + RUN_U <= ch
                    if run == "gap" and trace[lo + e][2] != det.ST_PULSE:
                        run = "gap_limit"
                    if whole and run in out:
                        out[run].add((e - k) % RUN_U)
                    k = e
                k += 1                # fsm_step, then on while no run applies
                while k < ch and trace[lo + k][0] is None:
                    k += 1
    return out

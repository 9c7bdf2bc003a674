"""Fused baseband front-end: the CUDA kernel's wrapper and its plain version.

One pass computes, bit-exactly vs the reference C per-sample loops: the AM
estimator (envelope or 122/51 magnitude estimate), the AM low-pass IIR,
the FM discriminator with integer atan2, the FM low-pass IIR, and the
per-channel envelope sum behind the block-mean dB (ref src/baseband.c).

:func:`frontend` launches ``csrc/frontend.cu`` for a CUDA tensor and runs
:func:`frontend_plain` for a CPU tensor. The plain version computes the
estimator, discriminator and atan2 as vectorized torch and the two IIRs as
a sequential loop over Python ints per channel.

With ``lane_t0`` (int32 ``[C]``) each channel is a region of the block
starting at its own block-frame position and ``n_valid`` is in the block
frame: channel ``c`` has ``clamp(n_valid - lane_t0[c], 0, N)`` valid
samples. The time-shard engine (``parallel/timeshard.py``) runs its
segments as the channels of one launch this way. The plain version of such
a call is one plain call per distinct origin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp import baseband
from . import _cuda

STATE_KEYS = ("lp_y", "lp_x", "fm_y", "fm_phi_prev", "fm_xr", "fm_xi")


def _coeffs(sample_rate, enable_fm, fm_low_pass, fsk_minmax):
    if enable_fm:
        return baseband.fm_coeffs(sample_rate, fm_low_pass, fsk_minmax)
    return 0, 0


def _iir(x, y, px, a1, b, nv):
    """Order-1 Q0.15 IIR over one channel's Python-int stream; carries
    freeze past ``nv`` samples, outputs do not. Returns (out, y, px)."""
    out = [0] * len(x)
    for t, v in enumerate(x):
        o = ((((a1 * y + b * (v + px)) >> 14) & 0xFFFF) ^ 0x8000) - 0x8000
        out[t] = o
        if t < nv:
            y, px = o, v
    return out, y, px


def frontend_plain(iq, st, *, use_mag_est, enable_fm, alp1, blp, n_valid,
                   lane_t0=None):
    """Plain version of the kernel. ``iq`` uint8 [C, N, 2]; ``st`` int32
    [6, C] in :data:`STATE_KEYS` order. Returns (am int16 [N, C], fm int16
    [N, C] or int32 with FM off, new st int32 [6, C], env sum int64 [C]).
    With ``lane_t0``, one call per distinct origin (module docstring)."""
    C, N, _ = iq.shape
    if lane_t0 is not None:
        outs = None
        for t0, idx in _cuda.origin_groups(lane_t0):
            got = frontend_plain(iq[idx], st[:, idx], use_mag_est=use_mag_est,
                                 enable_fm=enable_fm, alp1=alp1, blp=blp,
                                 n_valid=min(max(int(n_valid) - t0, 0), N))
            if outs is None:      # every output has the lanes last
                outs = [g.new_empty(g.shape[:-1] + (C,)) for g in got]
            for o, g in zip(outs, got):
                o[..., idx] = g
        return tuple(outs)
    nv = min(max(int(n_valid), 0), N)
    if use_mag_est:
        env, _ = baseband.magnitude_est_cu8(iq)
    else:
        env, _ = baseband.envelope_detect_cu8(iq)
    env_sum = env.to(torch.int64).sum(-1) & 0xFFFFFFFF
    xr = iq[..., 0].to(torch.int32) - 128
    xi = iq[..., 1].to(torch.int32) - 128
    if enable_fm:
        # the previous-sample operand freezes at the last valid sample
        x1r = torch.cat([st[4][:, None], xr[:, :-1]], 1)
        x1i = torch.cat([st[5][:, None], xi[:, :-1]], 1)
        if nv < N:
            x1r[:, nv:] = (xr[:, nv - 1] if nv else st[4])[:, None]
            x1i[:, nv:] = (xi[:, nv - 1] if nv else st[5])[:, None]
        phi = baseband.atan2_int16(xi * x1r - xr * x1i,
                                   xr * x1r + xi * x1i).to(torch.int32)
        phi_l = phi.cpu().tolist()
    env_l = env.cpu().tolist()
    s = st.cpu().tolist()
    am = np.empty((C, N), np.int16)
    fm = np.empty((C, N), np.int16 if enable_fm else np.int32)
    new = [list(row) for row in s]
    for c in range(C):
        out, new[0][c], new[1][c] = _iir(env_l[c], s[0][c], s[1][c],
                                         baseband.AM_LP_A1, baseband.AM_LP_B,
                                         nv)
        am[c] = out
        if enable_fm:
            out, new[2][c], new[3][c] = _iir(phi_l[c], s[2][c], s[3][c],
                                             alp1, blp, nv)
            fm[c] = out
            if nv:
                new[4][c] = int(xr[c, nv - 1])
                new[5][c] = int(xi[c, nv - 1])
        else:
            fm[c] = env_l[c]
    dev = iq.device
    return (torch.from_numpy(am.T.copy()).to(dev),
            torch.from_numpy(fm.T.copy()).to(dev),
            torch.tensor(new, dtype=torch.int32, device=dev),
            env_sum)


def frontend_cuda(iq, st, *, use_mag_est, enable_fm, alp1, blp, n_valid,
                  lane_t0=None):
    """Launch ``csrc/frontend.cu``; same contract as :func:`frontend_plain`
    (``st`` is not modified; the returned one is new)."""
    if not iq.is_cuda or iq.dtype != torch.uint8 or iq.dim() != 3 \
            or iq.shape[2] != 2 or not iq.is_contiguous():
        raise ValueError("frontend: iq must be a contiguous CUDA uint8 "
                         "[C, N, 2] tensor")
    C, N, _ = iq.shape
    if st.shape != (6, C) or st.dtype != torch.int32 or st.device != iq.device:
        raise ValueError("frontend: state must be int32 [6, C] on iq's device")
    t0v = _cuda.check_lane_t0(lane_t0, C, iq.device, "frontend")
    st = st.contiguous().clone()
    am = torch.empty((N, C), dtype=torch.int16, device=iq.device)
    fm = torch.empty((N, C), dtype=torch.int16 if enable_fm else torch.int32,
                     device=iq.device)
    env_sum = torch.empty((C,), dtype=torch.int32, device=iq.device)
    if C and N:
        fn = _cuda.launcher("frontend")
        with _cuda.launch_device(iq):
            _cuda.LAUNCHES["frontend"] += 1
            err = fn(iq.data_ptr(), C, N, int(n_valid),
                     None if t0v is None else t0v.data_ptr(),
                     int(bool(use_mag_est)), int(bool(enable_fm)),
                     baseband.AM_LP_A1, baseband.AM_LP_B, int(alp1),
                     int(blp), st.data_ptr(), am.data_ptr(), fm.data_ptr(),
                     env_sum.data_ptr(), _cuda.stream_of(iq))
        _cuda.check(err, "frontend")
    else:
        env_sum.zero_()
    return am, fm, st, env_sum.to(torch.int64) & 0xFFFFFFFF


def frontend(iq, state, *, sample_rate, use_mag_est=False, enable_fm=True,
             fm_low_pass=0.0, fsk_minmax=True, time_block=256, n_valid=None,
             time_major=False, lane_t0=None):
    """Run the fused front-end over a CU8 block.

    iq: uint8 ``[C, N, 2]``; state: dict with int32 ``[C]`` keys ``lp_y``,
    ``lp_x``, ``fm_y``, ``fm_phi_prev``, ``fm_xr``, ``fm_xi``.

    Returns ``(am, fm, new_state, avg_db)``: IIR-filtered int16-truncated
    ``am``/``fm`` streams (``[C, N]``, or ``[N, C]`` when ``time_major`` --
    the layout the detector scan reads), plus float32 ``avg_db`` per
    channel. Launches the CUDA kernel for a CUDA tensor, and runs the plain
    version for a CPU tensor. ``time_block`` (the TPU kernel's time tile)
    has no effect: the kernel sizes its own tiles to its shared memory.
    ``lane_t0``: per-channel origins (module docstring); ``n_valid`` is then
    required, in the block frame.
    """
    C, N, _ = iq.shape
    alp1, blp = _coeffs(sample_rate, enable_fm, fm_low_pass, fsk_minmax)
    st = torch.stack([torch.as_tensor(state[k], device=iq.device).to(
        torch.int32) for k in STATE_KEYS])
    if lane_t0 is not None and n_valid is None:
        raise ValueError("frontend: lane_t0 needs a block-frame n_valid")
    nv = N if n_valid is None else int(n_valid)
    run = frontend_cuda if iq.is_cuda else frontend_plain
    am, fm, st, env_sum = run(iq, st, use_mag_est=use_mag_est,
                              enable_fm=enable_fm, alp1=alp1, blp=blp,
                              n_valid=nv, lane_t0=lane_t0)
    if not time_major:
        am, fm = am.t(), fm.t()
    new_state = dict(state)
    for i, k in enumerate(STATE_KEYS):
        new_state[k] = st[i]
    avg_db = baseband.block_avg_db(env_sum, N, use_mag_est)
    return am, fm, new_state, avg_db

"""Baseband DSP ops: AM estimators, integer atan2, FM discriminator, IIR coeffs.

Bit-exact re-implementations (vectorized over ``[..., N]`` sample tensors)
of the reference per-sample loops (ref src/baseband.c): envelope via
``(127-i)^2`` squares (:36), the 122/128-51/128 magnitude estimators (:65,
:96), true magnitudes (:82, :113), the Q0.15 order-1 Butterworth low-pass
(:145), and the FM phase-difference discriminator with ``atan2_int16``
(:181-272) and, for cs16 samples, ``atan2_int32`` (:281-359).

All integer ops use C semantics: int32 arithmetic, truncating division,
arithmetic right shifts, int16 store-truncation. The cs16 functions work
in int64, as their reference does (products of two int16 samples summed,
times the Q0.30 pi/4), and store int32. No path calls them: cs16 and cf32
input is converted to cu8 when it loads. The block sum behind the
mean level is a C ``uint32`` and wraps: a cu8 envelope reaches 32768, and
32768 * 131072 samples is exactly 2^32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# full scale of all AM estimators (ref src/baseband.c:57 "fs 16384")
FS_AMP = 16384

# Q0.15 fixed point (ref src/baseband.c:132-134)
F_SCALE = 15
S_CONST = 1 << F_SCALE


def _fix(x: float) -> int:
    """FIX(x) = (int)(x * 2^15). Ref src/baseband.c:134."""
    return int(x * S_CONST)


# AM low-pass coefficients: butter(1, 0.05), prescaled by /2
# (ref src/baseband.c:151-152)
AM_LP_A1 = _fix(0.85408) >> 1
AM_LP_B = _fix(0.07296) >> 1

_I_PI_4 = 32767 // 4        # 8191
_I_3_PI_4 = 3 * 32767 // 4  # 24575
# the Q0.30 variant's (ref src/baseband.c:281-300)
_I32_PI_4 = 2147483647 // 4        # 536870911
_I32_3_PI_4 = 3 * 2147483647 // 4  # 1610612735


# ---------------------------------------------------------------------------
# dB scaling (ref include/baseband.h:36-46)

def amp_to_db(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return 10.0 * torch.where(x > 0, torch.log10(x), torch.zeros_like(x)) \
        - 42.1442


def mag_to_db(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    return 20.0 * torch.where(x > 0, torch.log10(x), torch.zeros_like(x)) \
        - 84.2884


def db_to_amp(x: float) -> int:
    return int(10.0 ** ((x + 42.1442) / 10.0))


def db_to_mag(x: float) -> int:
    return int(10.0 ** ((x + 84.2884) / 20.0))


def db_to_amp_f(x: float) -> int:
    return int(0.5 + 10.0 ** (x / 10.0))


def db_to_mag_f(x: float) -> int:
    return int(0.5 + 10.0 ** (x / 20.0))


def block_avg_db(s, n: int, use_mag_est: bool):
    """Mean level in dB of a block from its estimator sum ``s`` (any int
    dtype, one value per channel). The sum is reduced to the C uint32 it
    is in the reference before the ``s >= n`` test (ref
    src/baseband.c:41-44)."""
    s = s.to(torch.int64) & 0xFFFFFFFF
    to_db = mag_to_db if use_mag_est else amp_to_db
    ok = (s >= n) if n > 0 else torch.zeros_like(s, dtype=torch.bool)
    mean = s.to(torch.float32) / max(n, 1)
    return torch.where(ok, to_db(mean), to_db(torch.ones_like(mean)))


# ---------------------------------------------------------------------------
# AM estimators. Input: interleaved IQ as uint8 [..., N, 2] (cu8). Output:
# int32 envelope [..., N] (value range fits uint16) plus the block-average dB
# per batch element.

def envelope_detect_cu8(iq):
    """y = (127-I)^2 + (127-Q)^2, fs 16384. Ref src/baseband.c:36-45."""
    x = 127 - iq[..., 0].to(torch.int32)
    y = 127 - iq[..., 1].to(torch.int32)
    env = x * x + y * y
    return env, block_avg_db(env.sum(-1), env.shape[-1], False)


def magnitude_est_cu8(iq):
    """y = 122*max(|I|,|Q|) + 51*min(|I|,|Q|), fs 16384.
    Ref src/baseband.c:65-79."""
    x = (iq[..., 0].to(torch.int32) - 128).abs()
    y = (iq[..., 1].to(torch.int32) - 128).abs()
    mag = 122 * torch.maximum(x, y) + 51 * torch.minimum(x, y)
    return mag, block_avg_db(mag.sum(-1), mag.shape[-1], True)


def magnitude_true_cu8(iq):
    """y = sqrt(I^2+Q^2)*128 truncated to uint16. Ref src/baseband.c:82-93."""
    x = iq[..., 0].to(torch.int32) - 128
    y = iq[..., 1].to(torch.int32) - 128
    mag = (torch.sqrt((x * x + y * y).to(torch.float32)) * 128.0) \
        .to(torch.int32) & 0xFFFF
    return mag, block_avg_db(mag.sum(-1), mag.shape[-1], True)


# cs16 input: interleaved IQ as int16 [..., N, 2]

def magnitude_est_cs16(iq):
    """(122*max+51*min)>>8 of |I|,|Q| int16. Ref src/baseband.c:96-110."""
    x = iq[..., 0].to(torch.int32).abs()
    y = iq[..., 1].to(torch.int32).abs()
    mag = (122 * torch.maximum(x, y) + 51 * torch.minimum(x, y)) >> 8
    return mag, block_avg_db(mag.sum(-1), mag.shape[-1], True)


def magnitude_true_cs16(iq):
    """sqrt(I^2+Q^2)>>1, the sum of squares in int64 (it reaches 2^31).
    Ref src/baseband.c:113-124."""
    x = iq[..., 0].to(torch.int64)
    y = iq[..., 1].to(torch.int64)
    mag = torch.sqrt((x * x + y * y).to(torch.float32)).to(torch.int32) >> 1
    return mag, block_avg_db(mag.sum(-1), mag.shape[-1], True)


# ---------------------------------------------------------------------------
# integer atan2

def _cdiv(n, d):
    """C truncating int32 division (d != 0)."""
    return torch.div(n, d, rounding_mode="trunc")


def atan2_int16(y, x):
    """Self-normalizing integer atan2, pi == INT16_MAX.
    Ref src/baseband.c:181-202."""
    y = torch.as_tensor(y).to(torch.int32)
    x = torch.as_tensor(x).to(torch.int32)
    abs_y = y.abs()
    one = torch.ones_like(x)

    denom_i = abs_y + x
    denom_i = torch.where(denom_i == 0, one, denom_i)
    angle_i = _I_PI_4 - _cdiv(_I_PI_4 * (x - abs_y), denom_i)

    denom_ii = abs_y - x
    denom_ii = torch.where(denom_ii == 0, one, denom_ii)
    angle_ii = _I_3_PI_4 - _cdiv(_I_PI_4 * (x + abs_y), denom_ii)

    angle = torch.where(x >= 0, angle_i, angle_ii)
    angle = torch.where(y < 0, -angle, angle)
    angle = torch.where((x == 0) & (y == 0), torch.zeros_like(angle), angle)
    return angle.to(torch.int16)


def _wrap32(v):
    """An int64 tensor stored to int32, as C's conversion wraps it."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def atan2_int32(y, x):
    """Q0.30 variant used by the CS16 path, in int64 (pi/4 times a
    difference of two sums of int16 products needs 62 bits).
    Ref src/baseband.c:281-300."""
    y = torch.as_tensor(y).to(torch.int64)
    x = torch.as_tensor(x).to(torch.int64)
    abs_y = y.abs()
    one = torch.ones_like(x)

    denom_i = abs_y + x
    denom_i = torch.where(denom_i == 0, one, denom_i)
    angle_i = _I32_PI_4 - _cdiv(_I32_PI_4 * (x - abs_y), denom_i)

    denom_ii = abs_y - x
    denom_ii = torch.where(denom_ii == 0, one, denom_ii)
    angle_ii = _I32_3_PI_4 - _cdiv(_I32_PI_4 * (x + abs_y), denom_ii)

    angle = torch.where(x >= 0, angle_i, angle_ii)
    angle = torch.where(y < 0, -angle, angle)
    return _wrap32(angle)


# ---------------------------------------------------------------------------
# FM discriminator (phase difference), vectorized part. The IIR low-pass
# that follows is a sequential recurrence (front-end kernel, or the
# sequential twins below).

def fm_coeffs(samp_rate: int, low_pass: float, fsk_minmax: bool):
    """Python-side coefficient computation. Ref src/baseband.c:217-231.

    ``low_pass``: >1e4 = Hz, >=1.0 = us, else ratio of fs; 0 selects the
    default 0.2 (minmax) / 0.1 (classic) (ref src/r_flow.c:204).
    Returns (alp1, blp) prescaled-by-2 Q0.15 ints.
    """
    if low_pass == 0.0:
        low_pass = 0.2 if fsk_minmax else 0.1
    if low_pass > 1e4:
        low_pass = low_pass / samp_rate
    elif low_pass >= 1.0:
        low_pass = 1e6 / low_pass / samp_rate
    ita = 1.0 / math.tan(math.pi / 2 * low_pass)
    gain = 1.0 / (1.0 + ita) / 2  # prescaled by div 2
    alp1 = _fix((ita - 1.0) * gain)
    blp = _fix(gain)
    return alp1, blp


def fm_discriminate_cu8(iq, prev_r, prev_i):
    """Instantaneous frequency of CU8 IQ via x[n]*conj(x[n-1]) + atan2_int16.

    Ref src/baseband.c:242-259. ``prev_r/prev_i`` are the last sample of the
    previous block (int32 [...]); returns (phi int16 [..., N], last_r,
    last_i).
    """
    xr = iq[..., 0].to(torch.int32) - 128
    xi = iq[..., 1].to(torch.int32) - 128
    prev_r = torch.as_tensor(prev_r, device=xr.device).to(torch.int32)
    prev_i = torch.as_tensor(prev_i, device=xr.device).to(torch.int32)
    x1r = torch.cat([prev_r[..., None], xr[..., :-1]], dim=-1)
    x1i = torch.cat([prev_i[..., None], xi[..., :-1]], dim=-1)
    pr = xr * x1r + xi * x1i
    pi = xi * x1r - xr * x1i
    phi = atan2_int16(pi, pr)
    return phi, xr[..., -1], xi[..., -1]


def fm_discriminate_cs16(iq, prev_r, prev_i):
    """CS16 variant with atan2_int32, output >>16 later. Ref
    src/baseband.c:335-359. Returns (phi int32 [..., N], last_r, last_i)."""
    xr = iq[..., 0].to(torch.int64)
    xi = iq[..., 1].to(torch.int64)
    prev_r = torch.as_tensor(prev_r, device=xr.device).to(torch.int64)
    prev_i = torch.as_tensor(prev_i, device=xr.device).to(torch.int64)
    x1r = torch.cat([prev_r[..., None], xr[..., :-1]], dim=-1)
    x1i = torch.cat([prev_i[..., None], xi[..., :-1]], dim=-1)
    pr = xr * x1r + xi * x1i
    pi = xi * x1r - xr * x1i
    phi = atan2_int32(pi, pr)
    return phi, xr[..., -1].to(torch.int32), xi[..., -1].to(torch.int32)


def fm_coeffs32(samp_rate: int, low_pass: float, fsk_minmax: bool):
    """Q0.30 coefficients for the CS16 path. Ref src/baseband.c:310-324."""
    if low_pass == 0.0:
        low_pass = 0.2 if fsk_minmax else 0.1
    if low_pass > 1e4:
        low_pass = low_pass / samp_rate
    elif low_pass >= 1.0:
        low_pass = 1e6 / low_pass / samp_rate
    ita = 1.0 / math.tan(math.pi / 2 * low_pass)
    gain = 1.0 / (1.0 + ita)
    alp1 = int((ita - 1.0) * gain * (1 << 30))
    blp = int(gain * (1 << 30))
    return alp1, blp


# ---------------------------------------------------------------------------
# sequential IIR twins over one channel's [N] stream, in Python ints

def _sext16(v: int) -> int:
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def am_lowpass_np(am_raw, y0=0, x0=0):
    """AM low-pass over a [N] int stream (ref src/baseband.c:161-168).
    Returns (filtered int16-truncated array, (y, x) carry)."""
    xs = np.asarray(am_raw, np.int64).tolist()
    out = [0] * len(xs)
    y, x = int(y0), int(x0)
    for n, v_in in enumerate(xs):
        y = _sext16((AM_LP_A1 * y + AM_LP_B * (v_in + x)) >> 14)
        out[n] = y
        x = v_in
    return np.asarray(out, np.int64), (y, x)


def fm_lowpass_np(phi, alp1, blp, y0=0, p0=0):
    """FM low-pass over a [N] int stream (ref src/baseband.c:263-271)."""
    xs = np.asarray(phi, np.int64).tolist()
    out = [0] * len(xs)
    y, p = int(y0), int(p0)
    for n, v_in in enumerate(xs):
        y = _sext16((alp1 * y + blp * (v_in + p)) >> 14)
        out[n] = y
        p = v_in
    return np.asarray(out, np.int64), (y, p)

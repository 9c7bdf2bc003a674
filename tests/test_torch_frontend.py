"""Port front end (rtl_433_tpu_torch.ops.frontend) vs the JAX package.

On the CPU the port's ``frontend`` runs its plain version (the CUDA kernel
runs only on a GPU); the JAX side runs the Pallas kernel in interpret mode,
as tests/test_frontend_kernel.py does, and the non-Pallas baseband path
with FM off. Integer streams and carries must be equal; avg_db within 1e-4
(log10 in two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rtl_433_tpu.dsp import baseband as jb
from rtl_433_tpu.ops.frontend import frontend as jax_frontend
from rtl_433_tpu_torch.ops import frontend as tf

KEYS = tf.STATE_KEYS


def _state(rng, C, zero=False):
    if zero:
        return {k: np.zeros(C, np.int32) for k in KEYS}
    st = {k: rng.integers(-100, 100, C).astype(np.int32) for k in KEYS}
    st["fm_xr"] = rng.integers(-128, 128, C).astype(np.int32)
    st["fm_xi"] = rng.integers(-128, 128, C).astype(np.int32)
    return st


def _both(iq, st, n_valid=None, **kw):
    j = jax_frontend(jnp.asarray(iq), {k: jnp.asarray(v) for k, v in
                                       st.items()},
                     sample_rate=250_000, time_block=64, n_valid=n_valid,
                     **kw)
    t = tf.frontend(torch.from_numpy(iq), {k: torch.from_numpy(v) for k, v
                                           in st.items()},
                    sample_rate=250_000, n_valid=n_valid, **kw)
    return j, t


def _assert_equal(j, t, time_major=False):
    jam, jfm, jst, javg = j
    am, fm, st, avg = t
    assert am.dtype == torch.int16
    assert np.array_equal(am.numpy(), np.asarray(jam))
    assert fm.dtype == (torch.int16 if np.asarray(jfm).dtype == np.int16
                        else torch.int32)
    assert np.array_equal(fm.numpy(), np.asarray(jfm))
    for k in KEYS:
        assert np.array_equal(st[k].numpy(), np.asarray(jst[k])), k
    assert np.allclose(avg.numpy(), np.asarray(javg), atol=1e-4)


@pytest.mark.parametrize("use_mag_est", [False, True])
def test_frontend_matches_pallas(use_mag_est):
    rng = np.random.default_rng(11)
    C, N = 2048, 192
    iq = rng.integers(0, 256, size=(C, N, 2), dtype=np.uint8)
    st = _state(rng, C)
    _assert_equal(*_both(iq, st, use_mag_est=use_mag_est))


@pytest.mark.parametrize("use_mag_est", [False, True])
def test_frontend_n_valid_matches_pallas(use_mag_est):
    """Carries freeze at the last valid sample; the whole output, tail
    included, matches the kernel's."""
    rng = np.random.default_rng(5)
    C, N = 2048, 128
    iq = rng.integers(0, 256, size=(C, N, 2), dtype=np.uint8)
    st = _state(rng, C, zero=True)
    _assert_equal(*_both(iq, st, n_valid=77, use_mag_est=use_mag_est))


def test_frontend_time_major_and_minmax_coeffs():
    rng = np.random.default_rng(8)
    C, N = 256, 128
    iq = rng.integers(0, 256, size=(C, N, 2), dtype=np.uint8)
    st = _state(rng, C)
    j, t = _both(iq, st, fsk_minmax=False, time_major=True)
    assert t[0].shape == (N, C)
    _assert_equal(j, t)


@pytest.mark.parametrize("use_mag_est", [False, True])
def test_frontend_fm_off_matches_baseband_path(use_mag_est):
    """FM off: fm is the raw int32 estimator output (the union alias the
    non-Pallas engine path feeds the detector), am its low-pass, and the
    discriminator carries do not move."""
    rng = np.random.default_rng(9)
    C, N = 3, 1000
    iq = rng.integers(0, 256, size=(C, N, 2), dtype=np.uint8)
    st = _state(rng, C)
    am, fm, nst, avg = tf.frontend(
        torch.from_numpy(iq), {k: torch.from_numpy(v) for k, v in st.items()},
        sample_rate=250_000, use_mag_est=use_mag_est, enable_fm=False)
    est = jb.magnitude_est_cu8 if use_mag_est else jb.envelope_detect_cu8
    env, javg = est(jnp.asarray(iq))
    env = np.asarray(env)
    assert fm.dtype == torch.int32
    assert np.array_equal(fm.numpy(), env)
    for c in range(C):
        want, (y, x) = jb.am_lowpass_np(env[c], st["lp_y"][c], st["lp_x"][c])
        assert np.array_equal(am[c].numpy().astype(np.int64), want)
        assert (int(nst["lp_y"][c]), int(nst["lp_x"][c])) == (y, x)
    for k in ("fm_y", "fm_phi_prev", "fm_xr", "fm_xi"):
        assert np.array_equal(nst[k].numpy(), st[k])
    assert np.allclose(avg.numpy(), np.asarray(javg), atol=1e-4)


def test_frontend_refuses_cpu_fallback_for_bad_input():
    """The CUDA wrapper checks its input before any launch."""
    iq = torch.zeros((2, 128, 2), dtype=torch.uint8)
    st = torch.zeros((6, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tf.frontend_cuda(iq, st, use_mag_est=False, enable_fm=True, alp1=0,
                         blp=0, n_valid=128)

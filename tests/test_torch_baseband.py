"""Port baseband ops (rtl_433_tpu_torch.dsp.baseband) vs the JAX package.

Same seeded numpy inputs through both; integer outputs must be equal, the
float dB levels within 1e-4 (log10 in two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rtl_433_tpu.dsp import baseband as jb
from rtl_433_tpu_torch.dsp import baseband as tb


def _iq(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def test_constants_match():
    for k in ("FS_AMP", "F_SCALE", "S_CONST", "AM_LP_A1", "AM_LP_B"):
        assert getattr(tb, k) == getattr(jb, k), k


@pytest.mark.parametrize("x", [-50.0, -12.1442, -3.0, 0.0, 9.0, 20.0])
def test_db_to_int_conversions(x):
    for fn in ("db_to_amp", "db_to_mag", "db_to_amp_f", "db_to_mag_f"):
        assert getattr(tb, fn)(x) == getattr(jb, fn)(x), fn


@pytest.mark.parametrize("fn", ["amp_to_db", "mag_to_db"])
def test_to_db(fn):
    x = np.array([0.0, 1.0, 2.5, 100.0, 16384.0, 32768.0], np.float32)
    got = getattr(tb, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jb, fn)(jnp.asarray(x)))
    assert np.allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("fn", ["envelope_detect_cu8", "magnitude_est_cu8"])
@pytest.mark.parametrize("seed,shape", [(0, (3, 1000, 2)), (1, (2, 4096, 2)),
                                        (2, (1, 7, 2))])
def test_estimators_random(fn, seed, shape):
    iq = _iq(seed, shape)
    env, avg = getattr(tb, fn)(torch.from_numpy(iq))
    jenv, javg = getattr(jb, fn)(jnp.asarray(iq))
    assert env.dtype == torch.int32
    assert np.array_equal(env.numpy(), np.asarray(jenv))
    assert np.allclose(avg.numpy(), np.asarray(javg), atol=1e-4)


@pytest.mark.parametrize("fn", ["envelope_detect_cu8", "magnitude_est_cu8"])
@pytest.mark.parametrize("value", [0, 255])
def test_estimators_full_scale_block_wraps_uint32(fn, value):
    """A 131072-sample block at full scale: the envelope sum is exactly
    2^32 for I=Q=255 and wraps to 0 in the reference's uint32."""
    iq = np.full((1, 131072, 2), value, np.uint8)
    env, avg = getattr(tb, fn)(torch.from_numpy(iq))
    jenv, javg = getattr(jb, fn)(jnp.asarray(iq))
    assert np.array_equal(env.numpy(), np.asarray(jenv))
    assert np.allclose(avg.numpy(), np.asarray(javg), atol=1e-4)
    if fn == "envelope_detect_cu8" and value == 255:
        assert int(env.to(torch.int64).sum()) == 1 << 32
        assert np.allclose(avg.numpy(), np.asarray(jb.amp_to_db(1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_atan2_int16(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(-32768, 32769, 5000).astype(np.int32)
    x = rng.integers(-32768, 32769, 5000).astype(np.int32)
    y[:50] = 0
    x[25:75] = 0
    x[100:150] = -np.abs(y[100:150])     # abs_y - x denominators
    x[150:200] = np.abs(y[150:200])
    got = tb.atan2_int16(torch.from_numpy(y), torch.from_numpy(x))
    want = np.asarray(jb.atan2_int16(jnp.asarray(y), jnp.asarray(x)))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_fm_discriminate(seed):
    rng = np.random.default_rng(seed)
    iq = _iq(seed, (4, 777, 2))
    pr = rng.integers(-128, 128, 4).astype(np.int32)
    pi = rng.integers(-128, 128, 4).astype(np.int32)
    phi, lr, li = tb.fm_discriminate_cu8(torch.from_numpy(iq),
                                         torch.from_numpy(pr),
                                         torch.from_numpy(pi))
    jphi, jlr, jli = jb.fm_discriminate_cu8(jnp.asarray(iq), jnp.asarray(pr),
                                            jnp.asarray(pi))
    assert np.array_equal(phi.numpy(), np.asarray(jphi))
    assert np.array_equal(lr.numpy(), np.asarray(jlr))
    assert np.array_equal(li.numpy(), np.asarray(jli))


@pytest.mark.parametrize("rate", [250_000, 1_024_000])
@pytest.mark.parametrize("low_pass", [0.0, 0.05, 100.0, 30_000.0])
@pytest.mark.parametrize("minmax", [False, True])
def test_fm_coeffs(rate, low_pass, minmax):
    assert tb.fm_coeffs(rate, low_pass, minmax) == \
        jb.fm_coeffs(rate, low_pass, minmax)


@pytest.mark.parametrize("seed", [5, 6])
def test_sequential_lowpass_twins(seed):
    rng = np.random.default_rng(seed)
    am_raw = rng.integers(0, 32769, 3000)
    got, gc = tb.am_lowpass_np(am_raw, 123, 456)
    want, wc = jb.am_lowpass_np(am_raw, 123, 456)
    assert np.array_equal(got, want) and gc == wc
    phi = rng.integers(-32768, 32768, 3000)
    alp1, blp = jb.fm_coeffs(250_000, 0.0, False)
    got, gc = tb.fm_lowpass_np(phi, alp1, blp, -7, 99)
    want, wc = jb.fm_lowpass_np(phi, alp1, blp, -7, 99)
    assert np.array_equal(got, want) and gc == wc

"""The cs16 baseband functions of the port (rtl_433_tpu_torch.dsp.baseband)
against the JAX package's, run under ``jax.enable_x64``.

The functions state int64 intermediates, as their reference does
(ref src/baseband.c:113-124, :281-359). JAX runs without x64 by default,
so there its int64 silently becomes int32 and the Q0.30 products wrap;
the last case witnesses that (a fault of the JAX package, ROADMAP Queue 3).
The integer outputs must be equal; the block levels go through log10 and
agree within 1e-4 dB.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_433_tpu.dsp import baseband as jb
from rtl_433_tpu_torch.dsp import baseband as tb

SEED = 20261018


def _cs16(seed, shape):
    iq = np.random.default_rng(seed).integers(-32768, 32768, size=shape,
                                              dtype=np.int16)
    # full scale on both rails: the sum of squares reaches 2^31
    edge = np.array([[-32768, -32768], [32767, -32768], [0, 0], [-1, 1]])
    n = min(4, shape[-2])
    iq[..., :n, :] = edge[:n]
    return iq


def _jax(fn, *args):
    with jax.enable_x64(True):
        return [np.asarray(v) for v in fn(*[jnp.asarray(a) for a in args])]


@pytest.mark.parametrize("seed,shape", [(0, (3, 1000, 2)), (1, (1, 7, 2)),
                                        (2, (2, 4096, 2))])
@pytest.mark.parametrize("fn", ["magnitude_true_cu8", "magnitude_est_cs16",
                                "magnitude_true_cs16"])
def test_magnitudes_match_jax(fn, seed, shape):
    if fn.endswith("cu8"):
        iq = np.random.default_rng(seed).integers(0, 256, size=shape,
                                                  dtype=np.uint8)
        iq[..., :2, :] = [[0, 0], [255, 128]]
    else:
        iq = _cs16(seed, shape)
    mag, avg = getattr(tb, fn)(torch.from_numpy(iq))
    jmag, javg = _jax(getattr(jb, fn), iq)
    assert mag.dtype == torch.int32 and mag.shape == shape[:-1]
    assert np.array_equal(mag.numpy(), jmag)
    assert np.allclose(avg.numpy(), javg, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_atan2_int32_matches_jax(seed):
    rng = np.random.default_rng([SEED, seed])
    # the range of the discriminator's products: sums of two int16 squares
    y = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64)
    x = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64)
    y[:50] = 0
    x[25:75] = 0
    x[100:150] = -np.abs(y[100:150])     # abs_y - x denominators of 0
    x[150:200] = np.abs(y[150:200])
    x[200:210] = -(1 << 31)
    y[210:220] = -(1 << 31)
    got = tb.atan2_int32(torch.from_numpy(y), torch.from_numpy(x))
    want, = _jax(lambda a, b: (jb.atan2_int32(a, b),), y, x)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", [(0, (2, 3000, 2)), (1, (1, 1, 2)),
                                        (2, (4, 257, 2))])
def test_fm_discriminate_cs16_matches_jax(seed, shape):
    iq = _cs16(seed, shape)
    rng = np.random.default_rng([SEED, seed, 1])
    prev = rng.integers(-32768, 32768, size=(2, shape[0])).astype(np.int32)
    got = tb.fm_discriminate_cs16(torch.from_numpy(iq),
                                  torch.from_numpy(prev[0]),
                                  torch.from_numpy(prev[1]))
    want = _jax(jb.fm_discriminate_cs16, iq, prev[0], prev[1])
    assert [g.dtype for g in got] == [torch.int32] * 3
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("rate", [250_000, 1_024_000, 2_048_000])
@pytest.mark.parametrize("low_pass", [0.0, 0.05, 0.3, 10.0, 150.0, 20_000.0,
                                      120_000.0])
@pytest.mark.parametrize("minmax", [False, True])
def test_fm_coeffs32_matches_jax(rate, low_pass, minmax):
    assert tb.fm_coeffs32(rate, low_pass, minmax) == \
        jb.fm_coeffs32(rate, low_pass, minmax)


def test_jax_default_truncates_the_int64_intermediates():
    """Without x64, JAX warns and computes the Q0.30 products in int32:
    three cs16 samples after a zero carry give other phases than the
    function's own int64 arithmetic, which the port computes."""
    iq = np.array([[30000, -20000], [-32768, 32767], [12345, -31000]],
                  np.int16)
    zero = np.int32(0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        default = np.asarray(jb.fm_discriminate_cs16(
            jnp.asarray(iq), jnp.asarray(zero), jnp.asarray(zero))[0])
    assert any("Explicitly requested dtype int64" in str(m.message)
               for m in w)
    x64, = _jax(lambda a, b, c: jb.fm_discriminate_cs16(a, b, c)[:1],
                iq, zero, zero)
    port = tb.fm_discriminate_cs16(torch.from_numpy(iq), 0, 0)[0].numpy()
    assert default.tolist() == [536870911, 1610612735, 1610612735]
    assert x64.tolist() == port.tolist() == [536870911, 1968538508,
                                             1824399095]

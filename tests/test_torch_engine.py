"""Port engine (rtl_433_tpu_torch.dsp.engine.process_block) vs the JAX
engine: the whole state dict after each block, key by key.

Covers every combination of fsk_minmax, use_mag_est and enable_fm, flush
on and off, a block split with the state carried across through
dsp.convert, the seeded multi-channel block of
tests/test_frontend_kernel.py, >2^17-sample segmentation, and a noisy
input that overflows the ring, the package slots and the FSK pulse buffer.
"""

import numpy as np
import pytest

from rtl_433_tpu.dsp import engine as je

from synth import synth_ook, synth_fsk, pwm_pulses, fsk_pcm_bits
from torch_parity import check_block, pad_block

PWM_SIG = lambda: synth_ook(
    pwm_pulses("110010101001", short_us=264, long_us=744, gap_short_us=744,
               gap_long_us=264, reset_us=12000, repeats=3),
    rate=250_000, lead_in_us=20_000, tail_us=120_000)

FSK_SIG = lambda: synth_fsk(
    fsk_pcm_bits("1100101011110000" * 4, bit_us=100),
    rate=250_000, lead_in_us=16_000, tail_us=120_000, seed=7)


def _mixed():
    return np.concatenate([PWM_SIG(), FSK_SIG()])


@pytest.mark.parametrize("fsk_minmax", [False, True])
@pytest.mark.parametrize("use_mag_est", [False, True])
@pytest.mark.parametrize("enable_fm", [False, True])
def test_combinations_flush(fsk_minmax, use_mag_est, enable_fm):
    params = je.DetectorParams(fsk_minmax=fsk_minmax,
                               use_mag_est=use_mag_est, enable_fm=enable_fm)
    iq, n = pad_block(_mixed())
    js, ts = check_block(params, iq, n_valid=n, flush=True)
    assert int(ts["out_n"].sum()) > 0


@pytest.mark.parametrize("n_valid", [None, 30_000])
def test_no_flush(n_valid):
    """Without flush the open package stays in the carry."""
    params = je.DetectorParams(fsk_minmax=True)
    iq, _ = pad_block(_mixed()[:40_064])
    js, ts = check_block(params, iq, n_valid=n_valid, flush=False)
    assert int(np.abs(ts["carry_p"]).sum()) > 0 or int(ts["out_n"].sum())


@pytest.mark.parametrize("sig,split,kw", [
    ("pwm", 6_000, {}),
    ("pwm", 13_337, {}),
    ("fsk", 5_000, dict(fsk_minmax=False)),
])
def test_split_block_state_carried(sig, split, kw):
    """Block A through the JAX engine; its state (numpy) starts both
    engines on block B, which must agree. The split lies inside a
    package, so the cross-block carry is exercised."""
    params = je.DetectorParams(**kw)
    full = PWM_SIG() if sig == "pwm" else FSK_SIG()
    a, na = pad_block(full[:split])
    b, nb = pad_block(full[split:])
    js, _ = check_block(params, a, n_valid=na, flush=False)
    assert int(np.abs(js["carry_p"]).sum() + np.abs(js["carry_g"]).sum()) \
        or int(js["ook_state"][0]) != 0
    js2, ts2 = check_block(params, b, n_valid=nb, flush=True, state=js)
    assert int(ts2["out_n"].sum()) > 0


def test_seeded_multichannel_block():
    """tests/test_frontend_kernel.py:95-120: 2048 channels of low-level
    noise with bursts on every 19th channel, a full block (no n_valid)."""
    rng = np.random.default_rng(3)
    C, N = 2048, 2048
    iq = rng.integers(120, 136, size=(C, N, 2), dtype=np.uint8)
    for c in range(0, C, 19):
        for k in range(3):
            s = 200 + k * 500
            iq[c, s:s + 220, :] = rng.integers(10, 246, size=(220, 2),
                                               dtype=np.uint8)
    check_block(je.DetectorParams(sample_rate=250_000), iq, flush=False)


def test_segmented_long_block():
    """Blocks over 2^17 samples are processed as segments (int32 record
    keys); the segment boundary falls inside the signal."""
    sig = np.concatenate([PWM_SIG()] * 4)          # ~165k samples
    iq, n = pad_block(sig)
    assert iq.shape[1] > 1 << 17
    js, ts = check_block(je.DetectorParams(pkg_cap=16), iq, n_valid=n - 77,
                         flush=True)
    assert int(ts["out_n"].sum()) >= 4


def test_noisy_overflow_counters():
    """Dense FSK on a 2-slot ring, more packages than pkg_cap, and an FSK
    package longer than 1200 pairs: n_ring_ovf, n_pkg_drop and n_fsk_ovf
    are all non-zero and equal in both engines."""
    long_fsk = synth_fsk(fsk_pcm_bits("10" * 1300, bit_us=60, preamble=""),
                         rate=250_000, lead_in_us=16_000, tail_us=30_000,
                         noise=6.0, seed=5)
    sig = np.concatenate([long_fsk, PWM_SIG(), PWM_SIG()])
    params = je.DetectorParams(fsk_minmax=False, ring=2, pkg_cap=1)
    iq, n = pad_block(sig)
    js, ts = check_block(params, iq, n_valid=n, flush=True)
    for k in ("n_ring_ovf", "n_pkg_drop", "n_fsk_ovf"):
        assert int(ts[k].sum()) > 0, k

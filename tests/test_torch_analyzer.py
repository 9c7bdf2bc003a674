"""The port's pulse analyzer (``-A``, rtl_433_tpu_torch.pulse.analyzer)
against the JAX package's.

One synthetic pulse train per branch of ``analyze_pulses``' modulation
guess (single pulse, un-modulated, PPM, PWM with a fixed gap, PWM with a
fixed period, Manchester, PWM with multiple packets, PCM, PWM with sync,
no clue), OOK and FSK, and seeded random trains: both packages'
``PulseData`` are built from the same numpy arrays, and the analyzer's
text, the ``pd.gap`` it leaves, ``analyzer_check`` and the RfRaw hint must
be equal. Then ``-A`` through both CLIs on one capture (the file's one JAX
trace): the same exit code, stdout and stderr.
"""

import io
import os
import sys

import numpy as np
import pytest

from rtl_433_tpu import cli as jcli
from rtl_433_tpu.pulse import analyzer as jan
from rtl_433_tpu.pulse.data import PulseData as JPulseData
from rtl_433_tpu_torch import cli as tcli
from rtl_433_tpu_torch.pulse import analyzer as tan
from rtl_433_tpu_torch.pulse.data import PulseData as TPulseData

sys.path.insert(0, os.path.dirname(__file__))
from torch_replay_cases import fixture, run_cli  # noqa: E402

SEED = 20261018
OOK, FSK = 1, 2


def _jitter(rng, widths, spread=3):
    w = np.asarray(widths, np.int64)
    return (w + rng.integers(-spread, spread + 1, w.shape)).tolist()


def _bits(rng, n):
    return rng.integers(0, 2, n)


def _train(kind, rng):
    """(pulses, gaps) whose histograms reach ``kind``'s branch."""
    n = 40
    b = _bits(rng, n)
    if kind == "single":
        return [480], [9000]
    if kind == "unmodulated":
        return _jitter(rng, [250] * n), _jitter(rng, [250] * (n - 1)) \
            + [9000]
    if kind == "ppm":
        return (_jitter(rng, [125] * n),
                _jitter(rng, np.where(b, 500, 250)[:-1]) + [9000])
    if kind == "pwm_fixed_gap":
        return (_jitter(rng, np.where(b, 375, 125)),
                _jitter(rng, [250] * (n - 1)) + [9000])
    if kind == "pwm_fixed_period":
        p = np.where(b, 375, 125)
        return _jitter(rng, p), _jitter(rng, (500 - p)[:-1]) + [9000]
    if kind == "manchester":
        # every (pulse, gap) of {1, 2} x {1, 2} units: three periods
        p = np.where(b, 250, 125)
        g = np.where(_bits(rng, n), 250, 125)
        g[:4] = [125, 250, 125, 250]
        p[:4] = [125, 125, 250, 250]
        return _jitter(rng, p), _jitter(rng, g[:-1]) + [9000]
    if kind == "pwm_packets":
        g = np.full(n, 250)
        g[n // 3] = 2000
        g[2 * n // 3] = 5000
        return (_jitter(rng, np.where(b, 375, 125)),
                _jitter(rng, g[:-1]) + [9000])
    if kind == "pcm":
        u = 100
        p = rng.integers(1, 4, n) * u
        g = rng.integers(1, 4, n) * u
        p[:3], g[:3] = [u, 2 * u, 3 * u], [u, 2 * u, 3 * u]
        return _jitter(rng, p, 2), _jitter(rng, g[:-1], 2) + [9000]
    if kind == "pwm_sync":
        p = np.where(b, 375, 125)
        p[0] = 1500
        return _jitter(rng, p), _jitter(rng, [250] * (n - 1)) + [9000]
    if kind == "no_clue":
        p = rng.choice([100, 330, 1100, 3600], n)
        g = rng.choice([150, 700, 2600], n)
        p[:4] = [100, 330, 1100, 3600]
        return _jitter(rng, p), _jitter(rng, g[:-1]) + [9000]
    raise ValueError(kind)


BRANCHES = {
    "single": "Single pulse detected",
    "unmodulated": "Un-modulated signal",
    "ppm": "Pulse Position Modulation with fixed pulse width",
    "pwm_fixed_gap": "Pulse Width Modulation with fixed gap",
    "pwm_fixed_period": "Pulse Width Modulation with fixed period",
    "manchester": "Manchester coding",
    "pwm_packets": "Pulse Width Modulation with multiple packets",
    "pcm": "Non Return to Zero coding (Pulse Code)",
    "pwm_sync": "Pulse Width Modulation with sync/delimiter",
    "no_clue": "No clue...",
}


def _pds(pulse, gap, rate=250_000, fsk=False):
    kw = dict(sample_rate=rate, ook_low_estimate=120,
              ook_high_estimate=9000,
              fsk_f1_est=4100 if fsk else 0,
              fsk_f2_est=-2900 if fsk else 0)
    out = []
    for cls in (JPulseData, TPulseData):
        # lists of their own: the analyzer writes the last gap
        pd = cls(pulse=[int(v) for v in pulse], gap=[int(v) for v in gap],
                 **kw)
        pd.calc_rssi_snr(rate, 433_920_000)
        out.append(pd)
    return out


def _analyze(mod, pd, kind):
    buf = io.StringIO()
    check = mod.analyzer_check(pd)
    mod.analyze_pulses(pd, kind, out=buf)
    h = mod._histograms(pd) if pd.pulse else ()
    return buf.getvalue(), list(pd.gap), check, [
        [(b.count, b.sum, b.mean, b.min, b.max) for b in hist.bins]
        for hist in h]


@pytest.mark.parametrize("fsk", [False, True], ids=["ook", "fsk"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches_jax(branch, fsk):
    rng = np.random.default_rng([SEED, len(branch)])
    pulse, gap = _train(branch, rng)
    jpd, tpd = _pds(pulse, gap, fsk=fsk)
    want = _analyze(jan, jpd, FSK if fsk else OOK)
    got = _analyze(tan, tpd, FSK if fsk else OOK)
    assert got == want
    text = got[0]
    assert ("Guessing modulation: " + BRANCHES[branch]) in text
    if branch not in ("single", "unmodulated", "no_clue"):
        assert "Attempting demodulation" in text
        # PPM is guessed as OOK_PULSE_PPM for either kind of package
        assert ("FSK_" in text) == (fsk and branch != "ppm")
    if branch in ("ppm", "pwm_fixed_gap", "manchester"):
        assert "view at https://triq.org/pdv/#AAB1" in text


def test_empty_train_matches_jax():
    jpd, tpd = _pds([], [])
    assert _analyze(tan, tpd, OOK) == _analyze(jan, jpd, OOK)
    assert _analyze(tan, tpd, OOK)[0] == "No pulses detected.\n"


@pytest.mark.parametrize("seed", range(12))
def test_random_trains_match_jax(seed):
    rng = np.random.default_rng([SEED, 99, seed])
    n = int(rng.integers(1, 120))
    units = rng.choice([60, 120, 250, 500, 1000, 4000], 3 + seed % 4)
    pulse = rng.choice(units, n) + rng.integers(-8, 9, n)
    gap = rng.choice(units, n) + rng.integers(-8, 9, n)
    pulse, gap = np.maximum(pulse, 1), np.maximum(gap, 1)
    rate = (250_000, 1_024_000)[seed % 2]
    jpd, tpd = _pds(pulse, gap, rate=rate, fsk=seed % 3 == 0)
    kind = FSK if seed % 3 == 0 else OOK
    assert _analyze(tan, tpd, kind) == _analyze(jan, jpd, kind)


def test_cli_analyzer_matches_jax():
    """-A on a capture: the analyzer's text on stderr after each package's
    events, byte for byte, in both CLIs."""
    argv = ["-R", "19", "-r", fixture("nexus"), "-A"]
    port = run_cli(tcli.main, argv + ["--device", "cpu"])
    jax = run_cli(jcli.main, argv)
    assert port == jax
    rc, out, err = port
    assert rc == 0 and '"Nexus-TH"' in out
    assert "Guessing modulation: Pulse Position Modulation" in err
    assert "Use a flex decoder with -X 'n=name,m=OOK_PPM," in err

"""Port detector scan (rtl_433_tpu_torch.ops.detector) + drain vs the JAX
engine, on the tests/test_detector.py scenarios.

On the CPU the scan runs its plain version, the same step order as the
CUDA kernel's csrc/detector_step.cuh. The record logs must equal the JAX
``_block_scan``'s slot for slot, and the whole state after
``process_block`` must equal the JAX engine's key for key.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.dsp.convert import params_from_jax, state_from_numpy
from rtl_433_tpu_torch.ops import detector as td

from synth import synth_ook, synth_fsk, pwm_pulses, ppm_pulses, fsk_pcm_bits
from torch_parity import check_block, pad_block

PWM_SIG = lambda: synth_ook(
    pwm_pulses("110010101001", short_us=264, long_us=744, gap_short_us=744,
               gap_long_us=264, reset_us=12000, repeats=3),
    rate=250_000, lead_in_us=20_000, tail_us=120_000)

PPM_SIG = lambda: synth_ook(
    ppm_pulses("10110010", pulse_us=500, gap_zero_us=1000, gap_one_us=2000,
               reset_us=6000, repeats=2),
    rate=250_000, lead_in_us=20_000, tail_us=120_000, seed=3)

FSK_SIG = lambda: synth_fsk(
    fsk_pcm_bits("1100101011110000" * 4, bit_us=100),
    rate=250_000, lead_in_us=16_000, tail_us=120_000, seed=7)


def _rewind_sig():
    """FSK frame with a spurious 32 us mark early in a 2000 us space: the
    classic tracker commits, rewinds and re-commits the same record index
    several chunks later (tests/test_detector.py::_rewind_sig)."""
    segs = []
    for _ in range(10):
        segs += [(200, True), (200, False)]
    segs += [(200, True), (200, False), (32, True), (2000, False)]
    for _ in range(10):
        segs += [(200, True), (200, False)]
    return synth_fsk(segs, rate=250_000, lead_in_us=16_000, tail_us=120_000,
                     seed=11)


SCENARIOS = {
    "pwm": (PWM_SIG, {}),
    "ppm": (PPM_SIG, {}),
    "fsk_classic": (FSK_SIG, dict(fsk_minmax=False)),
    "fsk_minmax": (FSK_SIG, dict(fsk_minmax=True)),
    "rewind": (_rewind_sig, dict(fsk_minmax=False)),
    "wide_drain": (lambda: np.concatenate([PWM_SIG(), FSK_SIG(), PPM_SIG()]),
                   dict(pkg_cap=8, chunk=512, ring=64, eops=4)),
    "small_arena": (_rewind_sig, dict(arena=1024)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_process_block_state_matches_jax(name):
    sig, kw = SCENARIOS[name]
    params = je.DetectorParams(**kw)
    iq, n = pad_block(sig(), params.chunk)
    js, ts = check_block(params, iq, n_valid=n, flush=True)
    assert int(js["out_n"].sum()) > 0


def test_empty_signal_no_packages():
    params = je.DetectorParams()
    iq = np.full((1, 8192, 2), 128, np.uint8)
    js, ts = check_block(params, iq, flush=True)
    assert int(ts["out_n"].sum()) == 0


def test_multichannel_shifted_copies():
    params = je.DetectorParams()
    one, n = pad_block(PWM_SIG())
    iq = np.concatenate([one, np.full_like(one, 128),
                         np.roll(one, 1024, axis=1), one])
    js, ts = check_block(params, iq, n_valid=n, flush=True)
    assert list(ts["out_n"]) == [ts["out_n"][0], 0, ts["out_n"][0],
                                 ts["out_n"][0]]


def _jax_logs(params, state, iq, n_valid):
    C = iq.shape[0]

    def f(st, x, nv):
        regs = dict(st)
        regs["high_est"] = jnp.maximum(regs["high_est"], regs["min_high"])
        regs["eop_spur"] = jnp.zeros_like(regs["eop_spur"])
        regs["pkg_start"] = regs["pkg_start"] - nv
        regs.update(je._empty_ring(params, C))
        return je._block_scan(params, regs, x, nv, regs["gen"])

    out = jax.jit(f)({k: jnp.asarray(v) for k, v in state.items()},
                     jnp.asarray(iq), jnp.int32(n_valid))
    return jax.tree.map(np.asarray, out)


def _port_logs(params, state, iq, n_valid):
    st = state_from_numpy(state, "cpu")
    regs = dict(st)
    regs["high_est"] = torch.maximum(regs["high_est"], regs["min_high"])
    regs["eop_spur"] = torch.zeros_like(regs["eop_spur"])
    regs["pkg_start"] = regs["pkg_start"] - n_valid
    out = te._block_scan(params_from_jax(params), regs, torch.from_numpy(iq),
                         n_valid, regs["gen"].clone())
    return out[0], [t.numpy() for t in out[1:]]


@pytest.mark.parametrize("name,kw", [
    ("pwm", dict()),
    ("fsk_classic", dict(fsk_minmax=False)),
    ("fsk_minmax", dict(fsk_minmax=True, enable_fm=True)),
    ("rewind_fm_off", dict(enable_fm=False)),
])
def test_block_scan_logs_match_jax(name, kw):
    """Kernel 2's contract: exactly the record logs of the JAX scan
    (keys, pulse/gap planes including stale slots, EOP metadata)."""
    sig = {"pwm": PWM_SIG, "fsk_classic": FSK_SIG, "fsk_minmax": FSK_SIG,
           "rewind_fm_off": _rewind_sig}[name]
    params = je.DetectorParams(**kw)
    iq, n = pad_block(sig())
    state = {k: np.asarray(v) for k, v in je.detector_init(params, 1).items()}
    jr, jkey, jp, jg, jeop, javg = _jax_logs(params, state, iq, n)
    tr, (tkey, tp, tg, teop, tavg) = _port_logs(params, state, iq, n)
    assert (jkey < je._KEY_INVALID).sum() > 0
    assert np.array_equal(jkey, tkey)
    assert np.array_equal(jp, tp)
    assert np.array_equal(jg, tg)
    assert np.array_equal(jeop, teop)
    ring = set(je._empty_ring(params, 1))
    for k, v in jr.items():
        if k not in ring:
            assert np.array_equal(v, tr[k].numpy()), k


def test_kernel_register_order_matches_header():
    """csrc/detector_step.cuh enumerates the packed register rows in the
    order of ops/detector.py::REG_KEYS."""
    path = os.path.join(os.path.dirname(td.__file__), "..", "csrc",
                        "detector_step.cuh")
    src = open(path).read()
    body = re.search(r"enum Reg \{(.*?)\};", src, re.S).group(1)
    names = [t.strip().split("=")[0].strip() for t in body.split(",")]
    scalars = [n for n in names if n and not n.startswith(("R_HIST", "NREG"))]
    assert [n[2:].lower() for n in scalars] == list(td.SCALAR_KEYS)
    assert td.NREG == len(td.SCALAR_KEYS) + 2 * td.HIST
    for k in ("RING_MAX", "EOPS_MAX", "KEY_IDX_BITS", "META_FIELDS",
              "PD_MAX_PULSES"):
        m = re.search(rf"constexpr int {k} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(td, k), k


def test_detector_scan_wrapper_checks_inputs():
    params = te.DetectorParams()
    am = torch.zeros((128, 1), dtype=torch.int16)
    regs = torch.zeros((td.NREG, 1), dtype=torch.int32)
    gen0 = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        td.detector_scan_cuda(am, am, regs, gen0, params=params)
    with pytest.raises(ValueError):
        td.detector_scan_plain(am[:100], am[:100], regs, gen0, params=params)


# ---- the quiet-chunk test (the kernel's skip of idle chunks)


def _idle_regs(low, high, min_high, lead_in):
    st = te.detector_init(te.DetectorParams(), 1, "cpu")
    st.update(low_est=torch.tensor([low], dtype=torch.int32),
              high_est=torch.tensor([high], dtype=torch.int32),
              min_high=torch.tensor([min_high], dtype=torch.int32),
              lead_in=torch.tensor([lead_in], dtype=torch.int32))
    return td.pack_regs(st)[:, 0].tolist()


def _check_quiet_chunk(draw, event):
    """One drawn IDLE state and chunk: when quiet_chunk_ok holds, the full
    plain step over the chunk ends in the quiet update's registers and
    emits no record or EOP."""
    from hypothesis import strategies as hst
    ratio = 8
    low = draw(hst.one_of(hst.integers(-40, 2500), hst.integers(-5, 20)),
               label="low_est")
    min_high = draw(hst.one_of(hst.integers(0, 18000), hst.integers(0, 30)),
                    label="min_high")
    high = draw(hst.one_of(hst.just(max(ratio * low, min_high)),
                           hst.integers(-100, 20000)), label="high_est")
    lead_in = draw(hst.one_of(hst.integers(1000, 1030),
                              hst.integers(0, 2000)), label="lead_in")
    fixed = draw(hst.sampled_from([0, 0, 0, 1, 9, 400, 2500]), label="fixed")
    spread = draw(hst.integers(0, 400), label="spread")
    center = low + draw(hst.integers(-30, 30), label="offset")
    am = [min(max(center + d, -32768), 32767) for d in draw(
        hst.lists(hst.integers(-spread, spread), min_size=128, max_size=128),
        label="noise")]
    # put the chunk maximum on the threshold bound or just above it
    low_lb = min(low, min(am)) - 2
    high_lb = min(high, min_high, td.OOK_MAX_HIGH_LEVEL)
    thr_lb = fixed - 1 if fixed else td._tdiv(low_lb + high_lb, 2) - 1
    if draw(hst.booleans(), label="on_bound") and \
            min(am) <= thr_lb + 1 <= 32767:
        am[draw(hst.integers(0, 127), label="at")] = \
            thr_lb + draw(hst.integers(0, 3), label="delta")
    if not td.quiet_chunk_ok(td.ST_IDLE, low, high, min_high, max(am),
                             min(am), fixed):
        event("not quiet")
        return
    event("quiet: full step checked")
    regs = _idle_regs(low, high, min_high, lead_in)
    a = dict(chunk=128, R=8, E=2, spm=250, fixed=fixed, ratio=ratio,
             maxp=td.PD_MAX_PULSES, minmax=False, n_valid=128, t0=0)
    got, keys, _, _, eops, quiet = td._scan_channel(
        am, [0] * 128, regs, 0, N=128, **a)
    assert quiet == [True]
    assert all(k == td.KEY_INVALID for row in keys for k in row)
    assert not eops
    want = list(regs)
    want[td.REG_KEYS.index("low_est")], want[td.REG_KEYS.index("high_est")], \
        want[td.REG_KEYS.index("lead_in")] = td.quiet_chunk_update(
            low, lead_in, min_high, ratio, am)
    assert got == want


def test_quiet_chunk_ok_is_sound():
    """A hypothesis property over random IDLE states and 128-sample chunks,
    lead_in near 1024, low_est near the chunk minimum, the fixed level and
    the chunk maximum on the threshold bound and one above it."""
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as hst

    @hyp.settings(max_examples=400, deadline=None)
    @hyp.given(data=hst.data())
    def prop(data):
        _check_quiet_chunk(data.draw, hyp.event)

    prop()


def test_plain_quiet_count_noise_and_bursts():
    """Every chunk of an all-noise block is quiet; a block with bursts
    has fewer in every channel."""
    from torch_scan_cases import _regs, bursts
    p = te.DetectorParams()
    N, C = 32768, 3
    G = N // p.chunk
    rng = np.random.default_rng(6)
    regs, gen0 = _regs(p, C, lead_in=1025, low_est=40)
    noise = torch.from_numpy(rng.integers(20, 60, (N, C)).astype(np.int16))
    out = td.detector_scan_plain(noise, noise, regs, gen0, params=p)
    assert out[5].tolist() == [G] * C
    am, fm = bursts(rng, N, C, gap=(1500, 3000))
    out = td.detector_scan_plain(torch.from_numpy(am), torch.from_numpy(fm),
                                 regs, gen0, params=p)
    assert all(0 < q < G for q in out[5].tolist())


def test_run_bound_case_exits_on_every_batch_offset():
    """The run_bound case of tests/torch_scan_cases.py makes every batched
    run of csrc/detector_step.cuh leave at each of the 8 offsets of a batch
    (pulse ends, gap ends, the gap limit, FSK tone switches, pulse starts),
    traced sample by sample through the plain step."""
    from torch_scan_cases import RUN_U, case_run_bound, run_exits
    exits = run_exits(case_run_bound(16384))
    for kind in ("idle", "gap", "gap_limit", "pulse", "fsk"):
        assert exits[kind] == set(range(RUN_U)), (kind, exits[kind])

"""Multi-channel RtlTpu and the noise floor, against the JAX package.

``RtlTpu(channels=4, device="cpu")`` and the JAX package's
``RtlTpu(channels=4)`` take the same 3-block [C, N, 2] stream: the same
events in order, frame counters and overflow counters. Squelch, ``-M
noise`` reports and autolevel run on a single-channel stream whose level
steps down, pushed block by block (the squelch prescreen) and replayed from
a file (the engine's own block level): after every block the noise floor
and the autolevel-adjusted minimum level agree with JAX's to 1e-4 dB, and
everything discrete is equal: which frames were squelched, how often the
minimum level was moved, the detector's integer minimum level and the
events. (The block level is a float32 dB value; the port's is the
correctly rounded one, while XLA's CPU float32 log10 is not correctly
rounded, so the two differ in the last bits on some blocks and the noise
floors carry that difference: a test below shows it block by block.) The
CLI options of the noise floor are tested in tests/test_torch_io_cli.py.
bench.py's blocks, rebuilt without the JAX package for chip_smoke.py,
equal bench.py's own.
"""

import json

import numpy as np
import pytest

import bench
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json

import torch_bench_blocks
from synth import fsk_pcm_bits, ppm_pulses, pwm_pulses, synth_fsk, synth_ook

def _place(stream, sig, at):
    stream[at:at + sig.shape[0]] = sig[:stream.shape[0] - at]


def _four_channels(n=120_000):
    """ch 0: a Nexus PPM burst across both block edges; ch 1: Silvercrest
    PWM bursts, one across an edge; ch 2: LaCrosse TX35 FSK bursts; ch 3:
    noise only."""
    rng = np.random.default_rng(5)
    iq = rng.integers(124, 132, size=(4, n, 2), dtype=np.uint8)
    v = (0x9C << 28) | (1 << 27) | (1 << 24) | (215 << 12) | (0xF << 8) | 45
    _place(iq[0], synth_ook(ppm_pulses(format(v, "036b"), pulse_us=500,
                                       gap_zero_us=1000, gap_one_us=2000,
                                       reset_us=4000, repeats=4),
                            rate=250_000, seed=1), 20_000)
    for at, cmd in ((3_000, 5), (52_000, 9)):
        _place(iq[1], torch_bench_blocks.silvercrest_burst(cmd, seed=at), at)
    for at, id_ in ((10_000, 17), (70_000, 42)):
        _place(iq[2], torch_bench_blocks.lacrosse_burst(
            id_, (2, 1, 5), 55, seed=at), at)
    return iq


# Nexus-TH, Silvercrest, LaCrosse TX35 and TX29
PROTOCOLS = (19, 1, 75, 76)


def _counters(rx):
    st = rx._state
    return {k: int(np.asarray(st[k].cpu() if hasattr(st[k], "cpu")
                              else st[k]).sum())
            for k in ("n_ring_ovf", "n_fsk_ovf", "n_pkg_drop")}


def test_four_channels_match_jax():
    iq = _four_channels()
    port = RtlTpu(channels=4, report_time="off", register_all=False,
                  device="cpu")
    jrx = JaxRtlTpu(channels=4, report_time="off", register_all=False)
    for rx in (port, jrx):
        for num in PROTOCOLS:
            rx.registry.register(num)
    got, want = [], []
    for b in range(3):
        blk = iq[:, b * 40_000:(b + 1) * 40_000]
        n = port.push_block(blk)
        jn = jrx.push_block(blk)
        assert n == jn
        got.append([event_to_json(e) for e in port.events])
        want.append([jax_event_to_json(e) for e in jrx.events])
        assert got[-1] == want[-1], b
        assert port.frames_count == jrx.frames_count == b + 1
        assert port.frames_events == jrx.frames_events
        assert _counters(port) == _counters(jrx)
        assert (port._ovf_seen, port._drop_seen) == \
            (jrx._ovf_seen, jrx._drop_seen)
    assert port._params.pkg_cap == jrx._params.pkg_cap == 32
    models = [e.fields[0][1] for e in port.events]
    assert models.count("Nexus-TH") == 1
    assert models.count("Silvercrest-Remote") == 2
    assert models.count("LaCrosse-TX35DTHIT") == 2


def test_many_channels_keep_the_small_package_cap():
    rx = RtlTpu(channels=32, device="cpu", register_all=False)
    rx.registry.register(19)
    rx._ensure_pipeline()
    assert rx._params.pkg_cap == 8
    assert rx._state["out_p"].shape == (32, 8, 1200)


def test_multichannel_refused_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RtlTpu(channels=4)


def _stepping_stream(blocks=10, n=65_536, bursts=3):
    """One channel: loud noise for three blocks, then quiet noise; a
    Silvercrest burst in each of the last ``bursts`` blocks."""
    rng = np.random.default_rng(9)
    out = []
    for b in range(blocks):
        half = 48 if b < 3 else 3
        blk = rng.integers(128 - half, 128 + half, size=(n, 2),
                           dtype=np.uint8)
        if b >= blocks - bursts:
            _place(blk, torch_bench_blocks.silvercrest_burst(b, seed=b),
                   5_000)
        out.append(blk)
    return out


def _noise_kw():
    return dict(squelch=True, report_noise=1, auto_level=1,
                register_all=False, report_time="off")


def _noise_trace(rx):
    return (rx.noise_level, rx.min_level_auto, rx.total_frames_squelch,
            rx.frames_count, int(np.asarray(
                rx._state["min_high"].cpu() if hasattr(
                    rx._state["min_high"], "cpu")
                else rx._state["min_high"])[0]))


def _assert_traces(got, want):
    for (g, w) in zip(got, want):
        assert abs(g[0] - w[0]) <= 1e-4 and abs(g[1] - w[1]) <= 1e-4
        assert g[2:] == w[2:]


def _relevels(rx, calls):
    real = rx._relevel

    def counted():
        calls.append(rx.min_level_auto)
        return real()
    rx._relevel = counted


def test_squelch_and_autolevel_live_blocks_match_jax(capsys):
    """push_block without a file: the squelch prescreen decides from
    channel 0's block level; noise-only frames are skipped."""
    port = RtlTpu(device="cpu", **_noise_kw())
    jrx = JaxRtlTpu(**_noise_kw())
    for rx in (port, jrx):
        rx.registry.register(1)  # Silvercrest
    calls, jcalls = [], []
    _relevels(port, calls)
    _relevels(jrx, jcalls)
    got, want = [], []
    for blk in _stepping_stream():
        port.push_block(blk)
        jrx.push_block(blk)
        got.append(_noise_trace(port))
        want.append(_noise_trace(jrx))
    _assert_traces(got, want)
    assert len(calls) == len(jcalls) >= 1
    assert np.allclose(calls, jcalls, rtol=0, atol=1e-4)
    assert port.total_frames_squelch == jrx.total_frames_squelch >= 3
    assert [event_to_json(e) for e in port.events] == \
        [jax_event_to_json(e) for e in jrx.events]
    assert port.events
    err = capsys.readouterr().err
    assert "adjusting minimum detection level" in err


def _rounded_level(s, n):
    """The block level 10*log10(s/n) - 42.1442 in float32 with every step
    correctly rounded: the division in float32 (exact IEEE), log10 in
    float64 rounded once to float32, then the product and the difference
    in float32."""
    f32 = np.float32
    mean = f32(f32(s) / f32(n))
    return float(f32(f32(f32(10.0) * f32(np.log10(np.float64(mean))))
                     - f32(42.1442)))


def test_block_level_differs_from_jax_only_by_its_log10():
    """The witness for the 1e-4 dB tolerance above: on every block of the
    stepping streams the port's block level is the correctly rounded
    float32 value of the same integer envelope sum, and on at least one
    block the JAX package's is not, because its float32 log10 is not
    correctly rounded (its division and the sum agree exactly)."""
    import jax.numpy as jnp
    import torch
    from rtl_433_tpu.dsp import baseband as jbb
    from rtl_433_tpu_torch.dsp import baseband as bb
    off = []
    for blocks in (_stepping_stream(),
                   _stepping_stream(blocks=6, n=131_072, bursts=2)):
        for blk in blocks:
            n = blk.shape[0]
            env, db = bb.envelope_detect_cu8(torch.from_numpy(blk[None]))
            jenv, jdb = jbb.envelope_detect_cu8(jnp.asarray(blk[None]))
            s = int(env.to(torch.int64).sum())
            assert s == int(np.asarray(jenv, np.int64).sum())
            want = _rounded_level(s, n)
            assert float(db[0]) == want
            got = float(np.asarray(jdb)[0])
            assert abs(got - want) <= 1e-4
            if got != want:
                mean = np.float32(np.float32(s) / np.float32(n))
                assert float(jnp.float32(s) / n) == float(mean)
                assert float(jnp.log10(jnp.float32(mean))) != \
                    float(np.float32(np.log10(np.float64(mean))))
                off.append(s)
    assert off


def test_noise_floor_on_file_replay_matches_jax(tmp_path):
    """decode_file never squelches; the noise floor follows the engine's
    block level of channel 0, and autolevel retunes the detector."""
    path = tmp_path / "step_250k.cu8"
    blocks = _stepping_stream(blocks=6, n=131_072, bursts=2)
    np.concatenate(blocks).tofile(path)
    traces = []
    for cls, kw in ((RtlTpu, {"device": "cpu"}), (JaxRtlTpu, {})):
        rx = cls(**_noise_kw(), **kw)
        rx.registry.register(1)
        trace = []
        real = rx.push_block

        def push(*a, _rx=rx, _real=real, _t=trace, **k):
            n = _real(*a, **k)
            _t.append(_noise_trace(_rx))
            return n
        rx.push_block = push
        evs = rx.decode_file(str(path))
        traces.append((trace, [json.loads(j) for j in map(
            event_to_json if cls is RtlTpu else jax_event_to_json, evs)]))
    (got, port_ev), (want, jax_ev) = traces
    assert len(got) == len(blocks)
    _assert_traces(got, want)
    assert got[-1][2] == 0                       # nothing squelched
    assert got[-1][4] != got[0][4]               # the level was retuned
    assert port_ev == jax_ev and port_ev


def test_bench_blocks_equal_bench_py():
    """The blocks chip_smoke.py builds are bench.py's, byte for byte."""
    want, nw = bench.build_blocks(24, 49_152, 4)
    got, ng = torch_bench_blocks.build_blocks(24, 49_152, 4)
    assert ng == nw == 6
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    kinds = {torch_bench_blocks.burst_of(c, 4) for c in range(24)}
    assert kinds == {None, (0, "lacrosse"), (1, "lacrosse"),
                     (2, "lacrosse"), (3, "lacrosse"), (0, "silvercrest")}

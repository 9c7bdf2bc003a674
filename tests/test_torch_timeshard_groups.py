"""The port's time sharding over meshes of several distinct devices.

A time-shard mesh whose entries are not all one device splits its
segments into groups, one per distinct entry, each with its own front-end
and detector calls; the chain runs on the mesh's first device
(rtl_433_tpu_torch.parallel.timeshard). ``torch.device("cpu")`` and
``torch.device("cpu", 0)`` are two entries of one CPU, so
``[cpu] * 4 + [cpu:0] * 4`` makes two groups here, as ``[cuda] * 4 +
[cuda:0] * 4`` does on one card: every line of the grouped path runs but
the copies between two memories.

Each grouped step (``debug=True``) is held exactly to the port's one-group
step on ``[cpu] * 8`` over tests/test_torch_timeshard.py's scenarios:
``ok``, the per-link failure flags, every state key and ``avg_db``; and
the grouped TimeShardEngine to the one-group engine: packages, fallbacks,
verified blocks and the state after every block. tests/test_torch_timeshard.py
holds the one-group step to the JAX package's; here a verified and a
failed block also go straight against JAX's step on the 8 virtual CPU
devices of tests/conftest.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.dsp.convert import (params_from_jax, state_from_numpy,
                                           state_to_numpy)
from rtl_433_tpu_torch.parallel import timeshard as pts
from rtl_433_tpu_torch.parallel.sharding import Mesh

from test_timeshard import PWM_SIG, FSK_SIG, _dense_sig, _shard_local_sig
from test_torch_timeshard import _jax_step, _long_package_sig, _pad

CPU = torch.device("cpu")
CPU0 = torch.device("cpu", 0)
D = 8
S = 16384

MESHES = {"4+4": [CPU] * 4 + [CPU0] * 4,
          "alternating": [CPU, CPU0] * 4,
          "1+7": [CPU] + [CPU0] * 7}


def _mesh(devices):
    return Mesh(devices, ("sp",), (len(devices),))


def _streaming_blocks(cut):
    """tests/test_torch_timeshard.py's three blocks of the dense signal, the
    last a partial flush block (cut 9000: its valid samples end two
    segments before its end)."""
    full = _dense_sig(seed=23)
    n = full.shape[0]
    blk_len = ((n // 3) // (128 * D) + 1) * (128 * D)
    iq = full[:n - cut]
    n -= cut
    blocks = []
    for off in range(0, n, blk_len):
        end = min(off + blk_len, n)
        b = np.pad(iq[off:end], ((0, blk_len - (end - off)), (0, 0)),
                   constant_values=128)[None]
        blocks.append((b, end - off, end >= n))
    return blocks


def _partial_block(nv):
    blk = np.pad(_shard_local_sig()[:nv], ((0, D * S - nv), (0, 0)),
                 constant_values=128)[None]
    return [(blk, nv, True)]


def _two_channels():
    """Two channels, so that a lane's place (segment, channel) matters:
    the PWM signal and the long package."""
    a, b = PWM_SIG(), _long_package_sig()
    n = max(a.shape[0], b.shape[0])
    n += (-n) % (128 * D)
    blk = np.stack([np.pad(x, ((0, n - x.shape[0]), (0, 0)),
                           constant_values=128) for x in (a, b)])
    return [(blk, n, True)]


def _one(iq):
    blk, n = _pad(iq, D)
    return [(blk, n, True)]


# name -> (JAX params, blocks, halo chunks, whether every block verifies:
# True, False or None for either)
SCENARIOS = {
    "pwm": (lambda: je.DetectorParams(), lambda: _one(PWM_SIG()), 10, None),
    "classic_fsk": (lambda: je.DetectorParams(fsk_minmax=False),
                    lambda: _one(FSK_SIG()), 10, None),
    "shard_local": (lambda: je.DetectorParams(),
                    lambda: _one(_shard_local_sig()), 10, True),
    "straddling": (lambda: je.DetectorParams(),
                   lambda: _one(_long_package_sig()), 2, False),
    "stream_cut0": (lambda: je.DetectorParams(),
                    lambda: _streaming_blocks(0), 10, None),
    "stream_cut9000": (lambda: je.DetectorParams(),
                       lambda: _streaming_blocks(9000), 10, None),
    "partial_verifies": (lambda: je.DetectorParams(),
                         lambda: _partial_block(7 * S - 100), 10, True),
    "partial_fails": (lambda: je.DetectorParams(),
                      lambda: _partial_block(6 * S - 800), 10, False),
    "two_channels": (lambda: je.DetectorParams(), _two_channels, 10, None),
}


@functools.lru_cache(maxsize=None)
def _scenario(name):
    jp, blocks, halo, verifies = SCENARIOS[name]
    jp = jp()
    return jp, params_from_jax(jp), blocks(), halo, verifies


@functools.lru_cache(maxsize=None)
def _true_states(name):
    """The sequential engine's state before each block of a scenario."""
    _, params, blocks, _, _ = _scenario(name)
    seq = te.detector_init(params, blocks[0][0].shape[0], CPU)
    out = []
    for blk, nv, flush in blocks:
        out.append(seq)
        seq, _ = te.process_block(params, seq, torch.from_numpy(blk), nv,
                                  flush=flush)
    return out


def _steps(name, devices):
    """The debug step over the scenario's blocks, each from the sequential
    engine's true state: [(ok, flags, state, avg_db)] per block."""
    _, params, blocks, halo, _ = _scenario(name)
    fns = {f: pts.timeshard_process_block(params, _mesh(devices),
                                          halo_chunks=halo, flush=f,
                                          debug=True)
           for f in (False, True)}
    out = []
    for (blk, nv, flush), seq in zip(blocks, _true_states(name)):
        x = torch.from_numpy(np.ascontiguousarray(blk))
        st, avg, ok, flags = fns[flush](seq, x, nv)
        out.append((ok, flags, state_to_numpy(st), avg))
    return out


def _engine(params, devices, blocks, halo):
    """TimeShardEngine over ``blocks``: (packages per block, fallbacks,
    verified, the state after every block)."""
    eng = pts.TimeShardEngine(params, channels=blocks[0][0].shape[0],
                              mesh=_mesh(devices), halo_chunks=halo)
    pkgs, states = [], []
    for blk, nv, flush in blocks:
        eng.push(blk, n_valid=nv, flush=flush)
        states.append(state_to_numpy(eng.state))
        pkgs.append(eng.take_packages())
    return pkgs, eng.fallbacks, eng.verified, states


@functools.lru_cache(maxsize=None)
def _one_group(name):
    _, params, blocks, halo, _ = _scenario(name)
    return _steps(name, [CPU] * D), _engine(params, [CPU] * D, blocks, halo)


def _assert_steps_equal(got, want):
    assert len(got) == len(want)
    for (ok, flags, st, avg), (wok, wflags, wst, wavg) in zip(got, want):
        assert ok == wok
        assert torch.equal(flags, wflags)
        assert sorted(st) == sorted(wst)
        for k in wst:
            assert np.array_equal(st[k], wst[k]), k
        assert torch.equal(avg, wavg)


def _assert_engines_equal(got, want):
    pkgs, fallbacks, verified, states = got
    wpkgs, wfallbacks, wverified, wstates = want
    assert (fallbacks, verified) == (wfallbacks, wverified)
    assert [len(p) for p in pkgs] == [len(p) for p in wpkgs]
    for p, w in zip(sum(pkgs, []), sum(wpkgs, [])):
        assert sorted(p) == sorted(w)
        for k in w:
            assert np.array_equal(p[k], w[k]), k
    for st, wst in zip(states, wstates):
        assert sorted(st) == sorted(wst)
        for k in wst:
            assert np.array_equal(st[k], wst[k]), k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_grouped_step_equals_the_one_group_step(name, mesh):
    _, params, blocks, halo, verifies = _scenario(name)
    steps, engine = _one_group(name)
    oks = [s[0] for s in steps]
    if verifies is not None:
        assert oks == [verifies] * len(oks)
    _assert_steps_equal(_steps(name, MESHES[mesh]), steps)
    got = _engine(params, MESHES[mesh], blocks, halo)
    _assert_engines_equal(got, engine)
    assert sum(len(p) for p in got[0]) > 0, "no packages detected"
    assert (got[1], got[2]) == (oks.count(False), oks.count(True))


@pytest.mark.parametrize("name", ["shard_local", "straddling"])
def test_grouped_step_equals_jax(name):
    """A verified and a failed block against JAX's step on 8 devices: ok,
    the flags and, where verified, every state key (``avg_db`` within
    1e-4 dB: XLA's CPU float32 log10)."""
    jp, params, blocks, halo, verifies = _scenario(name)
    (blk, nv, flush), = blocks
    state = {k: np.asarray(v) for k, v in je.detector_init(jp, 1).items()}
    js, javg, jok, jdbg = _jax_step(jp, D, halo, flush)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(blk),
        jnp.int32(nv))
    assert bool(jok) == verifies
    for devices in MESHES.values():
        fn = pts.timeshard_process_block(params, _mesh(devices),
                                         halo_chunks=halo, flush=flush,
                                         debug=True)
        ts, tavg, tok, tdbg = fn(state_from_numpy(state, CPU),
                                 torch.from_numpy(np.ascontiguousarray(blk)),
                                 nv)
        assert tok == verifies
        assert np.array_equal(tdbg.numpy(), np.asarray(jdbg))
        if tok:
            ts = state_to_numpy(ts)
            assert sorted(ts) == sorted(js)
            for k in js:
                assert np.array_equal(ts[k], np.asarray(js[k])), k
            assert np.allclose(np.asarray(javg), tavg.numpy(), atol=1e-4)


@pytest.mark.parametrize("name,debug", [("shard_local", False),
                                        ("straddling", False),
                                        ("straddling", True)])
def test_grouped_plain_gathers_follow_the_verdict(name, debug,
                                                  monkeypatch):
    """On the CPU each group's plain gather runs after the chain's
    verdict: one per group where the block verified or under debug, none
    for a failed block without debug (which returns the incoming
    state)."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    _, params, blocks, halo, verifies = _scenario(name)
    (blk, nv, flush), = blocks
    calls = []
    plain = ots.timeshard_gather_plain

    def spy(*args, **kw):
        calls.append(args[4].shape[0])
        return plain(*args, **kw)
    monkeypatch.setattr(ots, "timeshard_gather_plain", spy)
    fn = pts.timeshard_process_block(params, _mesh(MESHES["1+7"]),
                                     halo_chunks=halo, flush=flush,
                                     debug=debug)
    state = te.detector_init(params, 1, CPU)
    out = fn(state, torch.from_numpy(np.ascontiguousarray(blk)), nv)
    assert out[2] == verifies
    if verifies or debug:
        assert calls == [1, 7]
    else:
        assert calls == [] and out[0] is state


@pytest.mark.parametrize("mesh", list(MESHES))
def test_grouped_fallback_leaves_the_pre_block_state_untouched(mesh):
    """A failed grouped step writes into no state tensor: the engine
    replays the block from the true pre-block state."""
    _, params, blocks, halo, _ = _scenario("straddling")
    (blk, nv, flush), = blocks
    eng = pts.TimeShardEngine(params, channels=1,
                              mesh=_mesh(MESHES[mesh]), halo_chunks=halo)
    before = {k: v.clone() for k, v in eng.state.items()}
    prev = eng.state
    step = eng._flush_step
    seen = {}

    def spy(state, iq, n_valid):
        out = step(state, iq, n_valid)
        seen["ok"] = out[2]
        seen["same"] = all(torch.equal(state[k], before[k]) for k in before)
        return out

    eng._flush_step = spy
    eng.push(blk, n_valid=nv, flush=flush)
    assert seen == {"ok": False, "same": True}
    assert all(torch.equal(prev[k], before[k]) for k in before)
    assert eng.fallbacks == 1


@pytest.mark.parametrize("devices,calls", [
    ([CPU] * D, 2), (MESHES["4+4"], 4), (MESHES["alternating"], 4),
    (MESHES["1+7"], 3)])
def test_each_group_runs_its_own_front_end_and_detector(devices, calls,
                                                         monkeypatch):
    """One group: a front-end and a detector call for the halos, one of
    each for the candidate segments; each further group the same, but a
    group that holds segment 0 alone has no halos."""
    params = te.DetectorParams()
    counts = {"frontend": 0, "detector_scan": 0}

    def counting(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run
    for name in counts:
        monkeypatch.setattr(pts, name, counting(name, getattr(pts, name)))
    blk, n = _pad(PWM_SIG()[:D * 2048], D)
    pts.timeshard_process_block(params, _mesh(devices))(
        te.detector_init(params, 1, CPU), torch.from_numpy(blk), n)
    assert counts == {"frontend": calls, "detector_scan": calls}


@pytest.mark.parametrize("mesh", ["4+4", "alternating"])
def test_unmasked_grouped_step_is_the_full_block_step(mesh):
    """``masked=False`` on a grouped mesh: the one-group step of a block
    with every sample valid."""
    params = te.DetectorParams()
    blk, _ = _pad(PWM_SIG()[:4 * 4096], D)
    x = torch.from_numpy(np.ascontiguousarray(blk))
    state = te.detector_init(params, 1, CPU)
    got = pts.timeshard_process_block(params, _mesh(MESHES[mesh]),
                                      masked=False)(state, x)
    want = pts.timeshard_process_block(params, _mesh([CPU] * D))(
        state, x, x.shape[1])
    assert got[2] == want[2]
    assert torch.equal(got[1], want[1])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k


def test_groups_follow_the_mesh_entries():
    """Segments group by the mesh's entries in the order each first
    appears, whatever the order of the entries; the state lives on the
    first entry's device; a mesh of another length than its axis
    raises."""
    groups = pts._segment_groups(_mesh(MESHES["alternating"]), "sp")
    assert [(g.device, g.ids) for g in groups] == [
        (CPU, [0, 2, 4, 6]), (CPU0, [1, 3, 5, 7])]
    groups = pts._segment_groups(_mesh([CPU0] * 3 + [CPU] * 5), "sp")
    assert [(g.device, g.ids) for g in groups] == [
        (CPU0, [0, 1, 2]), (CPU, [3, 4, 5, 6, 7])]
    eng = pts.TimeShardEngine(te.DetectorParams(),
                              mesh=_mesh(MESHES["1+7"]))
    assert eng.mesh.devices[0] == CPU
    with pytest.raises(ValueError, match="one entry per segment"):
        pts.timeshard_process_block(te.DetectorParams(),
                                    Mesh([CPU] * 4, ("sp",), (8,)))


@pytest.mark.parametrize("devices", [
    [CPU] + [torch.device("cuda")] * 7,
    [torch.device("cuda", 0)] + [CPU] * 7,
    [CPU, torch.device("meta")] * 4,
    [CPU] * 4 + [torch.device("meta")] * 4])
def test_a_mesh_of_mixed_device_types_raises(devices):
    """A mesh whose entries are not all of one device type is refused by
    the step and by the engine before any group is built: the step runs
    every group's kernels, or every group's plain versions, never a mix
    of both."""
    with pytest.raises(ValueError, match="devices of one type"):
        pts.timeshard_process_block(te.DetectorParams(), _mesh(devices))
    with pytest.raises(ValueError, match="devices of one type"):
        pts.TimeShardEngine(te.DetectorParams(), mesh=_mesh(devices))

"""The port's ShardedEngine against the JAX package's, on the CPU.

The four tests of tests/test_sharding.py run against the port on a mesh of
eight CPU devices (the JAX side's 8-device CPU mesh of tests/conftest.py),
the 2-D ("host", "ch") mesh included. Then the port's ShardedEngine and the
JAX package's run the same 8-channel IQ: take_packages equal (offsets
``base`` included, also when a second block is pushed before a drain) and
drain_events equal as JSON, in order. The per-channel block levels and the
noise floor agree to 1e-4 dB, the tolerance of the port's other avg_db
tests: XLA's CPU float32 log10 is not correctly rounded and torch's is, so
the two differ in the last bits (shown block by block in
tests/test_torch_multichannel.py).
"""

import jax
import numpy as np
import pytest
import torch

from rtl_433_tpu.decoders import Registry as JaxRegistry
from rtl_433_tpu.dsp.engine import DetectorParams as JaxParams
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu.parallel import make_mesh as jax_make_mesh
from rtl_433_tpu.parallel.sharding import ShardedEngine as JaxEngine
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.dsp.engine import (DetectorParams, detector_init,
                                          process_block, take_packages)
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.parallel import make_mesh
from rtl_433_tpu_torch.parallel.sharding import (ShardedEngine, shard_block,
                                                 sharded_init)

from synth import ppm_pulses, pwm_pulses, synth_ook

CPU8 = [torch.device("cpu")] * 8


def _params():
    return DetectorParams(sample_rate=250_000, pkg_cap=4)


def _mk_blocks(channels, n, seed=7):
    """Per-channel CU8 blocks, some with a real OOK burst."""
    rng = np.random.default_rng(seed)
    iq = rng.integers(123, 133, size=(channels, n, 2), dtype=np.uint8)
    sig = synth_ook(pwm_pulses([1, 0, 1, 1, 0, 0, 1, 0] * 3))
    for c in range(0, channels, 2):
        off = 500 + 37 * c
        seg = sig[: max(0, n - off)]
        iq[c, off:off + seg.shape[0]] = seg
    return iq


def _same_packages(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


def test_mesh_shapes():
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.size == 8 and mesh.shape == (8,)
    mesh2 = make_mesh(8, axes=("host", "ch"), devices=CPU8)
    assert mesh2.size == 8 and mesh2.shape == (1, 8)
    assert mesh2.axis_names == ("host", "ch")
    with pytest.raises(ValueError):
        make_mesh(devices=CPU8, axes=("a", "b", "c"))


def test_make_mesh_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardedEngine(_params(), 8)


def test_sharded_equals_single():
    params = _params()
    channels, n = 8, 16384
    iq = _mk_blocks(channels, n)

    # ground truth: one device
    state = detector_init(params, channels, "cpu")
    state, _ = process_block(params, state, torch.from_numpy(iq), n,
                             flush=True)
    ref_pkgs, _ = take_packages(state)
    assert ref_pkgs

    # sharded over the 8-device CPU mesh
    eng = ShardedEngine(params, channels, make_mesh(8, devices=CPU8))
    assert len(eng.shards) == 8
    eng.push(iq, flush=True)
    got_pkgs, _ = take_packages(eng.state)
    _same_packages(ref_pkgs, got_pkgs)


def test_one_device_mesh_keeps_one_state():
    """On one device the state is the shard itself, and the block is not
    copied: no split or join."""
    eng = ShardedEngine(_params(), 4, make_mesh(devices=["cpu"]))
    assert eng.state is eng.shards[0]
    iq = torch.from_numpy(_mk_blocks(4, 1024))
    got, = shard_block(iq, eng.mesh)
    assert got.data_ptr() == iq.data_ptr() and got.shape == iq.shape


def test_sharded_2d_mesh():
    params = _params()
    mesh = make_mesh(8, axes=("host", "ch"), devices=CPU8)
    eng = ShardedEngine(params, 16, mesh)
    iq = _mk_blocks(16, 1024, seed=3)
    avg_db = eng.push(iq)
    assert avg_db.shape == (16,)
    assert np.isfinite(float(eng.noise_floor_db))
    # the JAX engine's on its 2-D mesh of eight CPU devices
    jeng = JaxEngine(JaxParams(**params._asdict()), 16,
                     jax_make_mesh(8, axes=("host", "ch")))
    javg = np.asarray(jeng.push(iq))
    np.testing.assert_allclose(avg_db.numpy(), javg, rtol=0, atol=1e-4)
    assert abs(float(eng.noise_floor_db)
               - float(jeng.noise_floor_db)) <= 1e-4
    # the floor is the mean of the per-shard means, here the global mean
    assert abs(float(eng.noise_floor_db) - float(avg_db.mean())) <= 1e-5


def test_channels_must_divide():
    with pytest.raises(ValueError):
        sharded_init(_params(), 12, make_mesh(8, devices=CPU8))


def _nexus_iq(n, seed=0):
    """A decodable Nexus-TH PPM burst (id 156, ch 1, 21.5C, 45%)."""
    bits = "100111001000000011010111111100101101"
    pulses = []
    for rep in range(4):
        for b in bits:
            pulses.append((500, 1000 if b == "0" else 2000))
        pulses.append((500, 4000))
    sig = synth_ook(pulses, rate=250000, seed=seed)
    rng = np.random.default_rng(seed)
    iq = rng.integers(123, 133, size=(n, 2), dtype=np.uint8)
    seg = sig[: max(0, n - 600)]
    iq[600:600 + seg.shape[0]] = seg
    return iq


@pytest.fixture(scope="module")
def nexus8():
    """8 channels: Nexus bursts on the even ones, noise on the odd ones."""
    channels, n = 8, 98304
    iq = np.zeros((channels, n, 2), np.uint8) + 128
    rng = np.random.default_rng(11)
    for c in range(channels):
        if c % 2 == 0:
            iq[c] = _nexus_iq(n, seed=c)
        else:
            iq[c] = rng.integers(123, 133, size=(n, 2), dtype=np.uint8)
    return iq


def _port_engine(channels, mesh):
    reg = Registry()
    reg.register_all()
    return ShardedEngine(_params(), channels, mesh, registry=reg)


def _jax_engine(channels, mesh):
    reg = JaxRegistry()
    reg.register_all()
    return JaxEngine(JaxParams(**_params()._asdict()), channels, mesh,
                     registry=reg)


@pytest.fixture(scope="module")
def port8_events(nexus8):
    """The port's 8-channel engine on nexus8, pushed whole: its drained
    events, which two tests below hold to their references."""
    eng = _port_engine(8, make_mesh(8, devices=CPU8))
    eng.push(nexus8, flush=True)
    return [(c, event_to_json(ev)) for c, ev in eng.drain_events()]


def test_sharded_event_service_matches_per_channel(nexus8, port8_events):
    """drain_events == N independent single-channel runs, channel-tagged."""
    got = port8_events

    want = []
    for c in range(8):
        e1 = _port_engine(1, make_mesh(1, devices=["cpu"]))
        e1.push(nexus8[c:c + 1], flush=True)
        want += [(c, event_to_json(ev)) for _, ev in e1.drain_events()]

    assert sorted(got) == sorted(want)
    assert any("Nexus" in e for _, e in got)


def test_port_engine_matches_jax_engine(nexus8):
    """Both engines on the same 8-channel IQ, pushed twice (the bursts end
    inside each push): the first push's packages are harvested when the
    second is pushed, with the first push's base. Block levels, noise
    floors and packages agree."""
    first = second = nexus8[:, :90112]
    port = _port_engine(8, make_mesh(8, devices=CPU8))
    jeng = _jax_engine(8, jax_make_mesh(8))
    for blk, flush in ((first, False), (second, True)):
        avg = port.push(blk, flush=flush)
        javg = np.asarray(jeng.push(blk, flush=flush))
        np.testing.assert_allclose(avg.numpy(), javg, rtol=0, atol=1e-4)
        assert abs(float(port.noise_floor_db)
                   - float(jeng.noise_floor_db)) <= 1e-4
    pkgs = port.take_packages()
    jpkgs = jeng.take_packages()
    _same_packages(jpkgs, pkgs)
    assert {p["base"] for p in pkgs} == {0, 90112}
    assert port.n_pkg_dropped == jeng.n_pkg_dropped == 0


def test_drain_events_equal_jax_in_order(nexus8, port8_events):
    jeng = _jax_engine(8, jax_make_mesh(8))
    jeng.push(nexus8, flush=True)
    got = port8_events
    want = [(c, jax_event_to_json(ev)) for c, ev in jeng.drain_events()]
    assert got == want
    assert len(got) >= 4


def test_package_cap_counts_drops():
    """More published packages than pkg_cap_total: the first ones are
    kept, in channel order, and the rest counted, as in JAX."""
    params = _params()
    iq = _mk_blocks(8, 16384)
    port = ShardedEngine(params, 8, make_mesh(8, devices=CPU8),
                         pkg_cap_total=2)
    jeng = JaxEngine(JaxParams(**params._asdict()), 8, jax_make_mesh(8),
                     pkg_cap_total=2)
    port.push(iq, flush=True)
    jeng.push(iq, flush=True)
    pkgs, jpkgs = port.take_packages(), jeng.take_packages()
    _same_packages(jpkgs, pkgs)
    assert len(pkgs) == 2
    assert port.n_pkg_dropped == jeng.n_pkg_dropped > 0

"""The port's DecodePool: worker-process decode fan-out, event-identical and
order-preserving against the inline dispatch, and against the JAX
package's inline dispatch on the same jobs (the three tests of
tests/test_decode_pool.py, on the port); a flex spec reaches the workers.
The module itself is held to its JAX twin in tests/test_torch_decoders.py.
"""

import sys

import numpy as np
import pytest
import torch

from rtl_433_tpu.decoders import Registry as JaxRegistry
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu.pulse.data import PulseData as JaxPulseData
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.decoders.flex import flex_create_device
from rtl_433_tpu_torch.decoders.pool import DecodePool
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse.data import PulseData

from synth import ppm_pulses, synth_ook

fork_only = pytest.mark.skipif(sys.platform == "win32",
                               reason="fork start method")


def _nexus_train(id_, temp_dc):
    v = ((id_ << 28) | (1 << 27) | (1 << 24) | ((temp_dc & 0xFFF) << 12)
         | (0xF << 8) | 45)
    pulses = ppm_pulses(format(v, "036b"), pulse_us=500, gap_zero_us=1000,
                        gap_one_us=2000, reset_us=4000, repeats=4)
    return [p // 4 for p, g in pulses], [g // 4 for p, g in pulses]


def _pd(cls, id_, temp_dc):
    pd = cls(sample_rate=250_000)
    pd.pulse, pd.gap = _nexus_train(id_, temp_dc)
    pd.ook_low_estimate = 10
    pd.ook_high_estimate = 8000
    return pd


def _registry(cls):
    reg = cls()
    reg.register_all()
    return reg


@fork_only
def test_pool_matches_inline_and_preserves_order():
    reg = _registry(Registry)
    jobs = [(ch, _pd(PulseData, 0x10 + ch, 200 + 7 * i))
            for i, ch in enumerate([3, 1, 2, 0, 3, 1])]

    # inline reference: same packages, same order
    inline = []
    for ch, pd in jobs:
        reg.run_ook_demods(
            pd, lambda dev, ev, c=ch: inline.append((c, event_to_json(ev))))

    with DecodePool(reg, n_workers=2) as pool:
        for ch, pd in jobs:
            pool.submit(ch, False, pd)
        res = pool.drain()
    got = [(c, event_to_json(ev)) for c, dev, ev in res]

    assert got == inline
    assert len(got) >= len(jobs)  # nexus emits >= 1 event per package
    # events come back attached to the parent registry's devices
    assert all(dev in reg.active for _, dev, _ in res)


@fork_only
def test_pool_channel_affinity_keeps_stateful_order():
    """Identical channels' package streams each see their own worker in
    order (channel affinity)."""
    reg = _registry(Registry)
    with DecodePool(reg, n_workers=3) as pool:
        for i in range(9):
            pool.submit(i % 3, False, _pd(PulseData, 0x42, 215))
        res = pool.drain()
    assert len(res) >= 9
    chans = [c for c, _, _ in res]
    assert chans[:3] == [0, 1, 2]


@fork_only
def test_pool_equals_jax_inline():
    """The port's pool and the JAX package's inline dispatch on the same
    jobs: the same events in the same order."""
    ids = [(3, 0x21), (0, 0x33), (5, 0x0a), (3, 0x21), (1, 0x7f), (0, 0x33)]
    jreg = _registry(JaxRegistry)
    want = []
    for i, (ch, id_) in enumerate(ids):
        jreg.run_ook_demods(
            _pd(JaxPulseData, id_, 180 + 11 * i),
            lambda dev, ev, c=ch: want.append((c, jax_event_to_json(ev))))
    with DecodePool(_registry(Registry), n_workers=4) as pool:
        for i, (ch, id_) in enumerate(ids):
            pool.submit(ch, False, _pd(PulseData, id_, 180 + 11 * i))
        got = [(c, event_to_json(ev)) for c, _, ev in pool.drain()]
    assert got == want
    assert len(got) >= len(ids)


@fork_only
def test_flex_spec_refused_before_forking():
    """A flex spec, once refused here, now reaches the workers: beside the
    default registration, the pool decodes as the inline registry with the
    same flex device added last (the workers' order)."""
    spec = "n=nx,m=OOK_PPM,s=1000,l=2000,g=3000,r=5000,bits=36"
    reg = _registry(Registry)
    reg.add_device(flex_create_device(spec))
    jobs = [(ch, _pd(PulseData, 0x30 + ch, 190 + 5 * i))
            for i, ch in enumerate([1, 0, 1])]
    inline = []
    for ch, pd in jobs:
        reg.run_ook_demods(
            pd, lambda dev, ev, c=ch: inline.append((c, dev.symbol,
                                                     event_to_json(ev))))
    with DecodePool(reg, n_workers=1, flex_specs=[spec]) as pool:
        for ch, pd in jobs:
            pool.submit(ch, False, pd)
        got = [(c, dev.symbol, event_to_json(ev))
               for c, dev, ev in pool.drain()]
    assert got == inline
    assert {s for _c, s, _e in got} == {"flex_nx"}


@fork_only
def test_sharded_engine_pool_matches_inline():
    """ShardedEngine.drain_events with the pool equals the inline path
    (same events, same order) on a multi-channel block."""
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.parallel import make_mesh
    from rtl_433_tpu_torch.parallel.sharding import ShardedEngine

    v = ((0x5A << 28) | (1 << 27) | (1 << 24) | ((215 & 0xFFF) << 12)
         | (0xF << 8) | 45)
    iq1 = synth_ook(ppm_pulses(format(v, "036b"), pulse_us=500,
                               gap_zero_us=1000, gap_one_us=2000,
                               reset_us=4000, repeats=4),
                    rate=250_000, lead_in_us=20_000, tail_us=30_000, seed=9)
    n = 131072
    blk = np.full((8, n, 2), 128, np.uint8)
    for ch in (0, 3, 5):
        blk[ch, :min(n, iq1.shape[0])] = iq1[:n]

    def run(pooled):
        eng = ShardedEngine(DetectorParams(), 8,
                            make_mesh(devices=[torch.device("cpu")]),
                            registry=_registry(Registry))
        if pooled:
            eng.use_decode_pool(2)
        try:
            eng.push(blk, n_valid=n, flush=True)
            return [(c, event_to_json(ev)) for c, ev in eng.drain_events()]
        finally:
            eng.close_decode_pool()

    inline = run(False)
    assert inline and inline == run(True)

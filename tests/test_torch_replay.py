"""End-to-end file replay through the port on the CPU.

The 8 fixtures whose decoders live in decoders/protocols.py decode to the
committed .json (the normalization of tests/test_corpus_parity.py); for
two of them the published packages equal the JAX engine's block by block;
and a fixture concatenated 3 times gives 3x its events, in both packages.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_433_tpu.api import RtlTpu as JaxRtlTpu, _block_jit
from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch.api import DEFAULT_BUF_SAMPLES, RtlTpu
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.dsp.convert import params_from_jax
from rtl_433_tpu_torch.io import load_iq, parse_filename
from rtl_433_tpu_torch.output.data_model import event_to_json

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PORTED = [("silvercrest", 1), ("rubicson", 2), ("prologue", 3),
          ("waveman", 4), ("nexus", 19), ("lacrosse_tx35", 75),
          ("lacrosse_tx29", 76), ("tpms_toyota", 88)]


def _normalize(ev):
    ev = dict(ev)
    ev.pop("time", None)
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in ev.items()}


def _fixture(name):
    cu8 = sorted(glob.glob(os.path.join(FIXTURES, name, "*.cu8")))[0]
    with open(cu8[:-4] + ".json") as f:
        want = [json.loads(line) for line in f if line.strip()]
    return cu8, want


def _port_events(num, path):
    rx = RtlTpu(register_all=False, report_time="off", device="cpu")
    rx.registry.register(num)
    return [_normalize(json.loads(event_to_json(e)))
            for e in rx.decode_file(path)]


@pytest.mark.parametrize("name,num", PORTED, ids=[p[0] for p in PORTED])
def test_fixture_replay(name, num):
    cu8, want = _fixture(name)
    assert _port_events(num, cu8) == want


def _jax_params(path, num):
    rx = JaxRtlTpu(register_all=False, report_time="off")
    rx.registry.register(num)
    info = parse_filename(path)
    rx.sample_rate = info.sample_rate
    rx.center_frequency = info.center_frequency
    rx._ensure_pipeline()
    return rx._params


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx29", 76)])
def test_take_packages_match_jax(name, num):
    """Block by block, the api's block loop through both engines with the
    api's own parameters: identical package lists."""
    cu8, _ = _fixture(name)
    jp = _jax_params(cu8, num)
    tp = params_from_jax(jp)
    iq = load_iq(cu8, "cu8")
    jstep = _block_jit(jp)
    jst = je.detector_init(jp, 1)
    tst = te.detector_init(tp, 1, "cpu")
    n = iq.shape[0]
    total = 0
    for pos in range(0, n, DEFAULT_BUF_SAMPLES):
        blk = iq[pos:pos + DEFAULT_BUF_SAMPLES]
        nb = blk.shape[0]
        blk = np.pad(blk, ((0, DEFAULT_BUF_SAMPLES - nb), (0, 0)),
                     constant_values=128)[None]
        nv = None if nb == DEFAULT_BUF_SAMPLES else nb
        flush = pos + DEFAULT_BUF_SAMPLES >= n
        jst, _ = jstep(jst, jnp.asarray(blk),
                       None if nv is None else jnp.int32(nv), flush=flush)
        jpk, jst = je.take_packages(jst)
        tst, _ = te.process_block(tp, tst, torch.from_numpy(blk), nv,
                                  flush=flush)
        tpk, tst = te.take_packages(tst)
        assert len(jpk) == len(tpk)
        for a, b in zip(jpk, tpk):
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert np.array_equal(a[k], b[k]), k
                else:
                    assert a[k] == b[k], k
        total += len(tpk)
    assert total > 0


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx35", 75)])
def test_stream_of_three_copies(name, num, tmp_path):
    """The stream check of chip_smoke.py at 3 copies: both packages decode
    3x the committed events, in order."""
    cu8, want = _fixture(name)
    path = tmp_path / os.path.basename(cu8)
    with open(cu8, "rb") as f:
        raw = f.read()
    path.write_bytes(raw * 3)
    rx = JaxRtlTpu(register_all=False, report_time="off")
    rx.registry.register(num)
    jax_events = [_normalize(json.loads(jax_event_to_json(e)))
                  for e in rx.decode_file(str(path))]
    assert jax_events == want * 3
    assert _port_events(num, str(path)) == want * 3

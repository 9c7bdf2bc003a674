"""A mixed capture under the default registration, in both packages.

Eight 250 kS/s fixtures, byte-concatenated into one file: OOK PPM, PWM,
Manchester and DMC, FSK PCM and PWM, and the stateful Security+ v1 among
them. No ``-R``: the 335 default protocols decode every package (the
port's per-decoder host path; the JAX package's default path, its native
fast path where the slicer library builds). The port's normalized events
must equal the JAX package's, and each fixture's committed events, in
order. The JAX package's host path (``Registry._run_host``, the path the
port has) gives the same events as its default path on this capture.

The Security+ decoders pair the two halves of a code only within 0.8 s of
``time.monotonic()`` (decoders/garage.py), so a replay's result would
depend on how fast the host decodes the packages between the halves. The
test gives both packages' garage module one fixed clock.
"""

import json
import os
import types

import pytest

import rtl_433_tpu.decoders.base as jax_base
import rtl_433_tpu.decoders.garage as jax_garage
import rtl_433_tpu_torch.decoders.garage as port_garage
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json
from torch_fixture_cases import FIXTURES, cases, expected, normalize

MIX = ["nexus", "silvercrest", "oregon_scientific", "lacrosse_tx35",
       "secplus_v1", "hcs200_fsk", "hideki_ts04", "rubicson"]


@pytest.fixture
def mixed(tmp_path, monkeypatch):
    clock = types.SimpleNamespace(monotonic=lambda: 0.0)
    monkeypatch.setattr(jax_garage, "time", clock)
    monkeypatch.setattr(port_garage, "time", clock)
    by_name = {name: cu8 for name, _nums, cu8 in cases()}
    raw, want = b"", []
    for name in MIX:
        cu8 = by_name[name]
        assert cu8.endswith("_250k.cu8")
        with open(cu8, "rb") as f:
            raw += f.read()
        want += expected(cu8)
    path = tmp_path / "mixed_433.92M_250k.cu8"
    path.write_bytes(raw)
    return str(path), want


def test_mix_is_in_the_corpus():
    assert os.path.isdir(FIXTURES)
    names = {name for name, _n, _c in cases()}
    assert set(MIX) <= names


def test_mixed_default_registration_matches_jax(mixed):
    path, want = mixed
    jax = [normalize(json.loads(jax_event_to_json(e)))
           for e in JaxRtlTpu(report_time="off").decode_file(path)]
    rx = RtlTpu(report_time="off", device="cpu")
    assert len(rx.registry.active) == 335
    port = [normalize(json.loads(event_to_json(e)))
            for e in rx.decode_file(path)]
    assert port == jax
    assert port == want


def test_jax_host_path_matches_its_default_path(mixed, monkeypatch):
    path, want = mixed
    default = [normalize(json.loads(jax_event_to_json(e)))
               for e in JaxRtlTpu(report_time="off").decode_file(path)]
    monkeypatch.setattr(jax_base.Registry, "_use_native",
                        lambda self: False)
    rx = JaxRtlTpu(report_time="off")
    assert not rx.registry._use_native()
    host = [normalize(json.loads(jax_event_to_json(e)))
            for e in rx.decode_file(path)]
    assert host == default == want

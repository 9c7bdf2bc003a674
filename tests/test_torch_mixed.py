"""A mixed capture under the default registration, in both packages.

Eight 250 kS/s fixtures, byte-concatenated into one file: OOK PPM, PWM,
Manchester and DMC, FSK PCM and PWM, and the stateful Security+ v1 among
them. No ``-R``: the 335 default protocols decode every package, on each
package's default path: ``Registry._run_fast`` (the native slicer bank,
the gates, the train memo and decode cache, the declarative bank) in both.
The port's normalized events must equal the JAX package's, and each
fixture's committed events, in order; the port must have taken
``_run_fast`` for every package; every active device's counters and the
``stats_report(level=2)`` body (``time`` and ``since`` aside) must equal
the JAX package's. In each package the per-decoder host path
(``Registry._run_host``, forced by making ``_use_native`` return False)
gives the same events as the default path on this capture.

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
import rtl_433_tpu_torch.decoders.base as port_base
import rtl_433_tpu_torch.decoders.garage as port_garage
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json
from torch_fixture_cases import FIXTURES, cases, expected, normalize

MIX = ["nexus", "silvercrest", "oregon_scientific", "lacrosse_tx35",
       "secplus_v1", "hcs200_fsk", "hideki_ts04", "rubicson"]


def _write_mixed(directory):
    by_name = {name: cu8 for name, _nums, cu8 in cases()}
    raw, want = b"", []
    for name in MIX:
        cu8 = by_name[name]
        assert cu8.endswith("_250k.cu8")
        with open(cu8, "rb") as f:
            raw += f.read()
        want += expected(cu8)
    path = directory / "mixed_433.92M_250k.cu8"
    path.write_bytes(raw)
    return str(path), want


def _fixed_clock(mp):
    clock = types.SimpleNamespace(monotonic=lambda: 0.0)
    mp.setattr(jax_garage, "time", clock)
    mp.setattr(port_garage, "time", clock)


@pytest.fixture
def mixed(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    return _write_mixed(tmp_path)


def _stats(rx, to_json):
    rep = json.loads(to_json(rx.stats_report(level=2)))
    rep.pop("time")
    rep.pop("since")
    return rep


def _counters(rx):
    return [(d.num, d.decode_events, d.decode_ok, d.decode_messages,
             d.decode_fails) for d in rx.registry.active]


@pytest.fixture(scope="module")
def default_paths(tmp_path_factory):
    """The capture decoded once by each package on its default path, the
    port's dispatch calls counted."""
    with pytest.MonkeyPatch.context() as mp:
        _fixed_clock(mp)
        path, want = _write_mixed(tmp_path_factory.mktemp("mixed"))
        jrx = JaxRtlTpu(report_time="off")
        jax = [normalize(json.loads(jax_event_to_json(e)))
               for e in jrx.decode_file(path)]
        calls = {"_run": 0, "_run_fast": 0, "_run_host": 0}
        for name in calls:
            def counted(self, *a, _fn=getattr(port_base.Registry, name),
                        _name=name, **k):
                calls[_name] += 1
                return _fn(self, *a, **k)
            mp.setattr(port_base.Registry, name, counted)
        rx = RtlTpu(report_time="off", device="cpu")
        port = [normalize(json.loads(event_to_json(e)))
                for e in rx.decode_file(path)]
    return types.SimpleNamespace(want=want, jax=jax, port=port, jrx=jrx,
                                 rx=rx, calls=calls)


def test_mix_is_in_the_corpus():
    assert os.path.isdir(FIXTURES)
    names = {name for name, _n, _c in cases()}
    assert set(MIX) <= names


def test_mixed_default_registration_matches_jax(default_paths):
    r = default_paths
    assert len(r.rx.registry.active) == 335
    assert r.port == r.jax
    assert r.port == r.want


def test_port_default_path_is_the_fast_path(default_paths):
    calls = default_paths.calls
    assert calls["_run"] > 0
    assert calls["_run_fast"] == calls["_run"]
    assert calls["_run_host"] == 0


def test_port_counters_match_jax_default_path(default_paths):
    r = default_paths
    assert _counters(r.rx) == _counters(r.jrx)
    assert sum(d.decode_events for d in r.rx.registry.active) > 0


def test_port_stats_report_matches_jax(default_paths):
    r = default_paths
    port = _stats(r.rx, event_to_json)
    assert port == _stats(r.jrx, jax_event_to_json)
    assert port["frames"]["count"] > 0
    assert port["frames"]["events"] > 0
    assert len(port["stats"]) == 335


def test_port_host_path_matches_its_default_path(mixed, monkeypatch,
                                                 default_paths):
    path, want = mixed
    monkeypatch.setattr(port_base.Registry, "_use_native",
                        lambda self: False)
    rx = RtlTpu(report_time="off", device="cpu")
    assert not rx.registry._use_native()
    host = [normalize(json.loads(event_to_json(e)))
            for e in rx.decode_file(path)]
    assert host == default_paths.port == want
    assert [(d.num, d.decode_ok, d.decode_messages)
            for d in rx.registry.active] == \
        [(d.num, d.decode_ok, d.decode_messages)
         for d in default_paths.rx.registry.active]


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

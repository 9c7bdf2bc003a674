"""The port's cs8/cs16/cf32 input and its CLI (``-y``, ``-R n:arg``)
against the JAX package's.

Sample bytes made from a numpy seed convert to CU8 exactly as the JAX
package's ``load_iq_bytes`` converts them; a fixture written as cs16 and
as cs8 decodes in both packages to its committed events. The CLI of each
package runs in this process on the same arguments and prints the same
events; so do the noise floor's options (``-Y squelch``, ``-Y
autolevel[=N]``, ``-M noise[:secs]``), with the same autolevel warnings,
and ``-M stats`` with the same report.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from rtl_433_tpu import cli as jax_cli
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.io.fileformat import load_iq as jax_load_iq
from rtl_433_tpu.io.fileformat import load_iq_bytes as jax_load_iq_bytes
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu_torch import cli
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.io import load_iq, load_iq_bytes
from rtl_433_tpu_torch.output.data_model import event_to_json
from test_decoder_oracle import VECTORS
from torch_fixture_cases import cases, expected, normalize
from torch_replay_cases import run_cli

SEED = 20261016
NEXUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "nexus", "g001_433.92M_250k.cu8")


def _raw(fmt, n, rng):
    if fmt == "cu8":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if fmt == "cs8":
        return rng.integers(-128, 128, n, dtype=np.int8).tobytes()
    if fmt == "cs16":
        return rng.integers(-32768, 32768, n, dtype=np.int16).tobytes()
    # cf32: mostly in range, some past full scale (clamped), exact edges
    x = rng.uniform(-1.3, 1.3, n).astype(np.float32)
    x[:6] = [1.0, -1.0, 0.0, -0.0, 2.5, -2.5][:min(6, n)]
    return x.tobytes()


@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
@pytest.mark.parametrize("n", [0, 1, 7, 4096, 100_001])
def test_load_iq_bytes_matches_jax(fmt, n):
    raw = _raw(fmt, n, np.random.default_rng(SEED + n))
    got = load_iq_bytes(raw, fmt)
    want = jax_load_iq_bytes(raw, fmt)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (n // 2, 2)
    assert np.array_equal(got, want)


def test_unported_formats_raise(tmp_path):
    """Every name the loaders recognise but cannot load as samples (and
    one they do not know) raises the JAX package's ValueError, word for
    word, from both packages."""
    from rtl_433_tpu_torch.io.fileformat import KNOWN_FORMATS
    names = [f for f in KNOWN_FORMATS
             if f not in ("cu8", "cs8", "cs16", "cf32")] + ["wav"]
    assert names[:-1] == ["am.s16", "am.f32", "fm.s16", "fm.f32", "ook",
                          "vcd", "sigmf"]
    for fmt in names:
        p = tmp_path / f"x.{fmt}"
        p.write_bytes(b"\0" * 8)
        said = {}
        for name, load, load_bytes in (
                ("port", load_iq, load_iq_bytes),
                ("jax", jax_load_iq, jax_load_iq_bytes)):
            for what, call in (("file", lambda: load(str(p), fmt)),
                               ("bytes", lambda: load_bytes(b"\0" * 8,
                                                            fmt))):
                with pytest.raises(ValueError) as e:
                    call()
                said[name, what] = str(e.value)
        assert set(said.values()) == {f"unsupported sample format: {fmt}"}


def _as(fmt, u8):
    s = u8.astype(np.int16) - 128
    return (s << 8).astype(np.int16) if fmt == "cs16" else s.astype(np.int8)


ROUND_TRIP = ("nexus", "lacrosse_tx35")


@pytest.fixture(scope="module")
def jax_round_trip_events():
    """The JAX package's events of each round-trip capture: both formats
    convert back to the capture's exact cu8 (checked per case with the JAX
    loader), so one JAX decode per capture serves every format."""
    out = {}
    for name, nums, cu8 in cases():
        if name in ROUND_TRIP:
            jrx = JaxRtlTpu(register_all=False, report_time="off")
            jrx.registry.register(nums[0])
            out[name] = [normalize(json.loads(jax_event_to_json(e)))
                         for e in jrx.decode_file(cu8)]
    return out


@pytest.mark.parametrize("fmt", ["cs16", "cs8"])
def test_fixture_round_trip_decodes(fmt, tmp_path, jax_round_trip_events):
    """nexus and lacrosse_tx35 (OOK and FSK) written as cs16 / cs8: the
    conversion back to cu8 is exact in both packages, so both decode the
    committed events."""
    for name, nums, cu8 in cases():
        if name not in ROUND_TRIP:
            continue
        u8 = np.fromfile(cu8, np.uint8)
        path = tmp_path / (cu8.rsplit("/", 1)[1][:-4] + "." + fmt)
        _as(fmt, u8).tofile(path)
        assert np.array_equal(load_iq(str(path), fmt).reshape(-1), u8)
        assert np.array_equal(jax_load_iq(str(path), fmt).reshape(-1), u8)
        rx = RtlTpu(register_all=False, report_time="off", device="cpu")
        rx.registry.register(nums[0])
        port = [normalize(json.loads(event_to_json(e)))
                for e in rx.decode_file(str(path))]
        assert port == jax_round_trip_events[name] == expected(cu8), name


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [normalize(json.loads(line))
                for line in buf.getvalue().splitlines()
                if line.startswith("{")]


RFRAW = next(code for num, code, _ in VECTORS if num == 15
             and code.startswith("AAB1"))

# (arguments, events expected) -- -R n:arg reaches the decoder: blueline
# decodes this row only with its id argument, arad_ms_meter turns its
# volume into the configured unit
CLI_CASES = [
    (["-R", "19", "-y", "{36}9c80d7f2d {36}9c80d7f2d {36}9c80d7f2d"], 1),
    (["-R", "176:13124", "-y", "{32}01eac74c"], 1),
    (["-R", "176", "-y", "{32}01eac74c"], 0),
    (["-R", "260:gear=10,units=l", "-y",
      "{184}c196f5138537b4bf1dfe8cff15b6f7fffa7eb21ca0df00"], 1),
    (["-R", "15", "-R", "51", "-y", RFRAW], 2),
    (["-R", "1", "-R", "-1", "-R", "2", "-y",
      "{36}12a0d7ff9 {36}12a0d7ff9 {36}12a0d7ff9"], 1),
]


@pytest.mark.parametrize("argv,n_events", CLI_CASES,
                         ids=[" ".join(c[0][:2]) + f"-{i}"
                              for i, c in enumerate(CLI_CASES)])
def test_cli_matches_jax(argv, n_events):
    rc, port = _run(cli.main, argv + ["-F", "json", "--device", "cpu"])
    jrc, jax = _run(jax_cli.main, argv + ["-F", "json"])
    assert rc == jrc == (0 if n_events else 1)
    assert port == jax
    assert len(port) == n_events


def test_cli_r_arg_reaches_the_decoder():
    rc, evs = _run(cli.main, ["-R", "260:units=l", "-y",
                              "{184}c196f5138537b4bf1dfe8cff15b6f7fffa7eb2"
                              "1ca0df00", "-F", "json", "--device", "cpu"])
    rc0, evs0 = _run(cli.main, ["-R", "260", "-y",
                                "{184}c196f5138537b4bf1dfe8cff15b6f7fffa7eb2"
                                "1ca0df00", "-F", "json", "--device", "cpu"])
    assert rc == rc0 == 0
    assert evs[0]["unit"] != evs0[0]["unit"]


def test_cli_y_stamps_time():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-R", "19", "-y", CLI_CASES[0][0][3], "-F", "json",
                       "--device", "cpu"])
    assert rc == 0
    ev = json.loads(buf.getvalue().splitlines()[0])
    assert "time" in ev and ev["model"] == "Nexus-TH"


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    events = [json.loads(line) for line in out.getvalue().splitlines()
              if line.startswith("{")]
    warn = [line for line in err.getvalue().splitlines()
            if "adjusting" in line]
    return rc, events, warn


@pytest.mark.parametrize("opts", [["-Y", "squelch"], ["-Y", "autolevel=2"],
                                  ["-M", "noise"],
                                  ["-Y", "classic,squelch,autolevel",
                                   "-M", "noise:5"]])
def test_cli_noise_options_match_jax(opts, monkeypatch):
    made = []

    class Recording(RtlTpu):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(cli, "RtlTpu", Recording)
    argv = ["-R", "19", "-r", NEXUS, "-F", "json"] + opts
    rc, port, pwarn = _cli(cli.main, argv + ["--device", "cpu"])
    jrc, jax, jwarn = _cli(jax_cli.main, argv)
    assert rc == jrc == 0
    assert port == jax and port
    assert pwarn == jwarn
    rx = made[0]
    joined = " ".join(opts)
    assert rx.squelch == ("squelch" in joined)
    assert rx.auto_level == (2 if "autolevel=2" in joined else
                             1 if "autolevel" in joined else 0)
    assert rx.report_noise == (5 if "noise:5" in joined else
                               1 if "noise" in joined else 0)


def test_cli_other_meta_options_not_ported():
    """-M stats, once refused here, is ported: with the clock pinned the
    port's CLI prints the same events and the same final stats report as
    the JAX CLI, byte for byte (tests/test_torch_replay_cli.py has every
    other -M key)."""
    argv = ["-R", "19", "-r", NEXUS, "-M", "stats", "-F", "json"]
    port = run_cli(cli.main, ["--device", "cpu"] + argv)
    assert port == run_cli(jax_cli.main, argv)
    rc, out, _err = port
    assert rc == 0
    report = json.loads(out.splitlines()[-1])
    assert report["enabled"] == 1 and report["frames"]["events"] == 1
    assert [s["device"] for s in report["stats"]] == [19]

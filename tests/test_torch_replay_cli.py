"""The port's replay CLI against the JAX package's, argv for argv.

Both ``cli.main`` run in this process on the same arguments, with the API
module's clock pinned (tests/torch_replay_cases.py), from a temporary
working directory whose default conf search paths point into it: the
same exit code and the same bytes on stdout and stderr. The cases cover
the replay options of both CLIs (``-F json|jsons|kv|log|csv|null`` with
``,v=N``, every ``-M`` key, ``-C``, ``-v``, ``-Y``'s levels and filter,
``-f``/``-s``, ``-X``, ``-c`` and the default conf, the live-input and
compatibility flags, which are parsed and unused here), the default
outputs (json and log), a missing input file, SigMF and ``.ook`` input.
So do ``-K FILE``, ``-K gpsd``, ``-A`` and each network output (``-F
syslog|trigger|mqtt|mqtts|influx|http``) against loopback stubs
(tests/torch_output_cases.py), with the output modules' clocks pinned:
the same bytes at each stub.
The declared differences: ``-V`` and the malformed-gain warning name the
port, ``--device`` picks where the port's engine runs, and the HTTP
server's ``device_info`` names the port's backend.
SigMF archives written by either package read back equal in the other
(the recorder names the writer), and ``.ook`` pulse text from
``PulseData.dump`` loads and decodes equally in both.
"""

import json
import os
import shutil

import numpy as np
import pytest

from rtl_433_tpu import cli as jax_cli
from rtl_433_tpu import confparse as jconf
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.io import sigmf as jsigmf
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu.pulse.data import PulseData as JaxPulseData
from rtl_433_tpu_torch import cli
from rtl_433_tpu_torch import confparse as tconf
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.io import load_iq
from rtl_433_tpu_torch.io import sigmf as tsigmf
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse.data import PulseData
from test_decoder_oracle import VECTORS
from torch_fixture_cases import expected, normalize
from torch_output_cases import make_cert, run_network_cli, tls_server_ctx
from torch_replay_cases import CONF, fixture, run_cli

SEED = 20261018
NEXUS = fixture("nexus")
TX141 = fixture("lacrosse_tx141x")
TX35 = fixture("lacrosse_tx35")
CODE = "{36}9c80d7f2d {36}9c80d7f2d {36}9c80d7f2d"
FLEX = ("n=nexus_flex,m=OOK_PPM,s=1000,l=2000,g=3000,r=5000,bits=36,"
        "get=@0:{8}:id,get=@12:{12}:temp,get=@28:{8}:hum")
RFRAW = next(code for num, code, _ in VECTORS if num == 15
             and code.startswith("AAB1"))
E2E_SPEC = ("n=test,m=OOK_PWM,s=100,l=200,r=300,bits>=4,"
            "get=@0:{4}:first,get=@4:{4}:second:[10:ten 11:eleven]")


@pytest.fixture
def cwd(tmp_path, monkeypatch):
    """A working directory of its own, the default conf search inside it."""
    monkeypatch.chdir(tmp_path)
    paths = ["rtl_433.conf",
             str(tmp_path / "xdg" / "rtl_433" / "rtl_433.conf")]
    for mod in (jconf, tconf):
        monkeypatch.setattr(mod, "DEFAULT_CONF_PATHS", list(paths))
    return tmp_path


def _both(argv):
    """Both CLIs on ``argv``: (port's, JAX's) (exit code, stdout,
    stderr)."""
    return (run_cli(cli.main, ["--device", "cpu"] + argv),
            run_cli(jax_cli.main, argv))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Files the replay cases read: the nexus capture with no rate or
    frequency in its name, as SigMF (written by the port) and as .ook pulse
    text (the JAX replay's packages, dumped by the port)."""
    d = tmp_path_factory.mktemp("inputs")
    plain = d / "capture.cu8"
    shutil.copy(NEXUS, plain)
    sm = d / "nexus.sigmf"
    tsigmf.write(str(sm), load_iq(NEXUS, "cu8"), 250_000, 433_920_000)
    rx = JaxRtlTpu(register_all=False)
    rx.registry.register(19)
    pds = []
    real = rx.registry.run_ook_demods
    rx.registry.run_ook_demods = lambda pd, cb: (pds.append(pd),
                                                 real(pd, cb))[1]
    rx.decode_file(NEXUS)
    ook = d / "nexus_433.92M_250k.ook"
    ook.write_text("".join(
        PulseData(**{k: getattr(pd, k) for k in vars(PulseData())}).dump()
        for pd in pds))
    return {"CAPTURE": str(plain), "SIGMF": str(sm), "OOK": str(ook)}


# argv of file replays, compared whole: "{NAME}" stands for a file of
# inputs()
REPLAY_CASES = {
    "default_outputs": ["-R", "19", "-r", NEXUS],
    "sinks_and_meta": ["-R", "19", "-r", NEXUS, "-F", "csv", "-F", "log",
                       "-F", "jsons", "-F", "kv", "-F", "null", "-M",
                       "level", "-M", "protocol", "-M", "time:unix:usec:utc",
                       "-C", "si"],
    "verbose_stats_replay": ["-R", "19", "-r", NEXUS, "-F", "json,v=8",
                             "-F", "kv,v=5", "-vvvv", "-M", "bits", "-M",
                             "time:iso:tz:usec:local", "-M", "stats:2:1",
                             "-M", "replay:4"],
    "detector": ["-R", "19", "-r", NEXUS, "-Y",
                 "classic,ampest,minlevel=-15,minsnr=6,filter=500",
                 "-Y", "autolevel=2,squelch", "-M", "noise:2", "-F", "log",
                 "-F", "json"],
    "conf": ["-c", os.path.join(CONF, "lacrosse_tx141.conf"), "-R", "73",
             "-r", TX141, "-F", "json"],
    "fsk_meta": ["-R", "75", "-r", TX35, "-F", "json", "-M", "level"],
    "rate_and_frequency": ["-R", "19", "-s", "250k", "-f", "433.92M", "-r",
                           "{CAPTURE}", "-F", "json"],
    "sigmf": ["-R", "19", "-r", "{SIGMF}", "-F", "json"],
    "ook": ["-R", "19", "-r", "{OOK}", "-F", "json", "-M", "level"],
    "missing_file": ["-R", "19", "-r", "{MISSING}"],
}


@pytest.mark.parametrize("name", list(REPLAY_CASES))
def test_replay_matches_jax(name, cwd, inputs):
    files = dict(inputs, MISSING=str(cwd / "gone_433.92M_250k.cu8"))
    argv = [files[a[1:-1]] if a.startswith("{") and a.endswith("}") else a
            for a in REPLAY_CASES[name]]
    port, jax = _both(argv)
    assert port == jax
    rc, out, err = port
    if name == "missing_file":
        assert rc == 2 and "cannot open input file" in err and not out
        return
    assert rc == 0
    if name == "default_outputs":
        # json plus a log sink, and no "-F log" hint
        assert json.loads(out.splitlines()[0])["model"] == "Nexus-TH"
        assert "-F log" not in err
    elif name in ("fsk_meta", "sigmf", "detector"):
        # -F json alone: no sink takes log messages; with -F log the
        # messages reach stderr
        assert ('Use "-F log"' in err) == (name != "detector")
    if "json" in argv:
        assert out


def test_default_conf_from_the_working_directory(cwd):
    """rtl_433.conf in the working directory loads before the argv: its
    protocol, output and flex decoder."""
    (cwd / "rtl_433.conf").write_text(
        f"protocol 19\noutput json\ndecoder {FLEX}\n")
    port, jax = _both(["-r", NEXUS])
    assert port == jax and port[0] == 0
    # the flex decoder (priority 0) takes the package before nexus
    # (priority 10), as in the reference
    models = [json.loads(ln)["model"] for ln in port[1].splitlines()]
    assert models == ["nexus_flex"]


def test_default_conf_from_xdg(cwd):
    conf = cwd / "xdg" / "rtl_433" / "rtl_433.conf"
    conf.parent.mkdir(parents=True)
    conf.write_text("protocol 19\noutput jsons\nreport_meta protocol\n")
    port, jax = _both(["-y", CODE])
    assert port == jax and port[0] == 0
    assert json.loads(port[1])["protocol"] == 19


# argv of -y runs (no samples), compared whole
Y_CASES = {
    "protocol": ["-R", "19", "-y", CODE, "-F", "json", "-M", "protocol"],
    "time_notz_quirk": ["-R", "19", "-y", CODE, "-F", "json", "-M",
                        "time:notz"],
    "time_rel": ["-R", "19", "-y", CODE, "-F", "json", "-M", "time:rel"],
    "time_sec_utc_tz": ["-R", "19", "-y", CODE, "-F", "json", "-M",
                        "time:sec:utc:tz"],
    "time_unknown": ["-R", "19", "-y", CODE, "-F", "json", "-M",
                     "time:bogus"],
    "models": ["-R", "19", "-y", CODE, "-F", "kv", "-M", "newmodel", "-M",
               "oldmodel", "-C", "customary"],
    "bits_vv": ["-R", "19", "-y", CODE, "-M", "bits", "-vv"],
    "stats_levels": ["-R", "19", "-R", "2", "-y", CODE, "-F", "json", "-M",
                     "stats:3"],
    "live_and_compat_flags": ["-R", "19", "-y", CODE, "-F", "json", "-n",
                              "100k", "-E", "quit", "-T", "10", "-H", "60",
                              "-g", "20.5", "-p", "5", "-D", "restart",
                              "-G", "4", "-a", "0", "-I", "1", "-z", "0",
                              "-x", "0", "-b", "1", "-l", "0", "-t", "0"],
    "gain_auto": ["-R", "19", "-y", CODE, "-F", "json", "-g", "auto"],
    "flex_e2e": ["-R", "0", "-X", E2E_SPEC, "-y", "{16}ab42", "-F",
                 "json"],
    "flex_before_defaults": ["-X", E2E_SPEC, "-y", "{16}ab42", "-F", "csv"],
    "rate_rule": ["-R", "15", "-R", "51", "-f", "868.3M", "-y", RFRAW, "-F",
                  "json", "-M", "level"],
    "rate_and_frequency_rfraw": ["-R", "15", "-R", "51", "-f", "915M", "-s",
                                 "250k", "-y", RFRAW, "-F", "json", "-M",
                                 "level"],
    "flex_then_r0": ["-X", E2E_SPEC, "-R", "0", "-R", "19", "-y", CODE,
                     "-F", "jsons"],
    "negative_r": ["-R", "-19", "-y", CODE, "-F", "jsons"],
    "nothing_decoded": ["-R", "19", "-y", "{8}00", "-F", "json"],
    "unknown_output": ["-R", "19", "-y", CODE, "-F", "bogus"],
    "bad_output_option": ["-R", "19", "-y", CODE, "-F", "json,x=1"],
    "value_missing": ["-R", "19", "-y"],
}


@pytest.mark.parametrize("name", list(Y_CASES))
def test_test_codes_match_jax(name, cwd):
    port, jax = _both(Y_CASES[name])
    assert port == jax
    want_rc = {"nothing_decoded": 1, "unknown_output": 2,
               "bad_output_option": 2, "value_missing": 2}.get(name, 0)
    assert port[0] == want_rc


def test_malformed_gain_names_the_port(cwd):
    """A declared difference: the warning names each package."""
    port, jax = _both(["-R", "19", "-y", CODE, "-F", "json", "-g", "loud"])
    assert port[:2] == jax[:2] and port[0] == 0
    warn = "ignoring malformed gain 'loud' (expected dB value or 'auto')\n"
    assert port[2].startswith("rtl_433_tpu_torch: " + warn)
    assert jax[2].startswith("rtl_433_tpu: " + warn)
    assert port[2].split("\n", 1)[1] == jax[2].split("\n", 1)[1]


def test_version_names_the_port(cwd):
    """A declared difference: -V prints each package's own name."""
    from rtl_433_tpu import __version__ as jv
    from rtl_433_tpu_torch import __version__ as tv
    port, jax = _both(["-V"])
    assert port == (0, f"rtl_433_tpu_torch version {tv}\n", "")
    assert jax == (0, f"rtl_433_tpu version {jv}\n", "")


# -K tags and network outputs (tests/torch_output_cases.py network_argv),
# each alone beside -F json on the nexus capture
NETWORK_RUNS = {
    "K_FILE": dict(outputs=(), tags=("FILE",)),
    "K_gpsd": dict(outputs=(), tags=("gpsd",)),
    "syslog": dict(outputs=("syslog",), tags=()),
    "trigger": dict(outputs=("trigger",), tags=()),
    "mqtt": dict(outputs=("mqtt",), tags=()),
    "mqtts": dict(outputs=("mqtts",), tags=()),
    "influx": dict(outputs=("influx",), tags=()),
    "http": dict(outputs=("http",), tags=()),
}


@pytest.mark.parametrize("name", list(NETWORK_RUNS))
def test_network_outputs_match_jax(name, cwd, tmp_path):
    """The same exit code, stdout and stderr, and the same bytes at every
    stub: syslog datagrams, the broker's connection (TLS for mqtts), the
    Influx posts, the trigger file, the gpsd WATCH, and the WebSocket
    frames and settings reply of the HTTP server."""
    net = dict(NETWORK_RUNS[name])
    if name == "mqtts":
        cert, key = make_cert(str(tmp_path))
        net.update(tls_ctx=tls_server_ctx(cert, key),
                   mqtt_extra=f",tls_ca_cert={cert}")
    argv = ["-R", "19", "-r", NEXUS, "-F", "json"]
    port = run_network_cli(cli.main, argv + ["--device", "cpu"],
                           str(tmp_path / "port"), **net)
    jax = run_network_cli(jax_cli.main, argv, str(tmp_path / "jax"), **net)
    if name == "http":
        # declared: device_info names each package's backend
        assert jax[1]["http"][0].pop("device_info") == {"driver": "tpu",
                                                       "backend": "jax"}
        assert port[1]["http"][0].pop("device_info") == {"driver": "cpu",
                                                        "backend": "torch"}
    assert port == jax
    (rc, out, err), seen = port
    assert rc == 0 and '"Nexus-TH"' in out
    ev = json.loads(out.splitlines()[0])
    if name == "K_FILE":
        assert ev["file"] == os.path.basename(NEXUS)
    if name == "K_gpsd":
        assert (ev["lat"], ev["lon"]) == (12.34, 56.78)
        assert seen["gpsd"] == [b'?WATCH={"enable":true,"json":true}\n']
    if name == "syslog":
        assert len(seen["syslog"]) == 1 and b"Nexus-TH" in seen["syslog"][0]
    if name == "trigger":
        assert seen["trigger"] == "1"
    if name.startswith("mqtt"):
        topics = [t for t, _ in seen["mqtt"]]
        assert topics[1] == "rtl_433/test/events/Nexus-TH"
        assert "rtl_433/test/devices/Nexus-TH/156/temperature_C" in topics
        assert seen["mqtt_raw"][0].endswith(b"\xe0\x00")
    if name == "influx":
        assert seen["influx"][0][2].startswith("Nexus-TH,id=156,channel=1 ")
    if name == "http":
        assert [json.loads(f)["id"] for f in seen["http"][0]["ws"]] == [156]
        assert seen["http"][0]["settings"]["sample_rate"] == 250_000


def test_analyzer_matches_jax(cwd):
    """-A on the lacrosse_tx141x capture: the analyzer's text on stderr,
    byte for byte (its packages read as Manchester coding)."""
    port, jax = _both(["-R", "73", "-r", TX141, "-A"])
    assert port == jax
    rc, out, err = port
    assert rc == 0 and '"LaCrosse-TX141' in out
    assert "Guessing modulation: Manchester coding" in err


@pytest.mark.parametrize("datatype", ["cu8", "cs8"])
def test_sigmf_reads_back_in_the_other_package(datatype, tmp_path):
    rng = np.random.default_rng([SEED, len(datatype)])
    iq = rng.integers(0, 256, (5000, 2), dtype=np.uint8)
    if datatype == "cs8":
        iq = (iq.astype(np.int16) - 128).astype(np.int8)
    infos = {}
    for name, writer in (("port", tsigmf.write), ("jax", jsigmf.write)):
        path = str(tmp_path / f"{name}.sigmf")
        writer(path, iq, 1_024_000, 868_300_000, datatype=datatype)
        infos[name] = (jsigmf.read(path) if name == "port"
                       else tsigmf.read(path))
    port, jax = infos["port"], infos["jax"]
    for k in ("datatype", "sample_rate", "frequency", "sample_start"):
        assert getattr(port, k) == getattr(jax, k), k
    assert np.array_equal(port.data, jax.data)
    assert port.data.shape == (5000, 2) and port.data.dtype == np.uint8
    assert port.sample_rate == 1_024_000 and port.frequency == 868_300_000
    # the recorder names the writer: the one byte-level difference
    assert (port.recorder, jax.recorder) == ("rtl_433_tpu_torch",
                                             "rtl_433_tpu")
    same = str(tmp_path / "same.sigmf")
    tsigmf.write(same, iq, 1_024_000, 868_300_000, datatype=datatype,
                 recorder="rtl_433_tpu")
    with open(same, "rb") as a, open(tmp_path / "jax.sigmf", "rb") as b:
        assert a.read() == b.read()
    assert tsigmf.valid_filename(same) and not tsigmf.valid_filename(
        str(tmp_path / "x.cu8"))


def test_sigmf_replay_equals_the_capture(tmp_path):
    """A JAX-written SigMF archive of a capture replays through the port's
    API to the capture's committed events, at the capture's position."""
    sm = str(tmp_path / "nexus.sigmf")
    jsigmf.write(sm, load_iq(NEXUS, "cu8"), 250_000, 433_920_000)
    rx = RtlTpu(register_all=False, report_time="iso", device="cpu")
    rx.registry.register(19)
    got = [json.loads(event_to_json(e)) for e in rx.decode_file(sm)]
    assert [normalize(e) for e in got] == expected(NEXUS)
    assert rx.sample_rate == 250_000 and rx.center_frequency == 433.92e6
    assert all(e["time"].startswith("@0.") for e in got)


def _pulse_data(cls, rng, fsk):
    n = int(rng.integers(1, 40))
    pd = cls(pulse=[int(x) for x in rng.integers(1, 3000, n)],
             gap=[int(x) for x in rng.integers(1, 9000, n)],
             sample_rate=250_000, ook_low_estimate=int(rng.integers(1, 90)),
             ook_high_estimate=int(rng.integers(100, 20000)))
    if fsk:
        pd.fsk_f1_est = int(rng.integers(1, 16000))
        pd.fsk_f2_est = -int(rng.integers(1, 16000))
    pd.calc_rssi_snr(250_000, 433_920_000)
    return pd


@pytest.mark.parametrize("fsk", [False, True], ids=["ook", "fsk"])
def test_ook_text_dumps_and_loads_as_in_jax(fsk):
    texts = []
    for cls in (PulseData, JaxPulseData):
        rng = np.random.default_rng([SEED, int(fsk)])
        texts.append("".join(_pulse_data(cls, rng, fsk).dump()
                             for _ in range(4)))
    assert texts[0] == texts[1]
    text = texts[0] + "AAB1040190025800B4016D1AC8281818282828181828" \
        "1818181828181818281828181818182828281818281818182818282855\n"
    port = PulseData.load_all(text, 250_000)
    jax = JaxPulseData.load_all(text, 250_000)
    assert len(port) == len(jax) == 5
    assert [vars(p) for p in port] == [vars(j) for j in jax]
    assert [p.is_fsk for p in port[:4]] == [fsk] * 4


def test_decode_ook_file_as_in_jax(tmp_path):
    """Nexus packages of both widths as OOK text: decode_ook_file in both
    packages gives the same events."""
    from synth import ppm_pulses
    text = ""
    for i, temp in enumerate((215, 87, 301)):
        v = ((0x40 + i << 28) | (1 << 27) | (1 << 24) | (temp << 12)
             | (0xF << 8) | 45)
        train = ppm_pulses(format(v, "036b"), pulse_us=500,
                           gap_zero_us=1000, gap_one_us=2000,
                           reset_us=4000, repeats=4)
        text += "".join(f"{p} {g}\n" for p, g in train) + ";end\n"
    path = tmp_path / "nexus.ook"
    path.write_text(text)
    got = []
    for cls, to_json in ((RtlTpu, event_to_json),
                         (JaxRtlTpu, jax_event_to_json)):
        rx = cls(register_all=False,
                 **({"device": "cpu"} if cls is RtlTpu else {}))
        rx.registry.register(19)
        got.append([to_json(e) for e in rx.decode_ook_file(str(path))])
    assert got[0] == got[1] and len(got[0]) == 3

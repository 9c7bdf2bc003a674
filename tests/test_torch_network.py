"""The port's network outputs and HTTP/WebSocket control server against the
JAX package's (rtl_433_tpu_torch.output.network and .http_server).

The twins of tests/test_outputs.py's cases of these modules, of every case
of tests/test_network_hardening.py, and of
tests/test_logging.py::test_http_control_reaches_radio: both packages send
the same events to the same kind of loopback stub
(tests/torch_output_cases.py), with the modules' clocks pinned, and must
give equal bytes and replies. None of them decodes IQ. The declared
differences, each tested here: the index page's title names
``rtl_433_tpu_torch``, and ``device_info`` names the receiver's device
type and ``"backend": "torch"``.
"""

import json
import os
import socket
import ssl
import sys
import time
import urllib.request

import pytest

from rtl_433_tpu import api as japi
from rtl_433_tpu.output import data_model as jdm
from rtl_433_tpu.output import http_server as jhttp
from rtl_433_tpu.output import network as jnet
from rtl_433_tpu_torch import api as tapi
from rtl_433_tpu_torch.output import data_model as tdm
from rtl_433_tpu_torch.output import http_server as thttp
from rtl_433_tpu_torch.output import network as tnet

sys.path.insert(0, os.path.dirname(__file__))
from torch_output_cases import (GpsdServer, InfluxCollector,  # noqa: E402
                                StubBroker, SyslogReceiver, WsReader,
                                get_json, make_cert, post_json,
                                tls_server_ctx, wait_for, ws_head)
from torch_replay_cases import PinnedClock  # noqa: E402

PKGS = ("jax", "port")
NET = {"jax": jnet, "port": tnet}
HTTP = {"jax": jhttp, "port": thttp}
DM = {"jax": jdm, "port": tdm}
API = {"jax": japi, "port": tapi}


def _events(pkg):
    """Events that reach every path of the sinks: a device event, one
    with a bool, a string with quotes and escapes, and a state (no
    model)."""
    E = DM[pkg].Event
    return [
        E.make(("model", "Nexus-TH"), ("id", 76), ("channel", 1),
               ("temperature_C", 21.5)),
        E.make(("model", "Acme Sensor=1"), ("id", "a,b"), ("subtype", 3),
               ("type", "TPMS"), ("battery_ok", True), ("flag", False),
               ("code", 'say "hi"'), ("pressure_kPa", 221.25)),
        E.make(("model", "Bare")),
        E.make(("src", "Input"), ("lvl", 5), ("msg", "state report")),
    ]


@pytest.fixture
def pinned(monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(NET[pkg], "time", PinnedClock())
        monkeypatch.setattr(HTTP[pkg], "time", PinnedClock())


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    return make_cert(str(tmp_path_factory.mktemp("cert")))


def test_syslog_datagrams_match_jax(pinned):
    got = {}
    for pkg in PKGS:
        rx = SyslogReceiver()
        sink = NET[pkg].SyslogSink("127.0.0.1", rx.port)
        for ev in _events(pkg):
            sink(ev)
        # an over-long message is not sent (ref src/output_udp.c:190)
        sink(DM[pkg].Event.make(("model", "x" * 1100)))
        got[pkg] = rx.read()
        rx.close()
        assert sink.log_level == 4
    assert got["port"] == got["jax"]
    msg = got["port"][0].decode()
    assert msg.startswith("<165>1 2025-10-09T08:53:20Z ")
    payload = json.loads(msg.split(" rtl_433 - - - ", 1)[1])
    assert payload["model"] == "Nexus-TH" and len(got["port"]) == 4


@pytest.mark.parametrize("fmt", [
    "rtl_433/host/devices[/model][/id]", "base[/missing:fallback]",
    "x[-channel][_subtype:none]/[hostname]", "plain/topic",
    "[/model]/[/id:0]/[/code]"])
def test_expand_topic_matches_jax(fmt):
    got = [[NET[pkg].expand_topic(fmt, ev, "host") for ev in _events(pkg)]
           for pkg in PKGS]
    assert got[0] == got[1]
    if fmt.startswith("rtl_433"):
        assert got[1][0] == "rtl_433/host/devices/Nexus-TH/76"
    if fmt.startswith("base"):
        assert got[1][0] == "base/fallback"


@pytest.mark.parametrize("qos", [0, 1])
def test_mqtt_publish_matches_jax(qos):
    """Every topic scheme (events, devices, states, availability), retained,
    at QoS 0 and 1: the same bytes on the broker's connection."""
    got = {}
    for pkg in PKGS:
        broker = StubBroker()
        client = NET[pkg].MqttClient("127.0.0.1", broker.port,
                                     client_id="test", user="u",
                                     password="p",
                                     will_topic="rtl_433/test/avail")
        sink = NET[pkg].MqttSink(
            client=client, retain=True, qos=qos,
            events="rtl_433/test/events[/model]",
            devices="rtl_433/test/devices[/model][/id]",
            states="rtl_433/test/states",
            availability="rtl_433/test/avail")
        for ev in _events(pkg):
            sink(ev)
        sink.close()
        broker.settle()
        broker.close()
        got[pkg] = ([bytes(b) for b in broker.raw], broker.publishes)
    assert got["port"] == got["jax"]
    topics = [t for t, _ in got["port"][1]]
    assert "rtl_433/test/events/Nexus-TH" in topics
    assert "rtl_433/test/devices/Nexus-TH/76/temperature_C" in topics
    assert "rtl_433/test/states" in topics
    assert topics[0] == topics[-1] == "rtl_433/test/avail"
    assert json.loads(dict(got["port"][1])[
        "rtl_433/test/events/Nexus-TH"])["id"] == 76


def test_influx_lines_match_jax():
    lines = [[NET[pkg].InfluxSink().line(ev) for ev in _events(pkg)]
             for pkg in PKGS]
    assert lines[0] == lines[1]
    assert lines[1][0].startswith("Nexus-TH,id=76,channel=1 ")
    assert "temperature_C=21.5" in lines[1][0]
    got = {}
    for pkg in PKGS:
        coll = InfluxCollector()
        sink = NET[pkg].InfluxSink(coll.url, token="secret",
                                   measurement_key="model")
        for ev in _events(pkg):
            sink(ev)
        coll.close()
        got[pkg] = coll.posts
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == "Token secret" and len(got["port"]) == 4


@pytest.mark.parametrize("spec", ["key=value,FILE", "PATH,a=1,b=2",
                                  "bare", "FILE,PATH,tag=x"])
def test_data_tagger_matches_jax(spec):
    path = "/tmp/g001_433.92M_250k.cu8"
    got = []
    for pkg in PKGS:
        tagger = NET[pkg].DataTagger(spec, current_file_fn=lambda: path)
        got.append([DM[pkg].event_to_json(tagger(ev))
                    for ev in _events(pkg)])
    assert got[0] == got[1]
    if spec == "key=value,FILE":
        ev = json.loads(got[1][0])
        assert ev["file"] == "g001_433.92M_250k.cu8" and ev["key"] == "value"


@pytest.mark.parametrize("spec", ["gpsd:127.0.0.1:{port},lat,lon",
                                  "pos=gpsd:127.0.0.1:{port},lat,alt",
                                  "gpsd:127.0.0.1:{port}",
                                  "tcp:127.0.0.1:{port},filter={{\"class\""])
def test_gpsd_tagger_matches_jax(spec):
    """-K gpsd and tcp live tags: the WATCH handshake, the TPV filter and
    the include keys (ref src/data_tag.c:26-180)."""
    got = {}
    for pkg in PKGS:
        srv = GpsdServer()
        tagger = NET[pkg].DataTagger(spec.format(port=srv.port))
        try:
            assert wait_for(lambda: tagger.client.msg.startswith(
                '{"class":"TPV"'))
            got[pkg] = ([DM[pkg].event_to_json(tagger(ev))
                         for ev in _events(pkg)], srv.watches)
        finally:
            tagger.close()
            srv.close()
    assert got["port"] == got["jax"]
    ev = json.loads(got["port"][0][0])
    if spec.startswith("gpsd:127.0.0.1:{port},"):
        assert (ev["lat"], ev["lon"]) == (12.34, 56.78) and "alt" not in ev
        assert b"WATCH" in got["port"][1][0]


def test_mqtts_cli_flags_match_jax():
    """mqtts/tls options reach the client config (no handshake here)."""
    keys = ("tls", "tls_insecure", "tls_ca_cert", "tls_cert", "tls_key",
            "port", "host")
    for kw in (dict(tls=True, tls_insecure=True),
               dict(tls_ca_cert="/tmp/ca.pem"),
               dict(tls_cert="/tmp/c.pem", tls_key="/tmp/k.pem"),
               dict()):
        c = [NET[pkg].MqttClient("h", 8883, **kw) for pkg in PKGS]
        assert [getattr(c[0], k) for k in keys] == \
            [getattr(c[1], k) for k in keys]
        assert c[1].tls == bool(kw)


def _receiver(pkg):
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return API[pkg].RtlTpu(register_all=True, **extra)


def _http_round(pkg):
    """Every endpoint of one package's server with a receiver: the
    replies, in order, and the receiver after them."""
    rx = _receiver(pkg)
    sink = HTTP[pkg].HttpServerSink(rx, "127.0.0.1", 0)
    port = sink.server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    out = []
    try:
        for ev in _events(pkg):
            sink(ev)
        out.append(urllib.request.urlopen(base + "/").read())
        out.append(urllib.request.urlopen(base + "/metrics").read())
        for q in ("settings", "registered_protocols", "enabled_protocols",
                  "protocol_info"):
            out.append(get_json(port, f"/cmd?cmd={q}"))
        out.append(post_json(port, "/cmd", {"cmd": "sample_rate",
                                            "val": 1024000}))
        out.append(rx.sample_rate)
        for cmd, val in (("center_frequency", 868.3e6), ("gain", 12.5),
                         ("gain", "auto"), ("ppm_error", 3),
                         ("hop_interval", 30), ("protocol", -19),
                         ("protocol", 19), ("convert", "si"),
                         ("report_meta", 1), ("settings", None)):
            out.append(post_json(port, "/cmd", {"cmd": cmd, "val": val}))
        out.append((rx.convert, rx.report_meta, rx.center_frequency))
        for body in ({"jsonrpc": "2.0", "id": 7,
                      "method": "enabled_protocols"},
                     {"jsonrpc": "2.0", "id": 8, "method": "sample_rate",
                      "params": {"val": 250000}},
                     {"jsonrpc": "2.0", "id": 9, "method": "gain",
                      "params": [20]},
                     {"jsonrpc": "2.0", "id": 10, "method": "no_such"}):
            out.append(post_json(port, "/jsonrpc", body))
        try:
            urllib.request.urlopen(base + "/nowhere")
        except urllib.error.HTTPError as e:
            out.append(e.code)
        reader = WsReader(port)
        reader.start()
        assert wait_for(lambda: len(reader.frames) >= 4)
        sink(DM[pkg].Event.make(("model", "After"), ("id", 1)))
        assert wait_for(lambda: len(reader.frames) >= 5)
        reader.close()
        out += [ws_head(reader.head), reader.frames]
        out.append(get_json(port, "/cmd?cmd=device_info"))
    finally:
        sink.close()
    return out


def test_http_server_endpoints_match_jax(pinned):
    got = {pkg: _http_round(pkg) for pkg in PKGS}
    port, jax = got["port"], got["jax"]
    # declared: the index page's title and device_info name the package
    assert jax[0].replace(b"rtl_433_tpu", b"rtl_433_tpu_torch") == port[0]
    assert b"<title>rtl_433_tpu_torch</title>" in port[0]
    assert jax[-1] == {"driver": "tpu", "backend": "jax"}
    assert port[-1] == {"driver": "cpu", "backend": "torch"}
    assert port[1:-1] == jax[1:-1]
    metrics = port[1].decode()
    assert "rtl433_events_total 4" in metrics
    assert port[6:8] == [{"sample_rate": 1024000}, 1024000]
    assert port[-3][0] == "HTTP/1.1 101 Switching Protocols"
    assert json.loads(port[-2][0])["model"] == "Nexus-TH"
    assert json.loads(port[-2][-1])["model"] == "After"


def test_device_info_names_the_receivers_device():
    """A declared difference: the driver is the receiver's device type."""
    sink = thttp.HttpServerSink.__new__(thttp.HttpServerSink)
    sink.receiver = tapi.RtlTpu(register_all=False, device="cpu")
    assert sink.handle_cmd("device_info", None) == {"driver": "cpu",
                                                    "backend": "torch"}
    sink.receiver = None
    assert sink.handle_cmd("device_info", None) == {"driver": None,
                                                    "backend": "torch"}


def test_http_control_reaches_radio_matches_jax():
    """gain/ppm_error/hop_interval/frequency verbs drive the live tuner
    the same way in both packages (ref src/r_api.c:82-115)."""
    got = {}
    for pkg in PKGS:
        calls = []

        class FakeLive:
            def set_center_freq(self, v):
                calls.append(("freq", v))

            def set_sample_rate(self, v):
                calls.append(("rate", v))

            def set_gain_mode(self, m):
                calls.append(("gain_mode", m))

            def set_gain(self, v):
                calls.append(("gain", v))

            def set_freq_correction(self, v):
                calls.append(("ppm", v))

        rx = _receiver(pkg)
        rx._live = FakeLive()
        sink = HTTP[pkg].HttpServerSink.__new__(HTTP[pkg].HttpServerSink)
        sink.receiver = rx
        replies = [sink.handle_cmd(c, v) for c, v in (
            ("gain", 28.1), ("gain", "auto"), ("ppm_error", 43),
            ("hop_interval", 45), ("center_frequency", 868_300_000),
            ("sample_rate", 1_024_000), ("settings", None))]
        with pytest.raises(ValueError, match="unknown cmd"):
            sink.handle_cmd("bogus", 1)
        rx._live = None
        got[pkg] = (calls, replies, rx.gain_db, rx.ppm_error, rx._hop_times)
    assert got["port"] == got["jax"]
    calls, replies = got["port"][:2]
    assert ("gain", 281) in calls and calls[1] == ("gain_mode", 0)
    assert ("ppm", 43) in calls and ("freq", 868_300_000) in calls
    assert replies[-1]["ppm_error"] == 43 and \
        replies[-1]["hop_interval"] == 45


# ---------------------------------------------------------------------------
# the twins of tests/test_network_hardening.py

def test_mqtt_tls_handshake_and_publish_matches_jax(cert):
    """mqtts with a CA-verified self-signed broker certificate."""
    got = {}
    for pkg in PKGS:
        broker = StubBroker(tls_ctx=tls_server_ctx(*cert))
        try:
            cli = NET[pkg].MqttClient("127.0.0.1", broker.port, tls=True,
                                      tls_ca_cert=cert[0])
            cli.connect()
            cli.publish("rtl_433/test", '{"model":"TLS-Test"}')
            cli.close()
            broker.settle()
            got[pkg] = ([bytes(b) for b in broker.raw], broker.publishes)
        finally:
            broker.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [("rtl_433/test", '{"model":"TLS-Test"}')]


def test_mqtt_tls_rejects_untrusted_cert_like_jax(cert):
    """Without the CA the handshake fails in both: no silent insecure
    send."""
    errs = {}
    for pkg in PKGS:
        broker = StubBroker(tls_ctx=tls_server_ctx(*cert))
        try:
            cli = NET[pkg].MqttClient("127.0.0.1", broker.port, tls=True)
            with pytest.raises((ssl.SSLError, ConnectionError,
                                OSError)) as e:
                cli.connect()
            errs[pkg] = (type(e.value), broker.publishes)
        finally:
            broker.close()
    assert errs["port"] == errs["jax"]
    assert issubclass(errs["port"][0], ssl.SSLError)


def test_mqtt_tls_insecure_allows_selfsigned_like_jax(cert):
    got = {}
    for pkg in PKGS:
        broker = StubBroker(tls_ctx=tls_server_ctx(*cert))
        try:
            cli = NET[pkg].MqttClient("127.0.0.1", broker.port, tls=True,
                                      tls_insecure=True)
            cli.connect()
            cli.publish("t", "x")
            cli.close()
            broker.settle()
            got[pkg] = [bytes(b) for b in broker.raw]
        finally:
            broker.close()
    assert got["port"] == got["jax"] and got["port"][0].endswith(b"\xe0\x00")


def test_mqtt_reconnects_after_broker_drop_like_jax():
    """The broker drops the connection after the first publish; a later
    publish reconnects and delivers, in both packages alike."""
    got = {}
    for pkg in PKGS:
        broker = StubBroker(drop_after_publishes=1)
        try:
            cli = NET[pkg].MqttClient("127.0.0.1", broker.port)
            cli.connect()
            cli.publish("a", "1")
            assert wait_for(lambda: len(broker.publishes) >= 1)
            # the drop lands client-side; the first send may die on the
            # dead socket (detected, socket reset), a later one reconnects
            time.sleep(0.2)
            for _ in range(3):
                cli.publish("b", "2")
            assert wait_for(lambda: any(t == "b"
                                        for t, _ in broker.publishes))
            cli.close()
            broker.settle()
            got[pkg] = (broker.connects >= 2, broker.publishes[0],
                        [t for t, _ in broker.publishes][1:2])
        finally:
            broker.close()
    assert got["port"] == got["jax"] == (True, ("a", "1"), ["b"])


def _read_some(port, request, wait=0.6):
    s = socket.create_connection(("127.0.0.1", port), timeout=2)
    s.sendall(request)
    s.settimeout(wait)
    buf = b""
    try:
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
    except (TimeoutError, socket.timeout):
        pass
    finally:
        s.close()
    return buf.decode(errors="replace")


def _strip_date(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("Date:"))


def test_ws_malformed_client_does_not_kill_server_like_jax(pinned):
    got = {}
    for pkg in PKGS:
        srv = HTTP[pkg].HttpServerSink(host="127.0.0.1", port=0)
        port = srv.server.server_address[1]
        seen = []
        try:
            srv(DM[pkg].Event.make(("model", "WS-Test"), ("id", 7)))
            seen.append(_strip_date(_read_some(
                port, b"GET /events HTTP/1.1\r\nHost: x\r\n\r\n")))
            s = socket.create_connection(("127.0.0.1", port), timeout=2)
            s.sendall(b"\x00\xff\x13\x37 not http at all\r\n\r\n")
            s.close()
            bad = _read_some(port, b"GET /ws HTTP/1.1\r\nHost: x\r\n"
                                   b"Connection: Upgrade\r\n"
                                   b"Upgrade: websocket\r\n\r\n")
            seen.append(bad.splitlines()[0])
            upgrade = (b"GET /ws HTTP/1.1\r\nHost: x\r\n"
                       b"Connection: Upgrade\r\nUpgrade: websocket\r\n"
                       b"Sec-WebSocket-Key: AAAAAAAAAAAAAAAAAAAAAA==\r\n"
                       b"Sec-WebSocket-Version: 13\r\n\r\n")
            for tail in (b"\x81", b"\x81\xFF" + b"\xff" * 8):
                s = socket.create_connection(("127.0.0.1", port), timeout=2)
                s.sendall(upgrade)
                s.settimeout(2)
                seen.append(b"101" in s.recv(1024))
                s.sendall(tail)
                s.close()
            time.sleep(0.3)
            seen.append(_strip_date(_read_some(
                port, b"GET /events HTTP/1.1\r\nHost: x\r\n\r\n")))
            srv(DM[pkg].Event.make(("model", "After-Malformed"), ("id", 8)))
            seen.append(_strip_date(_read_some(
                port, b"GET /events HTTP/1.1\r\nHost: x\r\n\r\n")))
        finally:
            srv.close()
        got[pkg] = seen
    assert got["port"] == got["jax"]
    seen = got["port"]
    assert "WS-Test" in seen[0] and "400" in seen[1]
    assert seen[2:4] == [True, True]
    assert "WS-Test" in seen[4] and "After-Malformed" in seen[5]

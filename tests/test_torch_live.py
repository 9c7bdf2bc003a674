"""Live input over rtl_tcp: the port against the JAX package.

Each package's ``run_live`` (or ``cli.main -d``) runs against a loopback
server of its own that streams the same blocks (tests/torch_live_cases.py),
with the API module's clock pinned or stepped, so that both decode the same
blocks at the same clock: the same events, the same commands at the
server, the same exit codes and state. The cases are the twins of
tests/test_rtltcp.py (decode, gain and ppm, passthrough, the watchdog's
quit and restart, the 1.024 MS/s ring sustain), the two packages' clients
and servers against each other, their block rings under one push/pop
sequence, hopping (``-f``/``-H``, ``-E hop``, ``-E quit``, ``-T``),
SIGUSR1/SIGUSR2/SIGHUP, and the CLI's ``-d`` with ``-F rtltcp``.
"""

import functools
import json
import os
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest

from rtl_433_tpu import api as japi
from rtl_433_tpu import cli as jcli
from rtl_433_tpu.io import native as jnative
from rtl_433_tpu.io import rtltcp as jrtltcp
from rtl_433_tpu.output.data_model import event_to_json as jjson
from rtl_433_tpu_torch import api as tapi
from rtl_433_tpu_torch import cli as tcli
from rtl_433_tpu_torch.io import native as tnative
from rtl_433_tpu_torch.io import rtltcp as trtltcp
from rtl_433_tpu_torch.output.data_model import event_to_json as tjson

sys.path.insert(0, os.path.dirname(__file__))
from synth import synth_ook  # noqa: E402
from torch_live_cases import (BLOCK, HEADER, LoopbackRtlTcp,  # noqa: E402
                              Passthrough, free_port)
from torch_replay_cases import PinnedClock, run_cli  # noqa: E402

PKGS = ("jax", "port")
API = {"jax": japi, "port": tapi}
RTLTCP = {"jax": jrtltcp, "port": trtltcp}
TO_JSON = {"jax": jjson, "port": tjson}
SIGNALS = (signal.SIGHUP, signal.SIGUSR1, signal.SIGUSR2)


def _nexus(seed=1):
    """One 131072-sample block of noise with a Nexus-TH burst at 2000."""
    word = (0x4C << 28) | (1 << 27) | (215 << 12) | (0xF << 8) | 45
    bits = [(word >> (35 - i)) & 1 for i in range(36)]
    pulses = []
    for _ in range(4):
        pulses += [(500, 2000 if b else 1000) for b in bits]
        pulses.append((500, 4000))
    sig = synth_ook(pulses, rate=250_000)
    iq = np.random.default_rng(seed).integers(123, 133, size=(BLOCK, 2),
                                              dtype=np.uint8)
    iq[2000:2000 + sig.shape[0]] = sig
    return iq


QUIET = np.full((BLOCK, 2), 128, np.uint8)


class StepClock(PinnedClock):
    """The pinned clock, but every read of the monotonic clock moves it on
    by ``step`` seconds: hops and deadlines fall on the same blocks in both
    packages."""

    def __init__(self, step=1.0):
        super().__init__()
        self.step = step

    def monotonic(self):
        self.mono += self.step
        return self.mono


@pytest.fixture(autouse=True)
def _restore_signals():
    """run_live installs its signal handlers for good; put ours back."""
    saved = {s: signal.getsignal(s) for s in SIGNALS}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.fixture(scope="module", autouse=True)
def _warm():
    """Trace the JAX block step of the receivers below (and build the
    port's libraries) before any watchdog runs: a first-block compile longer
    than two watchdog ticks reads as a stall. Every case streams whole
    131072-sample blocks, so this is the one JAX trace of the module."""
    for pkg in PKGS:
        _receiver(pkg).push_block(QUIET)


def _receiver(pkg, **kw):
    extra = {} if pkg == "jax" else {"device": "cpu"}
    rx = API[pkg].RtlTpu(register_all=False, **kw, **extra)
    rx.registry.register(19)
    return rx


def _live(pkg, blocks, monkeypatch, clock=None, rx_kw=None, srv_kw=None,
          before_block=None, **run_kw):
    """run_live of ``pkg`` on its own server of ``blocks``: (receiver,
    events as JSON, the server, the number of blocks pushed)."""
    monkeypatch.setattr(API[pkg], "_time", clock or PinnedClock())
    rx = _receiver(pkg, **(rx_kw or {}))
    pushed = []
    real = rx.push_block

    def push(iq, *a, **k):
        if before_block is not None:
            before_block(rx, len(pushed))
        pushed.append(iq.shape[0])
        return real(iq, *a, **k)

    rx.push_block = push
    srv = LoopbackRtlTcp(blocks, **(srv_kw or {}))
    srv.start()
    run_kw.setdefault("block_samples", blocks[0].shape[0])
    rx.run_live(srv.device, **run_kw)
    srv.join(timeout=30)
    assert not srv.is_alive()
    return rx, [TO_JSON[pkg](e) for e in rx.events], srv, len(pushed)


def _both(blocks, monkeypatch, clock=StepClock, **kw):
    """The same live run in both packages: {pkg: (rx, events, srv, n)}."""
    return {pkg: _live(pkg, blocks, monkeypatch, clock=clock(), **kw)
            for pkg in PKGS}


def _same(res):
    j, t = res["jax"], res["port"]
    assert t[1] == j[1]                        # events, as JSON
    assert t[2].commands == j[2].commands      # (cmd, param) at the server
    assert t[3] == j[3]                        # blocks pushed
    # (the watchdog's state depends on how many ticks fell in the run)
    assert (t[0].exit_code, t[0].center_frequency) == \
        (j[0].exit_code, j[0].center_frequency)


def test_ring_matches_jax():
    """One push/pop sequence on both packages' block rings: the same pops,
    fill and drop count."""
    rng = np.random.default_rng(7)
    rings = [jnative.BlockRing(64, 4), tnative.BlockRing(64, 4)]
    seq = rng.integers(0, 3, 80)
    for step, op in enumerate(seq):
        got = []
        for r in rings:
            if op:
                blk = np.full(64, step % 256, np.uint8)
                got.append(r.push(blk))
            else:
                out = r.pop()
                got.append(None if out is None else out.tobytes())
            got.append((r.fill, r.dropped))
        assert got[:2] == got[2:]
    assert rings[1].dropped > 0
    with pytest.raises(ValueError):
        rings[1].push(np.zeros(65, np.uint8))


def test_ring_build_failure_raises(tmp_path, monkeypatch):
    """A ring source that does not compile raises with the compiler's
    output; there is no Python ring to fall back to."""
    from rtl_433_tpu_torch.ops import _native
    bad = tmp_path / "ingest.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_native, "INGEST_SOURCE", str(bad))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match=r"c\+\+ failed for csrc/ingest"):
        tnative.BlockRing(64, 4)


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_passthrough_wire(server, client):
    """RtlTcpServer -> RtlTcpClient, within the port and across the two
    packages: the header's tuner type and one block byte for byte."""
    srv = RTLTCP[server].RtlTcpServer("127.0.0.1", 0)
    try:
        cli = RTLTCP[client].RtlTcpClient("127.0.0.1", srv.port,
                                          block_samples=256)
        cli.connect()
        assert (cli.tuner_type, cli.gain_count) == (5, 29)
        cli.set_center_freq(433920000)
        for _ in range(100):
            if srv.clients:
                break
            time.sleep(0.02)
        blk = np.arange(512, dtype=np.uint8).reshape(256, 2)
        srv.broadcast(blk)
        got = []

        def on_block(iq):
            got.append(iq.copy())
            # the client's receiver thread sees the end at once
            for c in list(srv.clients):
                c.shutdown(socket.SHUT_RDWR)

        cli.run(on_block, max_blocks=1)
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], blk)
    finally:
        srv.close()


def test_live_decode_matches_jax(monkeypatch):
    res = _both([_nexus()], monkeypatch, clock=PinnedClock, max_blocks=1)
    _same(res)
    ev = json.loads(res["port"][1][-1])
    assert ev["model"] == "Nexus-TH" and ev["id"] == 0x4C
    assert ev["temperature_C"] == pytest.approx(21.5)
    assert res["port"][2].commands == [(0x02, 250000), (0x01, 433920000)]
    assert res["port"][0].exit_code == 0


def test_live_gain_ppm_match_jax(monkeypatch):
    """-g / -p reach the tuner as 0x03 manual mode, 0x04 gain in tenths of
    a dB and 0x05 ppm, in JAX's order."""
    res = _both([QUIET], monkeypatch, max_blocks=1,
                rx_kw=dict(gain_db=28.1, ppm_error=43))
    _same(res)
    assert res["port"][2].commands == [(2, 250000), (1, 433920000), (3, 1),
                                       (4, 281), (5, 43)]


def test_live_retune_setters_match_jax(monkeypatch):
    """The setters reach the connected tuner at once (frequency, rate,
    gain and AGC, ppm) in JAX's order; a retune drops the pipeline, and
    the block decodes on the new one."""
    def retune(rx, k):
        rx.set_frequency(434_000_000)
        rx.set_sample_rate(250_000)
        rx.set_gain(12.5)
        rx.set_gain("auto")
        rx.set_ppm_error(7)     # a negative one raises in JAX (ROADMAP)
        rx.set_hop_interval(0.2)

    res = _both([QUIET], monkeypatch, max_blocks=1, before_block=retune)
    _same(res)
    assert res["port"][2].commands == [
        (2, 250000), (1, 433920000), (1, 434000000), (2, 250000), (3, 1),
        (4, 125), (3, 0), (5, 7)]
    assert res["port"][0]._hop_times == [1]


@pytest.mark.parametrize("how", ["option", "setter"])
def test_live_negative_ppm_on_the_wire(how, monkeypatch):
    """A negative ppm, from -p or from set_ppm_error, reaches the server as
    the 32-bit two's complement rtl_tcp carries. The JAX client raises
    struct.error here (ROADMAP Queue 3), so the port is held to the wire
    contract alone."""
    if how == "option":
        kw = dict(rx_kw=dict(ppm_error=-3))
    else:
        kw = dict(before_block=lambda rx, k: rx.set_ppm_error(-3))
    rx, _, srv, n = _live("port", [QUIET], monkeypatch, max_blocks=1, **kw)
    assert n == 1 and rx.exit_code == 0
    assert srv.commands == [(2, 250000), (1, 433920000),
                            (5, (-3) & 0xFFFFFFFF)]


def _stops(monkeypatch):
    """The clients each package's watchdog stopped (RtlTcpClient.stop; a
    tick that finds the stream still stalled stops the client again)."""
    stopped = {pkg: set() for pkg in PKGS}
    for pkg in PKGS:
        real = RTLTCP[pkg].RtlTcpClient.stop

        def stop(self, _pkg=pkg, _real=real):
            stopped[_pkg].add(id(self))
            _real(self)

        monkeypatch.setattr(RTLTCP[pkg].RtlTcpClient, "stop", stop)
    return stopped


@pytest.mark.parametrize("mode,accepts", [("quit", 1), ("restart", 2)])
def test_watchdog_matches_jax(mode, accepts, monkeypatch):
    """A block, then a silent open connection: the watchdog marks the
    stall (exit code 3). quit ends there; restart reconnects and, once the
    server refuses, ends with exit code 3 too."""
    stops = _stops(monkeypatch)
    res = {}
    for pkg in PKGS:
        res[pkg] = _live(
            pkg, [QUIET], monkeypatch, clock=PinnedClock(),
            srv_kw=dict(hold=lambda k, _p=pkg: len(stops[_p]) >= k,
                        accepts=accepts),
            run_mode=mode, watchdog_interval=0.3)
    _same(res)
    for pkg in PKGS:
        rx, _, srv, n = res[pkg]
        assert (rx.exit_code, rx._dev_state) == (3, "stopped")
        assert (srv.n_connects, n, len(stops[pkg])) == \
            (accepts, accepts, accepts)


def test_ring_sustains_1msps_without_drops():
    """The port's client at 1.024 MS/s with 20 ms of work a block: every
    block arrives, none is dropped."""
    srv = LoopbackRtlTcp([QUIET] * 16, rate=1_024_000)
    srv.start()
    cli = trtltcp.RtlTcpClient("127.0.0.1", srv.port, block_samples=BLOCK)
    cli.connect()
    got = []

    def on_block(iq):
        time.sleep(0.02)
        got.append(iq.shape[0])

    cli.run(on_block)
    srv.join(timeout=30)
    assert got == [BLOCK] * 16
    assert cli.blocks_dropped == 0


F2 = 915_000_000

HOPS = {
    # -f 433.92M -f 915M -H 1 -T 2 on the stepped clock (a second a
    # read): the first block hops, the second ends the run by -T (and does
    # not hop)
    "hop_interval_duration": ([QUIET] * 3,
                              dict(frequencies=[433_920_000, F2],
                                   hop_times=[1], duration=2.0)),
    # -E hop: hop after the block with an event
    "after_events_hop": ([_nexus()], dict(frequencies=[433_920_000, F2],
                                          after_events="hop")),
    # -E quit: stop after the block with an event
    "after_events_quit": ([_nexus(), QUIET], dict(after_events="quit")),
}


@pytest.mark.parametrize("name", list(HOPS))
def test_hopping_matches_jax(name, monkeypatch):
    blocks, kw = HOPS[name]
    # no watchdog tick in these runs: a slow first block is no stall here
    res = _both(blocks, monkeypatch, watchdog_interval=60, **kw)
    _same(res)
    rx, events, srv, n = res["port"]
    freqs = [p for c, p in srv.commands if c == 0x01]
    want = {"hop_interval_duration": ([433_920_000, F2], 2, 0),
            "after_events_hop": ([433_920_000, F2], 1, 1),
            "after_events_quit": ([433_920_000], 1, 1)}[name]
    assert (freqs, n, len(events)) == want


def test_signals_match_jax(monkeypatch):
    """SIGUSR1 hops after the block it arrives in, SIGUSR2 emits a stats
    report through the sinks in that block, SIGHUP flushes the dumpers at
    the next watchdog tick; sent to this process with os.kill."""
    flushes = {pkg: [] for pkg in PKGS}
    reports = {pkg: [] for pkg in PKGS}

    class File:
        def __init__(self, pkg):
            self.pkg = pkg

        def flush(self):
            flushes[self.pkg].append(1)

    class Dumper:
        format = "none"
        wants_streams = wants_logic = False

        def __init__(self, pkg):
            self.file = File(pkg)

        def push(self, *a, **k):
            pass

    def before(rx, k):
        for s in SIGNALS:
            os.kill(os.getpid(), s)

    res = {}
    for pkg in PKGS:
        def setup(rx, k, _pkg=pkg):
            if k == 0:
                rx.dumpers.append(Dumper(_pkg))
                rx.sinks.append(
                    lambda ev: reports[_pkg].append(TO_JSON[_pkg](ev)))
            before(rx, k)

        # the server holds the stream open until the watchdog's flush; the
        # run ends before a second tick could call it a stall
        res[pkg] = _live(
            pkg, [QUIET], monkeypatch, before_block=setup,
            srv_kw=dict(hold=lambda k, _p=pkg: len(flushes[_p]) > 0),
            frequencies=[433_920_000, F2], watchdog_interval=1.5)
    _same(res)
    assert reports["port"] == reports["jax"]
    assert len(reports["port"]) == 1 and '"frames"' in reports["port"][0]
    for pkg in PKGS:
        rx, _, srv, n = res[pkg]
        assert len(flushes[pkg]) == 1 and not rx._sig_hup
        assert [p for c, p in srv.commands if c == 0x01] == \
            [433_920_000, F2]
        assert (rx.exit_code, n) == (0, 1)


@pytest.mark.parametrize("extra", [[], ["-n", "131072", "-M", "stats:1"]],
                         ids=["json_rtltcp", "n_and_stats"])
def test_cli_live_matches_jax(extra, monkeypatch):
    """cli.main -d with -F rtltcp: the same exit code, stdout and stderr
    as the JAX CLI, and the same bytes at a passthrough client (the header,
    then every block decoded)."""
    # the CLI's watchdog ticks every 1.5 s in real time: a first block
    # slower than two ticks on a loaded core read as a stall (exit code 3)
    # in one package alone. No tick falls in these runs, as in the
    # file's other cases (watchdog_interval=60)
    for pkg in PKGS:
        cls = API[pkg].RtlTpu
        monkeypatch.setattr(cls, "run_live", functools.partialmethod(
            cls.run_live, watchdog_interval=60))
    blocks = [_nexus(), QUIET] if extra else [_nexus()]
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        port = free_port()
        reader = Passthrough(port)
        reader.start()
        srv = LoopbackRtlTcp(blocks, gate=reader.connected)
        srv.start()
        argv = ["-R", "19", "-d", srv.device, "-F", "json", "-F",
                f"rtltcp:127.0.0.1:{port}"] + extra
        if pkg == "port":
            argv += ["--device", "cpu"]
        res = run_cli(main, argv)
        reader.done.set()
        srv.join(timeout=30)
        reader.join(timeout=30)
        out[pkg] = res, srv.commands, reader.data
    assert out["port"] == out["jax"]
    (rc, stdout, _), _, data = out["port"]
    assert rc == 0 and '"Nexus-TH"' in stdout
    assert data == HEADER + blocks[0].tobytes()


def test_http_retune_between_blocks_matches_jax(monkeypatch):
    """A POST /cmd center_frequency within the band, answered between two
    gated blocks: the server holds the second block until the reply, so
    the retune falls after the first block in both packages (the port's
    waits on the receiver's lock, JAX's on nothing). The same events,
    their frequency meta from the new tuning, the same commands at the
    server and the same replies."""
    from rtl_433_tpu.output import http_server as jhttp
    from rtl_433_tpu_torch.output import http_server as thttp
    from torch_output_cases import get_json, post_json

    http = {"jax": jhttp, "port": thttp}
    res = {}
    for pkg in PKGS:
        monkeypatch.setattr(API[pkg], "_time", PinnedClock())
        rx = _receiver(pkg, report_meta=True)
        sink = http[pkg].HttpServerSink(rx, "127.0.0.1", 0)
        rx.sinks.append(sink)
        port = sink.server.server_address[1]
        first_done, retuned = threading.Event(), threading.Event()
        real = rx.push_block

        def push(iq, *a, _real=real, _done=first_done, **k):
            out = _real(iq, *a, **k)
            _done.set()
            return out

        rx.push_block = push
        replies = []

        def retune(_port=port, _done=first_done, _ok=retuned):
            _done.wait(60)
            replies.append(post_json(_port, "/cmd", {
                "cmd": "center_frequency", "val": 434_050_000}))
            replies.append(get_json(_port, "/cmd?cmd=settings"))
            _ok.set()

        t = threading.Thread(target=retune, daemon=True)
        t.start()
        srv = LoopbackRtlTcp([_nexus(), _nexus(seed=2)],
                             pause=(1, retuned))
        srv.start()
        try:
            rx.run_live(srv.device, block_samples=BLOCK,
                        watchdog_interval=60)
        finally:
            sink.close()
        t.join(30)
        srv.join(30)
        res[pkg] = ([TO_JSON[pkg](e) for e in rx.events], srv.commands,
                    replies, rx.exit_code)
    assert res["port"] == res["jax"]
    events, commands, replies, rc = res["port"]
    assert rc == 0 and len(events) == 2
    freqs = [json.loads(e)["freq"] for e in events]
    assert freqs[1] - freqs[0] == pytest.approx(0.13)
    assert commands == [(0x02, 250000), (0x01, 433920000),
                        (0x01, 434050000)]
    assert replies[0] == {"center_frequency": 434050000.0}
    assert replies[1]["frequency"] == 434050000.0

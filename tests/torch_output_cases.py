"""Loopback stubs for the network outputs, shared by the port's CPU tests
and chip_smoke.py's ``outputs`` phase.

- ``SyslogReceiver``: a UDP socket that keeps every datagram;
- ``StubBroker``: an MQTT 3.1.1 broker (CONNECT/CONNACK, PUBLISH recorded
  with its raw bytes, PUBACK for QoS 1, an optional drop after N
  publishes, optional TLS);
- ``InfluxCollector``: an HTTP server that keeps every POST;
- ``GpsdServer``: a gpsd line server that answers a WATCH (or half a
  second without one) with one VERSION and one fixed TPV line;
- ``WsReader``: a WebSocket client of ``/ws`` that keeps every text frame.

``network_argv`` builds the ``-F``/``-K`` options of every network output
against a set of stubs, ``observed`` collects what each stub received, and
``hooked`` patches a package's output modules for a CLI run: their clocks
pinned, a ``WsReader`` on every HTTP server it starts (read to the last
event before the server closes) and every gpsd tagger holding its first
TPV before the decode starts; ``run_network_cli`` is a CLI run with all
of it. ``make_cert`` writes a self-signed
certificate for 127.0.0.1 (it needs the ``cryptography`` package).
Imports neither torch nor jax.
"""

import base64
import contextlib
import importlib
import json
import os
import socket
import ssl
import struct
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from torch_replay_cases import PinnedClock, run_cli

TPV = b'{"class":"TPV","lat":12.34,"lon":56.78,"alt":9.0}'


def wait_for(cond, timeout=10.0, step=0.005):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(step)
    return cond()


class SyslogReceiver:
    """UDP on 127.0.0.1: every datagram, in arrival order."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]

    def read(self, quiet=0.2):
        """The datagrams received until none comes for ``quiet`` s."""
        out = []
        self.sock.settimeout(quiet)
        try:
            while True:
                out.append(self.sock.recv(65536))
        except (socket.timeout, OSError):
            pass
        return out

    def close(self):
        self.sock.close()


class StubBroker:
    """An MQTT broker on 127.0.0.1 for any number of clients: answers
    CONNECT with CONNACK, records each PUBLISH (topic, payload) and the raw
    bytes of every connection, acknowledges QoS 1, and drops a connection
    after ``drop_after_publishes`` publishes when given one."""

    def __init__(self, tls_ctx=None, drop_after_publishes=None):
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self.tls_ctx = tls_ctx
        self.drop_after = drop_after_publishes
        self.publishes = []
        self.raw = []          # bytes of each connection, in accept order
        self.connects = 0
        self.lock = threading.Lock()
        self.alive = True
        self._serving = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        self.srv.settimeout(0.05)
        while self.alive:
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self.lock:
                self.raw.append(bytearray())
                slot = len(self.raw) - 1
            t = threading.Thread(target=self._serve, args=(conn, slot),
                                 daemon=True)
            self._serving.append(t)
            t.start()

    def _read_packet(self, conn, slot):
        def recv(n):
            buf = b""
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    return None
                buf += chunk
            self.raw[slot] += buf
            return buf

        h = recv(1)
        if h is None:
            return None, None
        mult, rem = 1, 0
        while True:
            b = recv(1)
            if b is None:
                return None, None
            rem += (b[0] & 0x7F) * mult
            if not b[0] & 0x80:
                break
            mult *= 128
        body = recv(rem) if rem else b""
        if body is None:
            return None, None
        return h[0], body

    def _serve(self, conn, slot):
        try:
            if self.tls_ctx:
                conn = self.tls_ctx.wrap_socket(conn, server_side=True)
            typ, body = self._read_packet(conn, slot)
            if typ is None or (typ >> 4) != 1:  # CONNECT
                conn.close()
                return
            with self.lock:
                self.connects += 1
            conn.sendall(bytes([0x20, 2, 0, 0]))  # CONNACK ok
            n_pub = 0
            while True:
                typ, body = self._read_packet(conn, slot)
                if typ is None:
                    return
                if (typ >> 4) == 3:  # PUBLISH
                    tlen = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tlen].decode()
                    rest = body[2 + tlen:]
                    if (typ >> 1) & 3:
                        mid = struct.unpack(">H", rest[:2])[0]
                        rest = rest[2:]
                        conn.sendall(bytes([0x40, 2]) +
                                     struct.pack(">H", mid))
                    with self.lock:
                        self.publishes.append((topic, rest.decode()))
                    n_pub += 1
                    if self.drop_after is not None and \
                            n_pub >= self.drop_after:
                        conn.close()
                        return
                elif (typ >> 4) == 14:  # DISCONNECT
                    conn.close()
                    return
        except (OSError, ssl.SSLError):
            pass

    def settle(self, timeout=10.0):
        """Wait for every connection so far to end (a client's DISCONNECT
        or close)."""
        for t in list(self._serving):
            t.join(timeout)

    def close(self):
        self.alive = False
        self.thread.join(2)
        try:
            self.srv.close()
        except OSError:
            pass


class InfluxCollector:
    """An HTTP server on 127.0.0.1 that answers every POST with 204 and
    keeps (path, Authorization header, body)."""

    def __init__(self):
        self.posts = []
        coll = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                coll.posts.append((self.path,
                                   self.headers.get("Authorization"),
                                   body.decode()))
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}/api/v2/write?bucket=rtl_433"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class GpsdServer:
    """A gpsd on 127.0.0.1: to each client it reads the WATCH, then sends
    a VERSION line and ``TPV``, and keeps the connection open until
    ``close``. ``watches`` holds what each client sent first."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self.watches = []
        self.conns = []
        self.alive = True
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        self.srv.settimeout(0.05)
        while self.alive:
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.conns.append(conn)
            try:
                # a tcp: tag client sends no WATCH unless given init=
                conn.settimeout(0.5)
                try:
                    self.watches.append(conn.recv(256))
                except socket.timeout:
                    self.watches.append(b"")
                conn.sendall(b'{"class":"VERSION","release":"3.0"}\n'
                             + TPV + b"\n")
            except OSError:
                pass

    def close(self):
        self.alive = False
        self.thread.join(2)
        for s in [self.srv, *self.conns]:
            try:
                s.close()
            except OSError:
                pass


def ws_handshake(port, key=b"0123456789abcdef"):
    """A socket upgraded to a WebSocket on /ws: (socket, the 101 reply's
    head, the bytes after it)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    k = base64.b64encode(key).decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {k}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
    raw = b""
    while b"\r\n\r\n" not in raw:
        chunk = s.recv(4096)
        if not chunk:
            break
        raw += chunk
    head, _, rest = raw.partition(b"\r\n\r\n")
    return s, head.decode(), rest


def ws_head(head):
    """The 101 reply's lines but its Date header (the wall clock)."""
    return [ln for ln in head.split("\r\n") if not ln.startswith("Date:")]


class WsReader(threading.Thread):
    """Reads every text frame of ``/ws`` on 127.0.0.1:``port``. Between
    reads it sends a masked ping, which wakes the server's read of client
    frames, so queued events go out at once."""

    PING = bytes([0x89, 0x80, 1, 2, 3, 4])

    def __init__(self, port):
        super().__init__(daemon=True)
        self.sock, self.head, self._buf = ws_handshake(port)
        self.frames = []
        self.stop = threading.Event()

    def _frame(self):
        """One frame from the buffer: its payload, or None."""
        b = self._buf
        if len(b) < 2:
            return None
        n, at = b[1] & 0x7F, 2
        if n == 126:
            if len(b) < 4:
                return None
            n, at = struct.unpack(">H", b[2:4])[0], 4
        elif n == 127:
            if len(b) < 10:
                return None
            n, at = struct.unpack(">Q", b[2:10])[0], 10
        if len(b) < at + n:
            return None
        self._buf = b[at + n:]
        return b[at:at + n]

    def run(self):
        self.sock.settimeout(0.02)
        try:
            while not self.stop.is_set():
                frame = self._frame()
                if frame is not None:
                    self.frames.append(frame.decode())
                    continue
                try:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        return
                    self._buf += chunk
                except socket.timeout:
                    self.sock.sendall(self.PING)
        except OSError:
            pass

    def close(self):
        self.stop.set()
        self.join(5)
        try:
            self.sock.close()
        except OSError:
            pass


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def post_json(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


class Stubs:
    """One of each stub, and a trigger file in ``tmpdir``."""

    def __init__(self, tmpdir, tls_ctx=None):
        self.syslog = SyslogReceiver()
        self.broker = StubBroker(tls_ctx=tls_ctx)
        self.influx = InfluxCollector()
        self.gpsd = GpsdServer()
        self.trigger = os.path.join(tmpdir, "trigger")

    def close(self):
        for s in (self.syslog, self.broker, self.influx, self.gpsd):
            s.close()


# the -F options of the MQTT output: retained, with the devices, events and
# states topics (every publish path of MqttSink)
MQTT_OPTS = ("retain=1,events=rtl_433/test/events[/model],"
             "devices=rtl_433/test/devices[/model][/id],"
             "states=rtl_433/test/states")


def network_argv(stubs, outputs=("syslog", "mqtt", "influx", "trigger",
                                 "http"), tags=("FILE", "gpsd"),
                 mqtt_extra=""):
    """``-F`` options of ``outputs`` and ``-K`` options of ``tags`` against
    ``stubs`` (``mqtts`` in place of ``mqtt`` takes TLS options in
    ``mqtt_extra``)."""
    argv = []
    for fmt in outputs:
        if fmt == "syslog":
            spec = f"syslog:127.0.0.1:{stubs.syslog.port}"
        elif fmt in ("mqtt", "mqtts"):
            spec = (f"{fmt}:127.0.0.1:{stubs.broker.port},{MQTT_OPTS}"
                    + mqtt_extra)
        elif fmt == "influx":
            spec = f"influx:{stubs.influx.url}"
        elif fmt == "trigger":
            spec = f"trigger:{stubs.trigger}"
        elif fmt == "http":
            spec = "http:127.0.0.1:0"
        argv += ["-F", spec]
    for tag in tags:
        if tag == "gpsd":
            tag = f"gpsd:127.0.0.1:{stubs.gpsd.port},lat,lon"
        argv += ["-K", tag]
    return argv


def observed(stubs, http=()):
    """What each stub received: syslog datagrams, the broker's bytes and
    publishes, Influx's posts, the trigger file, the gpsd WATCH lines, and
    of every HTTP server the frames its WsReader read and its replies."""
    stubs.broker.settle()
    trig = None
    if os.path.exists(stubs.trigger):
        with open(stubs.trigger) as f:
            trig = f.read()
    return {"syslog": stubs.syslog.read(),
            "mqtt_raw": [bytes(b) for b in stubs.broker.raw],
            "mqtt": list(stubs.broker.publishes),
            "influx": list(stubs.influx.posts),
            "trigger": trig,
            "gpsd": list(stubs.gpsd.watches),
            "http": [dict(h) for h in http]}


@contextlib.contextmanager
def hooked(pkg, clock=None):
    """Patch package ``pkg``'s output modules for one CLI run. Yields the
    list of the run's HTTP servers, each as a dict that ends up holding
    the frames a WsReader read from its ``/ws`` (``ws``), the head of the
    upgrade's reply (``ws_head``) and its replies to ``/cmd?cmd=settings``
    and ``device_info``, read just before it closes (once every event it
    was given has reached the reader); ``port`` while it runs."""
    network = importlib.import_module(pkg + ".output.network")
    http = importlib.import_module(pkg + ".output.http_server")
    clock = clock or PinnedClock()
    servers = []
    real = {"net_time": network.time, "http_time": http.time,
            "init": http.HttpServerSink.__init__,
            "close": http.HttpServerSink.close,
            "tag": network.DataTagger.__init__}

    def init(self, *a, **k):
        real["init"](self, *a, **k)
        port = self.server.server_address[1]
        reader = WsReader(port)
        reader.start()
        self._case = {"port": port, "reader": reader}
        servers.append(self._case)

    def close(self):
        case = getattr(self, "_case", None)
        if case is not None:
            reader = case.pop("reader")
            wait_for(lambda: len(reader.frames) >= self.stats["events"])
            case["settings"] = get_json(case["port"], "/cmd?cmd=settings")
            case["device_info"] = get_json(case["port"],
                                           "/cmd?cmd=device_info")
            reader.close()
            case["ws"] = reader.frames
            case["ws_head"] = ws_head(reader.head)
            del case["port"]
        real["close"](self)

    def tag(self, spec, *a, **k):
        real["tag"](self, spec, *a, **k)
        if self.client is not None:
            wait_for(lambda: self.client.msg)

    network.time = clock
    http.time = clock
    http.HttpServerSink.__init__ = init
    http.HttpServerSink.close = close
    network.DataTagger.__init__ = tag
    try:
        yield servers
    finally:
        network.time = real["net_time"]
        http.time = real["http_time"]
        http.HttpServerSink.__init__ = real["init"]
        http.HttpServerSink.close = real["close"]
        network.DataTagger.__init__ = real["tag"]


def run_network_cli(main, argv, tmpdir, tls_ctx=None, **net):
    """``main(argv + network_argv(stubs, **net))`` through ``run_cli``
    (the API's clock pinned) under ``hooked``, against stubs of its own:
    ((exit code, stdout, stderr), what the stubs received)."""
    pkg = main.__module__.rsplit(".", 1)[0]
    os.makedirs(tmpdir, exist_ok=True)
    stubs = Stubs(tmpdir, tls_ctx=tls_ctx)
    try:
        with hooked(pkg) as servers:
            res = run_cli(main, list(argv) + network_argv(stubs, **net))
        return res, observed(stubs, servers)
    finally:
        stubs.close()


def make_cert(tmpdir):
    """A self-signed certificate for 127.0.0.1: (cert.pem, key.pem)."""
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName(
                [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem = os.path.join(tmpdir, "cert.pem")
    key_pem = os.path.join(tmpdir, "key.pem")
    with open(cert_pem, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_pem, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    return cert_pem, key_pem


def tls_server_ctx(cert, key):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    return ctx

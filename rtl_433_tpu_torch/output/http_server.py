"""HTTP/WebSocket control-plane server (ref src/http_server.c).

Endpoints (default port 8433, ref src/http_server.c:12-80):
- GET /            minimal UI page
- GET /events      chunked JSON event stream
- GET /stream      plain JSON-lines stream with 60 s CRLF keep-alive
- GET /ws          WebSocket with event-history replay on connect
- GET|POST /cmd    {"cmd": ..., "val": ...} control verbs
- POST /jsonrpc    JSON-RPC 2.0 control verbs
- GET /metrics     OpenMetrics (ref handle_openmetrics :780)

Control verbs: center_frequency, sample_rate, gain, ppm_error,
hop_interval, protocol (enable/disable), report_meta, convert; queries:
registered_protocols, enabled_protocols, protocol_info, device_info,
settings (ref src/http_server.c:52-80).

The verbs that write receiver state wait for the block in flight: the
retune setters take the receiver's lock themselves, and the
``protocol``, ``convert`` and ``report_meta`` verbs take it here
(``RtlTpu.retuning``; ``push_block`` holds ``RtlTpu.lock``). Two replies name this package
where the JAX package's name theirs: the index page's title, and
``device_info`` (the receiver's device type and ``"backend": "torch"``).
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .data_model import Event, event_to_jsons

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

_INDEX_PAGE = b"""<!DOCTYPE html><html><head><title>rtl_433_tpu_torch</title></head>
<body><h1>rtl_433_tpu_torch</h1>
<p>Endpoints: <a href="/events">/events</a>, <a href="/stream">/stream</a>,
/ws, /cmd, /jsonrpc, <a href="/metrics">/metrics</a></p></body></html>"""


class HttpServerSink:
    """Event sink + control plane. Call `.close()` to stop."""

    def __init__(self, receiver=None, host="0.0.0.0", port=8433,
                 history=100):
        self.receiver = receiver
        # the HTTP API consumes all log levels (ref add_http_output,
        # src/r_api.c:1043 note)
        self.log_level = 8
        self.history = deque(maxlen=history)
        self.streams = []       # live chunked/ws client queues
        self.lock = threading.Lock()
        self.stats = {"events": 0, "started": time.time()}
        sink = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _INDEX_PAGE
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path in ("/events", "/stream"):
                    self._stream(chunked=url.path == "/events")
                elif url.path == "/ws":
                    self._websocket()
                elif url.path == "/metrics":
                    self._metrics()
                elif url.path == "/cmd":
                    q = parse_qs(url.query)
                    cmd = q.get("cmd", [""])[0]
                    val = q.get("val", [None])[0]
                    self._json(sink.handle_cmd(cmd, val))
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode() if n else "{}"
                url = urlparse(self.path)
                try:
                    req = json.loads(body)
                except ValueError:
                    self.send_error(400)
                    return
                if url.path == "/cmd":
                    self._json(sink.handle_cmd(req.get("cmd", ""),
                                               req.get("val")))
                elif url.path == "/jsonrpc":
                    resp = {"jsonrpc": "2.0", "id": req.get("id")}
                    try:
                        params = req.get("params")
                        if isinstance(params, dict):
                            params = params.get("val")
                        elif isinstance(params, list):
                            params = params[0] if params else None
                        resp["result"] = sink.handle_cmd(
                            req.get("method", ""), params)
                    except Exception as e:
                        resp["error"] = {"code": -32600, "message": str(e)}
                    self._json(resp)
                else:
                    self.send_error(404)

            # -- helpers ----------------------------------------------------
            def _json(self, obj):
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _metrics(self):
                body = sink.openmetrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/openmetrics-text")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, chunked):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                if chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                else:
                    self.send_header("Connection", "close")
                self.end_headers()
                q = deque()
                cond = threading.Condition()
                with sink.lock:
                    for ev in sink.history:
                        q.append(ev)
                    sink.streams.append((q, cond))
                try:
                    while True:
                        with cond:
                            if not q:
                                # 60 s keep-alive CRLF (ref :60)
                                if not cond.wait(timeout=60):
                                    self._write_line("", chunked)
                                    continue
                        while q:
                            line = q.popleft()
                            self._write_line(line, chunked)
                except OSError:
                    pass
                finally:
                    with sink.lock:
                        sink.streams.remove((q, cond))

            def _write_line(self, line, chunked):
                data = (line + "\r\n").encode()
                if chunked:
                    self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                else:
                    self.wfile.write(data)
                self.wfile.flush()

            def _websocket(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if not key:
                    self.send_error(400)
                    return
                accept = base64.b64encode(hashlib.sha1(
                    (key + _WS_MAGIC).encode()).digest()).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()
                conn = self.connection
                q = deque()
                cond = threading.Condition()
                with sink.lock:
                    for ev in sink.history:   # history replay (ref :1125)
                        q.append(ev)
                    sink.streams.append((q, cond))
                try:
                    conn.settimeout(1.0)
                    while True:
                        while q:
                            _ws_send(conn, q.popleft())
                        with cond:
                            cond.wait(timeout=1.0)
                        # drain any client frames (ping/close)
                        try:
                            op = _ws_recv_opcode(conn)
                            if op == 8:
                                break
                        except socket.timeout:
                            pass
                except OSError:
                    pass
                finally:
                    with sink.lock:
                        sink.streams.remove((q, cond))

        self.server = ThreadingHTTPServer((host, int(port)), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    # -- event sink ---------------------------------------------------------

    def __call__(self, ev: Event):
        line = event_to_jsons(ev)
        with self.lock:
            self.stats["events"] += 1
            self.history.append(line)
            for q, cond in self.streams:
                q.append(line)
                with cond:
                    cond.notify()

    # -- control verbs (ref src/http_server.c:52-80) --------------------------

    def handle_cmd(self, cmd, val):
        rx = self.receiver
        if cmd == "center_frequency":
            if val is not None and rx:
                rx.set_frequency(float(val))
            return {"center_frequency": rx.center_frequency if rx else None}
        if cmd == "sample_rate":
            if val is not None and rx:
                rx.set_sample_rate(int(val))
            return {"sample_rate": rx.sample_rate if rx else None}
        if cmd == "gain":
            # "" / "auto" = tuner AGC; reaches the live rtl_tcp tuner
            # (ref set_gain_str, src/r_api.c:101-115)
            if rx and val is not None:
                rx.set_gain(val)
            return {"gain": rx.gain_db if rx else None}
        if cmd == "ppm_error":
            if rx and val is not None:
                rx.set_ppm_error(int(val))
            return {"ppm_error": rx.ppm_error if rx else None}
        if cmd == "hop_interval":
            if rx and val is not None:
                rx.set_hop_interval(int(val))
            return {"hop_interval": getattr(rx, "_hop_times", None)
                    if rx else None}
        if cmd == "protocol":
            if rx and val is not None:
                n = int(val)
                with rx.retuning():
                    if n >= 0:
                        rx.registry.register(n)
                    else:
                        rx.registry.unregister(-n)
            return {"protocol": val}
        if cmd == "convert":
            if rx and val:
                with rx.retuning():
                    rx.convert = str(val)
            return {"convert": rx.convert if rx else None}
        if cmd == "report_meta":
            if rx and val is not None:
                with rx.retuning():
                    rx.report_meta = bool(val)
            return {"report_meta": rx.report_meta if rx else None}
        if cmd == "registered_protocols":
            return [{"num": d.num, "name": d.name}
                    for d in (rx.registry.active if rx else [])]
        if cmd == "enabled_protocols":
            return [d.num for d in (rx.registry.active if rx else [])]
        if cmd == "protocol_info":
            devs = rx.registry.active if rx else []
            return [{"num": d.num, "name": d.name,
                     "modulation": d.modulation,
                     "fields": d.fields} for d in devs]
        if cmd == "device_info":
            return {"driver": rx.device.type if rx else None,
                    "backend": "torch"}
        if cmd == "settings":
            return {
                "frequency": rx.center_frequency if rx else None,
                "sample_rate": rx.sample_rate if rx else None,
                "convert": rx.convert if rx else None,
                "gain": rx.gain_db if rx else None,
                "ppm_error": rx.ppm_error if rx else None,
                "hop_interval": (getattr(rx, "_hop_times", None) or [None])[0]
                if rx else None,
            }
        raise ValueError(f"unknown cmd: {cmd}")

    def openmetrics(self) -> str:
        """OpenMetrics report (ref src/http_server.c:780)."""
        up = time.time() - self.stats["started"]
        lines = [
            "# TYPE rtl433_events counter",
            f"rtl433_events_total {self.stats['events']}",
            "# TYPE rtl433_uptime gauge",
            f"rtl433_uptime_seconds {up:.0f}",
        ]
        if self.receiver:
            lines += [
                "# TYPE rtl433_frequency gauge",
                f"rtl433_frequency_hz {self.receiver.center_frequency:.0f}",
                "# TYPE rtl433_sample_rate gauge",
                f"rtl433_sample_rate_hz {self.receiver.sample_rate}",
            ]
        return "\n".join(lines) + "\n# EOF\n"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _ws_send(conn, text: str):
    data = text.encode()
    n = len(data)
    if n < 126:
        hdr = bytes([0x81, n])
    elif n < 65536:
        hdr = bytes([0x81, 126]) + struct.pack(">H", n)
    else:
        hdr = bytes([0x81, 127]) + struct.pack(">Q", n)
    conn.sendall(hdr + data)


def _ws_recv_opcode(conn):
    b0 = conn.recv(1)
    if not b0:
        return 8
    op = b0[0] & 0x0F
    b1 = conn.recv(1)[0]
    n = b1 & 0x7F
    masked = b1 & 0x80
    if n == 126:
        n = struct.unpack(">H", conn.recv(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", conn.recv(8))[0]
    if masked:
        conn.recv(4)
    while n > 0:
        got = conn.recv(min(n, 4096))
        if not got:
            break
        n -= len(got)
    return op

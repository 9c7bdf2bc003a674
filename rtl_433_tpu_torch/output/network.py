"""Network output sinks: syslog UDP, trigger, MQTT, InfluxDB.

Host-side services reproducing the reference sink wire contracts
(ref src/output_udp.c, src/output_trigger.c, src/output_mqtt.c,
src/output_influx.c) with zero external dependencies — the MQTT client
speaks MQTT 3.1.1 over a raw socket.
"""

from __future__ import annotations

import re
import socket
import struct
import threading
import time
import urllib.request
from typing import Optional

from .data_model import Event, event_to_jsons


class SyslogSink:
    """RFC 5424 JSON datagrams (ref src/output_udp.c:157-196)."""

    def __init__(self, host: str = "localhost", port: int = 514,
                 pri: int = 165, log_level: int = 4):
        self.addr = (host, int(port))
        # default LOG_WARNING: warnings+errors ship as syslog datagrams
        # (ref add_syslog_output, src/r_api.c:1029)
        self.log_level = int(log_level)
        self.pri = pri
        self.hostname = socket.gethostname().split(".")[0]
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def __call__(self, ev: Event):
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        msg = "<%d>1 %s %s rtl_433 - - - %s" % (
            self.pri, ts, self.hostname, event_to_jsons(ev))
        if len(msg) < 1024:
            try:
                self.sock.sendto(msg.encode(), self.addr)
            except OSError:
                pass


class TriggerSink:
    """Writes "1" per event, e.g. to a GPIO value file
    (ref src/output_trigger.c)."""

    def __init__(self, path: str):
        self.file = open(path, "w") if isinstance(path, str) else path

    def __call__(self, ev: Event):
        self.file.write("1")
        self.file.flush()


# ---------------------------------------------------------------------------
# MQTT 3.1.1 client (raw socket)

class MqttClient:
    """Minimal MQTT 3.1.1 publisher with keepalive, last-will and QoS 0/1."""

    def __init__(self, host="localhost", port=1883, client_id="rtl_433",
                 user=None, password=None, will_topic=None,
                 will_payload=b"offline", keepalive=60, tls=False,
                 tls_ca_cert=None, tls_cert=None, tls_key=None,
                 tls_insecure=False):
        self.host, self.port = host, int(port)
        self.client_id = client_id
        self.user, self.password = user, password
        self.will_topic = will_topic
        self.will_payload = will_payload
        self.keepalive = keepalive
        self.tls = tls or bool(tls_ca_cert or tls_cert)
        self.tls_ca_cert = tls_ca_cert
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.tls_insecure = tls_insecure
        self.sock: Optional[socket.socket] = None
        self._mid = 0
        self._lock = threading.Lock()

    @staticmethod
    def _encode_len(n: int) -> bytes:
        out = b""
        while True:
            d, n = n % 128, n // 128
            out += bytes([d | (0x80 if n else 0)])
            if not n:
                return out

    @staticmethod
    def _str(s) -> bytes:
        b = s.encode() if isinstance(s, str) else s
        return struct.pack(">H", len(b)) + b

    def connect(self):
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=5)
        if self.tls:
            # mqtts / tls_* options (ref src/output_mqtt.c:160-161 tls opts)
            import ssl
            ctx = ssl.create_default_context(cafile=self.tls_ca_cert)
            if self.tls_cert:
                ctx.load_cert_chain(self.tls_cert, self.tls_key)
            if self.tls_insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock,
                                        server_hostname=self.host)
        flags = 0x02  # clean session
        payload = self._str(self.client_id)
        if self.will_topic:
            flags |= 0x04 | 0x20  # will + will retain
            payload += self._str(self.will_topic)
            payload += self._str(self.will_payload)
        if self.user:
            flags |= 0x80
            payload += self._str(self.user)
            if self.password is not None:
                flags |= 0x40
                payload += self._str(self.password)
        var = self._str("MQTT") + bytes([4, flags]) + \
            struct.pack(">H", self.keepalive)
        pkt = bytes([0x10]) + self._encode_len(len(var) + len(payload)) + \
            var + payload
        self.sock.sendall(pkt)
        resp = self.sock.recv(4)
        if len(resp) < 4 or resp[0] != 0x20 or resp[3] != 0:
            raise ConnectionError(f"MQTT CONNACK failed: {resp!r}")

    def publish(self, topic: str, payload, qos: int = 0,
                retain: bool = False):
        with self._lock:
            if self.sock is None:
                try:
                    self.connect()
                except OSError:
                    return
            body = self._str(topic)
            if qos:
                self._mid = (self._mid % 0xFFFF) + 1
                body += struct.pack(">H", self._mid)
            data = payload.encode() if isinstance(payload, str) else payload
            body += data
            hdr = 0x30 | (qos << 1) | (1 if retain else 0)
            pkt = bytes([hdr]) + self._encode_len(len(body)) + body
            try:
                self.sock.sendall(pkt)
                if qos:
                    self.sock.settimeout(2)
                    self.sock.recv(4)  # PUBACK
            except OSError:
                try:
                    self.sock.close()
                finally:
                    self.sock = None

    def close(self):
        if self.sock:
            try:
                self.sock.sendall(bytes([0xE0, 0]))  # DISCONNECT
                self.sock.close()
            except OSError:
                pass
            self.sock = None


def _sanitize_topic(s: str) -> str:
    """[-.A-Za-z0-9] only (ref src/output_mqtt.c:450-457)."""
    return re.sub(r"[^-.A-Za-z0-9]", "_", s)


def expand_topic(fmt: str, ev: Event, hostname: str) -> str:
    """Expand [/key] and [/key:default] tokens (ref src/string_expand.c)."""
    out = []
    i = 0
    d = ev.to_dict()
    d.setdefault("hostname", hostname)
    while i < len(fmt):
        c = fmt[i]
        if c == "[":
            j = fmt.index("]", i)
            tok = fmt[i + 1:j]
            i = j + 1
            prefix = ""
            while tok and tok[0] in "/-_":
                prefix += tok[0]
                tok = tok[1:]
            default = None
            if ":" in tok:
                tok, default = tok.split(":", 1)
            val = d.get(tok, default)
            if val is not None:
                out.append(prefix + _sanitize_topic(str(val)))
        else:
            out.append(c)
            i += 1
    return "".join(out)


class MqttSink:
    """MQTT event fan-out with events/states/devices/availability topic
    schemes (ref src/output_mqtt.c:460-660, help src/rtl_433.c:264-280)."""

    def __init__(self, host="localhost", port=1883, user=None, password=None,
                 retain=False, qos=0, base=None, events=None, devices=None,
                 states=None, availability=None, client=None, tls=False,
                 tls_ca_cert=None, tls_cert=None, tls_key=None,
                 tls_insecure=False):
        self.hostname = socket.gethostname().split(".")[0]
        base = base or f"rtl_433/{self.hostname}"
        self.events = events if events is not None else base + "/events"
        self.devices = devices
        self.states = states
        self.availability = availability if availability is not None \
            else base + "/availability"
        self.retain = retain
        self.qos = qos
        self.client = client or MqttClient(
            host, port, client_id=f"rtl_433-{self.hostname}",
            user=user, password=password, will_topic=self.availability,
            tls=tls, tls_ca_cert=tls_ca_cert, tls_cert=tls_cert,
            tls_key=tls_key, tls_insecure=tls_insecure)
        try:
            self.client.connect()
            if self.availability:
                self.client.publish(self.availability, b"online",
                                    retain=True)
        except OSError:
            pass

    def __call__(self, ev: Event):
        if "model" not in ev:
            if self.states:
                topic = expand_topic(self.states, ev, self.hostname)
                self.client.publish(topic, event_to_jsons(ev),
                                    self.qos, self.retain)
            return
        if self.events:
            topic = expand_topic(self.events, ev, self.hostname)
            self.client.publish(topic, event_to_jsons(ev),
                                self.qos, self.retain)
        if self.devices:
            base = expand_topic(self.devices, ev, self.hostname)
            for f in ev.fields:
                if f.key in ("type", "model", "subtype"):
                    continue
                self.client.publish(f"{base}/{f.key}", str(f.value),
                                    self.qos, self.retain)

    def close(self):
        if self.availability:
            self.client.publish(self.availability, b"offline", retain=True)
        self.client.close()


class InfluxSink:
    """InfluxDB line-protocol over HTTP v1/v2 (ref src/output_influx.c)."""

    def __init__(self, url="http://localhost:8086/api/v2/write?bucket=rtl_433",
                 token=None, measurement_key="model"):
        self.url = url
        self.token = token
        self.measurement_key = measurement_key

    @staticmethod
    def _escape(s, chars=", ="):
        for ch in chars:
            s = s.replace(ch, "\\" + ch)
        return s

    def line(self, ev: Event) -> str:
        d = ev.to_dict()
        meas = self._escape(str(d.get(self.measurement_key, "rtl_433")))
        tags = []
        for k in ("id", "channel", "subtype", "type"):
            if k in d:
                tags.append(f"{self._escape(k)}={self._escape(str(d[k]))}")
        fields = []
        for f in ev.fields:
            if f.key in (self.measurement_key, "time", "id", "channel",
                         "subtype", "type"):
                continue
            v = f.value
            if isinstance(v, bool):
                fields.append(f"{self._escape(f.key)}={'t' if v else 'f'}")
            elif isinstance(v, int):
                fields.append(f"{self._escape(f.key)}={v}i")
            elif isinstance(v, float):
                fields.append(f"{self._escape(f.key)}={v}")
            else:
                s = str(v).replace('"', '\\"')
                fields.append(f'{self._escape(f.key)}="{s}"')
        if not fields:
            fields = ["event=1i"]
        head = meas + ("," + ",".join(tags) if tags else "")
        return f"{head} {','.join(fields)}"

    def __call__(self, ev: Event):
        req = urllib.request.Request(self.url, data=self.line(ev).encode(),
                                     method="POST")
        if self.token:
            req.add_header("Authorization", f"Token {self.token}")
        try:
            urllib.request.urlopen(req, timeout=2).read()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# data tags (-K)

class LineTagClient:
    """Background TCP line reader keeping the latest (filtered) line —
    the gpsd / generic-TCP live tag source (ref src/data_tag.c:26-160).
    Reconnects on close, like the reference's mongoose client."""

    GPSD_WATCH_JSON = b'?WATCH={"enable":true,"json":true}\n'
    GPSD_FILTER_JSON = '{"class":"TPV",'
    GPSD_WATCH_NMEA = b'?WATCH={"enable":true,"nmea":true}\n'
    GPSD_FILTER_NMEA = "$GPGGA,"

    def __init__(self, host, port, init_bytes=None, filter_prefix=None):
        self.host, self.port = host, int(port)
        self.init_bytes = init_bytes
        self.filter_prefix = filter_prefix
        self.msg = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                sock = socket.create_connection((self.host, self.port),
                                                timeout=5)
                if self.init_bytes:
                    sock.sendall(self.init_bytes)
                sock.settimeout(1)
                buf = b""
                while not self._stop.is_set():
                    try:
                        chunk = sock.recv(4096)
                    except socket.timeout:
                        continue
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        text = line.rstrip(b"\r").decode("utf-8", "replace")
                        if (not self.filter_prefix
                                or text.startswith(self.filter_prefix)):
                            self.msg = text
                try:
                    sock.close()
                except OSError:
                    pass
            except OSError:
                pass
            self._stop.wait(1.0)

    def close(self):
        self._stop.set()


class DataTagger:
    """-K tags: static key=value, FILE/PATH expansion, and live gpsd /
    generic-TCP tag clients (ref src/data_tag.c:180-336).

    Spec grammar (matching the reference): ``[key=]gpsd[:host[:port]]``
    or ``[key=]tcp:host:port`` with options ``,nmea``, ``,init=<str>``,
    ``,filter=<prefix>`` and bare words as JSON include keys; otherwise
    static ``key=value`` / ``FILE`` / ``PATH`` / bare tag values.
    """

    def __init__(self, spec: str, current_file_fn=None):
        self.current_file_fn = current_file_fn or (lambda: None)
        self.pairs = []       # static key=value
        self.special = None   # "FILE" | "PATH"
        self.client = None
        self.key = None
        self.includes = []

        body = spec
        if "=" in spec.split(",", 1)[0]:
            head = spec.split(",", 1)[0]
            k, v = head.split("=", 1)
            if v.startswith(("gpsd", "tcp:")):
                self.key = k
                body = spec[len(k) + 1:]
        if body.startswith(("gpsd", "tcp:")):
            parts = body.split(",")
            target = parts[0]
            gpsd_mode = target.startswith("gpsd")
            hostport = target.split(":", 1)[1] if ":" in target else ""
            host = "localhost" if gpsd_mode else None
            port = 2947 if gpsd_mode else None
            if hostport:
                h, _, p = hostport.partition(":")
                host = h or host
                if p:
                    port = int(p)
            init = LineTagClient.GPSD_WATCH_JSON if gpsd_mode else None
            filt = LineTagClient.GPSD_FILTER_JSON if gpsd_mode else None
            for opt in parts[1:]:
                if opt.lower() == "nmea":
                    init = LineTagClient.GPSD_WATCH_NMEA
                    filt = LineTagClient.GPSD_FILTER_NMEA
                elif opt.startswith("init="):
                    init = opt[5:].encode()
                elif opt.startswith("filter="):
                    filt = opt[7:]
                elif opt:
                    self.includes.append(opt)
            if self.key is None and not self.includes:
                self.key = "gps" if gpsd_mode else "tag"
            if host is None or port is None:
                raise ValueError("host or port for tag client missing")
            self.client = LineTagClient(host, port, init, filt)
            return
        for part in spec.split(","):
            if part in ("FILE", "PATH"):
                self.special = part
            elif "=" in part:
                k, v = part.split("=", 1)
                self.pairs.append((k, v))
            elif part:
                self.pairs.append(("tag", part))

    def __call__(self, ev: Event) -> Event:
        import json as _json
        import os
        if self.client is not None:
            msg = self.client.msg
            if self.includes:
                picked = []
                try:
                    obj = _json.loads(msg) if msg else {}
                except ValueError:
                    obj = {}
                for k in self.includes:
                    if k in obj:
                        picked.append((k, obj[k]))
                if self.key:
                    ev.append((self.key, Event.make(*picked)))
                else:
                    ev.append(*picked)
            else:
                ev.append((self.key, msg))
            return ev
        items = []
        if self.special:
            path = self.current_file_fn()
            if path:
                val = os.path.basename(path) if self.special == "FILE" \
                    else path
                items.append((self.special.lower(), val))
        items += self.pairs
        ev.prepend(*items)
        return ev

    def close(self):
        if self.client is not None:
            self.client.close()

"""Loopback rtl_tcp servers and clients for the live-input cases of the
port's CPU tests and chip_smoke.py's ``live`` phase.

``LoopbackRtlTcp`` serves the rtl_tcp header, records the 5-byte commands
it receives and streams given CU8 blocks, as fast as loopback carries them
or paced to a wall-clock schedule at ``rate`` samples a second, after an
optional gate opens, with an optional pause between two blocks; then it
closes its side. ``Passthrough`` reads every
byte an ``-F rtltcp`` server sends. ``stream_blocks`` cuts samples into
whole blocks, padded with 128s, plus one quiet block that closes any
package still open (live input never flushes). ``dump_argv`` asks the CLI
for every ``-w`` format into one directory and ``read_dumps`` reads them
back; ``fixed_localtime`` pins the one clock the dumps read outside the
API module (the ``.vcd`` header's ``$date``). Imports neither torch nor
jax.
"""

import contextlib
import os
import socket
import struct
import threading
import time
import zipfile

import numpy as np

BLOCK = 131072
HEADER = b"RTL0" + struct.pack(">II", 5, 29)


# every -w format: the sample dumps (ref src/r_flow.c:386-489), the U8
# logic channel and the per-package .ook and .vcd text
DUMP_FORMATS = ("cu8", "cs8", "cs16", "cf32", "am.s16", "fm.s16", "am.f32",
                "fm.f32", "logic", "ook", "vcd")


def dump_argv(outdir):
    """``-w`` options writing every format of :data:`DUMP_FORMATS` into
    ``outdir`` (``dump.<format>``)."""
    argv = []
    for fmt in DUMP_FORMATS:
        path = os.path.join(outdir, f"dump.{fmt}")
        argv += ["-w", "U8:LOGIC:" + path if fmt == "logic" else path]
    return argv


def read_dumps(outdir):
    """{file name: bytes} of every file in ``outdir``; a ``.sr`` session as
    {member: bytes} (the zip's own bytes hold the files' times)."""
    out = {}
    for name in sorted(os.listdir(outdir)):
        path = os.path.join(outdir, name)
        if name.endswith(".sr"):
            with zipfile.ZipFile(path) as z:
                out[name] = {n: z.read(n) for n in z.namelist()}
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


@contextlib.contextmanager
def fixed_localtime(stamp=1760000000.0):
    """``time.localtime()`` with no argument reads ``stamp``."""
    real = time.localtime
    time.localtime = lambda t=None: real(stamp if t is None else t)
    try:
        yield
    finally:
        time.localtime = real


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stream_blocks(iq, block=BLOCK, quiet=1):
    """CU8 [N, 2] -> whole [block, 2] blocks, the last one padded with 128,
    then ``quiet`` blocks of 128."""
    iq = np.asarray(iq, np.uint8)
    n = -(-iq.shape[0] // block) * block + quiet * block
    out = np.full((n, 2), 128, np.uint8)
    out[:iq.shape[0]] = iq
    return [out[i:i + block] for i in range(0, n, block)]


class LoopbackRtlTcp(threading.Thread):
    """An rtl_tcp server on 127.0.0.1 for one client.

    ``rate``: samples a second, each block sent at its slot of a
    wall-clock schedule (None: as fast as the socket takes them).
    ``gate``: a ``threading.Event`` the server waits on before the first
    block. ``pause``: ``(k, event)``: after its ``k``-th block the server
    waits on ``event`` before the next (the pacing schedule restarts
    there). ``hold``: a stall: after the blocks of its ``k``-th client
    (from 1) the server keeps the connection open and silent until
    ``hold(k)`` is true, then closes it. ``accepts``: clients served one
    after another, each sent the blocks; the listening socket closes once
    the last is accepted, so a further connect is refused."""

    def __init__(self, blocks, rate=None, gate=None, hold=None, accepts=1,
                 pause=None):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(2)
        self.port = self.sock.getsockname()[1]
        self.blocks = [np.ascontiguousarray(b, np.uint8).tobytes()
                       for b in blocks]
        self.rate = rate
        self.gate = gate
        self.hold = hold
        self.pause = pause
        self.accepts = accepts
        self.commands = []
        self.n_connects = 0
        self._conns = []

    @property
    def device(self) -> str:
        return f"rtl_tcp:127.0.0.1:{self.port}"

    def _drain(self, conn):
        try:
            while True:
                buf = b""
                while len(buf) < 5:
                    chunk = conn.recv(5 - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                self.commands.append(struct.unpack(">BI", buf))
        except OSError:
            pass

    def _serve(self, conn):
        conn.sendall(HEADER)
        drainer = threading.Thread(target=self._drain, args=(conn,),
                                   daemon=True)
        drainer.start()
        if self.gate is not None:
            self.gate.wait(60)
        t_next = time.monotonic()
        for i, raw in enumerate(self.blocks):
            if self.pause is not None and i == self.pause[0]:
                self.pause[1].wait(60)
                t_next = time.monotonic()
            if self.rate:
                delay = t_next - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                t_next += len(raw) // 2 / self.rate
            conn.sendall(raw)
        if self.hold is not None:
            t_end = time.monotonic() + 60
            while not self.hold(self.n_connects) \
                    and time.monotonic() < t_end:
                time.sleep(0.005)
        conn.shutdown(socket.SHUT_WR)
        drainer.join(timeout=30)

    def run(self):
        try:
            for k in range(self.accepts):
                conn, _ = self.sock.accept()
                self.n_connects += 1
                self._conns.append(conn)
                if k == self.accepts - 1:
                    self.sock.close()
                try:
                    self._serve(conn)
                except OSError:
                    pass
        except OSError:
            pass
        finally:
            self.close()

    def close(self):
        """Stop serving: close every socket."""
        for s in [self.sock, *self._conns]:
            try:
                s.close()
            except OSError:
                pass


class Passthrough(threading.Thread):
    """Reads every byte an rtl_tcp server on 127.0.0.1:``port`` sends,
    connecting as soon as it listens; ``connected`` is set once the header
    has arrived. Set ``done`` once the server has sent all: the reader then
    ends when no byte comes for 0.2 s (``RtlTcpServer.close`` closes its
    connections under a thread blocked in ``recv`` on them, so no end of
    stream reaches the client until the process exits)."""

    def __init__(self, port, timeout=60):
        super().__init__(daemon=True)
        self.port = port
        self.timeout = timeout
        self.connected = threading.Event()
        self.done = threading.Event()
        self.data = b""

    def run(self):
        t_end = time.monotonic() + self.timeout
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", self.port),
                                                timeout=self.timeout)
                break
            except OSError:
                if time.monotonic() > t_end:
                    return
                time.sleep(0.01)
        chunks = []
        with sock:
            head = b""
            while len(head) < len(HEADER):
                chunk = sock.recv(len(HEADER) - len(head))
                if not chunk:
                    break
                head += chunk
            chunks.append(head)
            # the server lists a client just after its header is sent
            time.sleep(0.1)
            self.connected.set()
            sock.settimeout(0.2)
            while True:
                try:
                    chunk = sock.recv(1 << 16)
                except socket.timeout:
                    if self.done.is_set():
                        break
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                chunks.append(chunk)
        self.data = b"".join(chunks)

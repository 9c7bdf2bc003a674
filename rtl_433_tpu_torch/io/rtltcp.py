"""rtl_tcp wire protocol: client ingest and passthrough server.

Wire contract (ref src/sdr.c:133-357 client, src/output_rtltcp.c server,
documented minimally in tests/rtl_tcp_serve.py of the reference):
- server -> client: 12-byte header ``b"RTL0" + u32be tuner_type +
  u32be gain_count`` then a raw CU8 IQ stream
- client -> server: 5-byte commands ``u8 cmd + u32be param``
  (0x01 freq, 0x02 rate, 0x04 gain, 0x05 ppm, ...)
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional

import numpy as np

CMD_FREQ = 0x01
CMD_RATE = 0x02
CMD_GAIN_MODE = 0x03
CMD_GAIN = 0x04
CMD_PPM = 0x05
CMD_AGC = 0x08


class RtlTcpClient:
    """Client for an rtl_tcp server; feeds CU8 blocks to a callback
    (the analogue of sdr_open("rtl_tcp:...") + acquire_thread,
    ref src/sdr.c:133-357, :1718-1765)."""

    def __init__(self, host: str = "localhost", port: int = 1234,
                 block_samples: int = 131072):
        self.host, self.port = host, int(port)
        self.block_samples = block_samples
        self.sock: Optional[socket.socket] = None
        self.tuner_type = 0
        self.gain_count = 0
        self._stop = threading.Event()

    def connect(self):
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=10)
        hdr = self._recv_exact(12)
        if hdr[:4] != b"RTL0":
            raise ConnectionError(f"not an rtl_tcp server: {hdr[:4]!r}")
        self.tuner_type, self.gain_count = struct.unpack(">II", hdr[4:])

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp connection closed")
            buf += chunk
        return buf

    def _cmd(self, cmd: int, param: int):
        # a negative param (a -p ppm below zero) goes out as its 32-bit
        # two's complement, as librtlsdr's rtl_tcp client sends it
        self.sock.sendall(struct.pack(">BI", cmd, int(param) & 0xFFFFFFFF))

    def set_center_freq(self, hz):
        self._cmd(CMD_FREQ, hz)

    def set_sample_rate(self, rate):
        self._cmd(CMD_RATE, rate)

    def set_gain_mode(self, manual: int):
        self._cmd(CMD_GAIN_MODE, manual)

    def set_gain(self, tenth_db):
        # librtlsdr ignores SET_GAIN unless the tuner is in manual gain
        # mode first (ref src/sdr.c:1334-1335)
        self.set_gain_mode(1)
        self._cmd(CMD_GAIN, tenth_db)

    def set_freq_correction(self, ppm):
        self._cmd(CMD_PPM, ppm)

    def stop(self):
        self._stop.set()

    def run(self, on_block: Callable[[np.ndarray], None],
            max_blocks: Optional[int] = None):
        """Stream CU8 blocks [N, 2] to ``on_block`` until EOF/stop.

        A producer thread receives from the socket into the SPSC block
        ring (csrc/ingest.cpp, io/native.py) of 15 blocks while this
        thread consumes — network ingest overlaps compute, like the
        reference's acquire thread + 15 async buffers
        (ref src/sdr.c:1718-1765, include/sdr.h:17-18). Blocks dropped on
        ring overflow are counted in ``self.blocks_dropped``.
        """
        nbytes = self.block_samples * 2
        blocks = 0
        self.sock.settimeout(5)
        self.blocks_dropped = 0
        from .native import BlockRing
        ring = BlockRing(nbytes, 15)
        eof = threading.Event()

        def producer():
            while not self._stop.is_set():
                try:
                    raw = self._recv_exact(nbytes)
                except (ConnectionError, socket.timeout, OSError):
                    break
                # drops are counted once, inside the ring (ring_push);
                # summed in the finally block
                ring.push(np.frombuffer(raw, dtype=np.uint8))
            eof.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while not self._stop.is_set():
                blk = ring.pop()
                if blk is None:
                    if eof.is_set() and ring.fill == 0:
                        break
                    eof.wait(0.002)
                    continue
                on_block(blk.reshape(-1, 2))
                blocks += 1
                if max_blocks is not None and blocks >= max_blocks:
                    break
        finally:
            self._stop.set()
            t.join(timeout=5)
            self.blocks_dropped += ring.dropped
            try:
                self.sock.close()
            except OSError:
                pass


class RtlTcpServer:
    """rtl_tcp passthrough server: re-serves the raw IQ stream while
    decoding (ref src/output_rtltcp.c:519)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 6778,
                 tuner_type: int = 5, gain_count: int = 29):
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, int(port)))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.header = b"RTL0" + struct.pack(">II", tuner_type, gain_count)
        self.clients = []
        self.lock = threading.Lock()
        self.on_command: Optional[Callable[[int, int], None]] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                break
            try:
                conn.sendall(self.header)
            except OSError:
                continue
            with self.lock:
                self.clients.append(conn)
            threading.Thread(target=self._cmd_loop, args=(conn,),
                             daemon=True).start()

    def _cmd_loop(self, conn):
        """Drain 5-byte client commands."""
        try:
            while not self._stop.is_set():
                buf = b""
                while len(buf) < 5:
                    chunk = conn.recv(5 - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                cmd, param = struct.unpack(">BI", buf)
                if self.on_command:
                    self.on_command(cmd, param)
        except OSError:
            pass
        finally:
            with self.lock:
                if conn in self.clients:
                    self.clients.remove(conn)

    def broadcast(self, iq: np.ndarray):
        """Send a CU8 block [N, 2] to all connected clients."""
        data = np.ascontiguousarray(iq, dtype=np.uint8).tobytes()
        with self.lock:
            clients = list(self.clients)
        for c in clients:
            try:
                c.sendall(data)
            except OSError:
                with self.lock:
                    if c in self.clients:
                        self.clients.remove(c)

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        with self.lock:
            for c in self.clients:
                try:
                    c.close()
                except OSError:
                    pass
            self.clients.clear()

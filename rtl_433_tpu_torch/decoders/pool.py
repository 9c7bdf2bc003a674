"""Host decode fan-out: a worker-process pool behind the dispatch.

The GPU engine detects pulses for thousands of channels per block; the
Python decode stage is single-threaded per process and becomes the wall
once the package rate exceeds one core's dispatch throughput (the
reference splits acquire/decode across two threads, ref src/sdr.c:1718 —
this is the many-core generalisation).

Design:

- **Package-granular, channel-affine**: each package is routed to
  ``worker = channel % n_workers``.  Stateful decoders (secplus rolling
  codes, ikea_sparsnas history — decoders/base.py STATEFUL_DECODERS)
  carry cross-package state; channel affinity keeps every channel's
  package sequence on one worker in order, so their semantics are
  preserved exactly for per-channel streams (the same guarantee the
  sharded engines provide).
- **Order-preserving**: results are re-assembled in submission order
  before delivery, so event order equals the single-threaded dispatch
  order regardless of worker scheduling.
- Workers hold their own Registry (same ``-R`` set as the parent) and
  per-worker decode/train caches; events travel back as picklable field
  lists and are re-attached to the parent's RDevice objects for the
  event callback.

On a single-core host the pool adds IPC overhead without parallel gain —
it exists for many-core deployment; ``n_workers=0`` (default in the CLI)
keeps the inline path.

Workers are forked, also from a process that has already used the GPU:
they run host code only (``decoders/``, ``pulse/``, ``bits/``), never a
CUDA call. A worker adds the flex decoders (``-X``) of its parent's specs
through ``flex_create_device``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import List, Optional, Sequence, Tuple

from ..output.data_model import Event


def _worker_main(conn, register_nums, flex_specs):
    """Worker loop: receive package jobs, decode, return event batches."""
    from .base import Registry
    from ..pulse.data import PulseData

    reg = Registry()
    if register_nums is None:
        reg.register_all()
    else:
        for num, arg in register_nums:
            d = reg.register(num)
            if d is not None:
                d.arg = arg
    for spec in flex_specs or ():
        from .flex import flex_create_device
        reg.add_device(flex_create_device(spec))

    while True:
        msg = conn.recv()
        if msg is None:
            conn.send(None)
            break
        (seq, channel, want_fsk, rate, pulse, gap, low, high, f1, f2,
         offset) = msg
        pd = PulseData(pulse=list(pulse), gap=list(gap), sample_rate=rate,
                       offset=offset, ook_low_estimate=low,
                       ook_high_estimate=high, fsk_f1_est=f1, fsk_f2_est=f2)
        out = []

        def cb(dev, ev):
            out.append((dev.num, dev.symbol, list(ev.fields)))

        if want_fsk:
            reg.run_fsk_demods(pd, cb)
        else:
            reg.run_ook_demods(pd, cb)
        conn.send((seq, channel, out))


class DecodePool:
    """Order-preserving, channel-affine decode worker pool."""

    def __init__(self, registry, n_workers: Optional[int] = None,
                 register_nums: Optional[Sequence] = None,
                 flex_specs: Sequence[str] = ()):
        if n_workers is None:
            n_workers = max(1, (os.cpu_count() or 1) - 1)
        self.registry = registry
        self.n_workers = n_workers
        ctx = mp.get_context("spawn" if os.name == "nt" else "fork")
        self._conns = []
        self._procs = []
        for _ in range(n_workers):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(child, register_nums, tuple(flex_specs)),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._seq = 0
        self._inflight = [0] * n_workers  # jobs queued per worker

    def submit(self, channel: int, want_fsk: bool, pulses, offset=0):
        """Queue one package (a PulseData) for decode."""
        w = channel % self.n_workers
        self._conns[w].send((
            self._seq, channel, want_fsk, pulses.sample_rate,
            tuple(pulses.pulse), tuple(pulses.gap),
            pulses.ook_low_estimate, pulses.ook_high_estimate,
            pulses.fsk_f1_est, pulses.fsk_f2_est, pulses.offset))
        self._inflight[w] += 1
        self._seq += 1

    def drain(self) -> List[Tuple[int, int, list]]:
        """Collect all pending results, re-ordered by submission sequence.

        Returns [(channel, dev, events)] where ``dev`` is the parent
        registry's RDevice and ``events`` are fresh Event objects.
        """
        results = []
        for w, conn in enumerate(self._conns):
            for _ in range(self._inflight[w]):
                results.append(conn.recv())
            self._inflight[w] = 0
        results.sort(key=lambda t: t[0])
        out = []
        for _seq, channel, evs in results:
            for num, symbol, fields in evs:
                dev = self.registry.get(num) if num else None
                if dev is None or dev.symbol != symbol:
                    dev = next((d for d in self.registry.active
                                if d.symbol == symbol), dev)
                out.append((channel, dev, Event(fields)))
        return out

    def close(self):
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                continue
        for conn in self._conns:
            try:
                conn.recv()
            except (EOFError, OSError):
                pass
            conn.close()
        for p in self._procs:
            p.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

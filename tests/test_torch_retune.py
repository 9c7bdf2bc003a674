"""The port's retune rule: a retune from another thread waits for the block
in flight and applies from the next block.

``RtlTpu.lock`` (an RLock) is held by ``push_block`` for a whole block and,
through ``RtlTpu.retuning``, by every setter (``set_frequency``,
``set_sample_rate``, ``set_gain``, ``set_ppm_error``, ``set_hop_interval``)
and by the HTTP server's ``protocol``, ``convert`` and ``report_meta``
verbs; a block waits for the retunes already waiting before it takes the
lock. Here a thread calls
every one of them in a loop while ``run_live`` runs on the CPU against a
loopback rtl_tcp server: nothing raises, and every block ran from its
start to its end under one set of parameters (the detector params it was
processed with, the receiver's tuning, registry and output options). The
JAX package takes no lock; its twin of a retune that falls between two
blocks is in tests/test_torch_live.py.
"""

import os
import sys
import threading
import time

import numpy as np

from rtl_433_tpu_torch import api as tapi
from rtl_433_tpu_torch.output.http_server import HttpServerSink

sys.path.insert(0, os.path.dirname(__file__))
from torch_live_cases import BLOCK, LoopbackRtlTcp  # noqa: E402


def _blocks(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(118, 138, size=(BLOCK, 2), dtype=np.uint8)
            for _ in range(n)]


def _snapshot(rx):
    return (rx.sample_rate, rx.center_frequency, rx.fsk_minmax, rx.gain_db,
            rx.ppm_error, tuple(getattr(rx, "_hop_times", ())),
            tuple(d.num for d in rx.registry.active), rx.convert,
            rx.report_meta)


def _instrument(rx, monkeypatch, dwell=0.02):
    """Record, per block, the receiver's settings at its start and end and
    the detector params process_block was given; each process_block
    dwells ``dwell`` s, so that retunes fall inside blocks."""
    blocks, in_block = [], threading.Event()
    real_pb = tapi.process_block

    def pb(params, *a, **k):
        blocks[-1]["params"].append(params)
        in_block.set()
        time.sleep(dwell)
        return real_pb(params, *a, **k)

    monkeypatch.setattr(tapi, "process_block", pb)
    real = rx._push_block

    def inner(iq, flush):
        blocks.append({"start": _snapshot(rx), "params": []})
        out = real(iq, flush)
        blocks[-1].update(end=_snapshot(rx), own=rx._params,
                          t_end=time.monotonic())
        in_block.clear()
        return out

    rx._push_block = inner
    return blocks, in_block


def test_retunes_from_another_thread_never_split_a_block(monkeypatch):
    rx = tapi.RtlTpu(register_all=False, device="cpu")
    for n in (19, 75):
        rx.registry.register(n)
    blocks, _ = _instrument(rx, monkeypatch)
    verbs = HttpServerSink.__new__(HttpServerSink)  # no server socket
    verbs.receiver = rx
    stop, errors, calls = threading.Event(), [], [0]

    def retuner():
        i = 0
        try:
            while not stop.is_set():
                i += 1
                rx.set_frequency((433_920_000, 868_300_000)[i % 2])
                rx.set_sample_rate((250_000, 1_024_000)[(i // 2) % 2])
                rx.set_gain((None, 20.0, "auto", 12.5)[i % 4])
                rx.set_ppm_error(i % 7)
                rx.set_hop_interval(1 + i % 5)
                verbs.handle_cmd("protocol", -75 if i % 2 else 75)
                verbs.handle_cmd("convert", ("si", "native")[i % 2])
                verbs.handle_cmd("report_meta", i % 2)
                calls[0] += 1
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    srv = LoopbackRtlTcp(_blocks(12))
    srv.start()
    t = threading.Thread(target=retuner, daemon=True)
    t.start()
    try:
        rx.run_live(srv.device, block_samples=BLOCK, watchdog_interval=60)
    finally:
        stop.set()
        t.join(30)
        srv.join(30)
    assert not errors, errors
    assert rx.exit_code == 0 and len(blocks) == 12
    assert calls[0] >= len(blocks)
    starts = set()
    for b in blocks:
        # one set of settings from the block's start to its end, and the
        # one detector params it was processed with, built for them
        assert b["start"] == b["end"]
        assert len(b["params"]) == 1 and b["params"][0] is b["own"]
        rate, _freq, minmax = b["start"][:3]
        assert (b["own"].sample_rate, b["own"].fsk_minmax) == (rate, minmax)
        starts.add(b["start"])
    # the retunes did land between blocks
    assert len(starts) > 1


def test_a_retune_waits_for_the_block_in_flight(monkeypatch):
    """set_frequency called while a block is in flight returns after that
    block has ended, and the next block is processed at the new tuning
    (868.3 MHz: the minmax FSK tracker under -Y auto, so the pipeline is
    rebuilt)."""
    rx = tapi.RtlTpu(register_all=False, device="cpu")
    rx.registry.register(75)
    blocks, in_block = _instrument(rx, monkeypatch, dwell=0.2)
    done = []

    def retune():
        in_block.wait(60)
        rx.set_frequency(868_300_000)
        done.append(time.monotonic())

    t = threading.Thread(target=retune, daemon=True)
    t.start()
    srv = LoopbackRtlTcp(_blocks(3))
    srv.start()
    rx.run_live(srv.device, block_samples=BLOCK, watchdog_interval=60)
    t.join(30)
    srv.join(30)
    assert len(blocks) == 3 and done
    assert done[0] >= blocks[0]["t_end"]
    assert blocks[0]["start"][1:3] == (433_920_000.0, False)
    assert [b["start"][1:3] for b in blocks[1:]] == \
        [(868_300_000.0, True)] * 2
    assert blocks[1]["own"] is not blocks[0]["own"]
    assert (0x01, 868_300_000) in srv.commands

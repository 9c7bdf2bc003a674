"""The port's MultiHostEngine across two processes (gloo on loopback).

Two workers (tests/torch_multihost_worker.py, which imports no jax) each
own 4 of tests/multihost_fixture.py's 8 channels on a mesh of 4 CPU
devices. Their events together must equal the port's one-process
ShardedEngine over all 8 channels and the JAX package's ShardedEngine on
its 8-device CPU mesh, and their noise floors must agree with each other
and, within 1e-4 dB (the float32 log10 of XLA's CPU backend), with both.
With a package cap that binds, the processes keep exactly the packages
the global channel-major compaction keeps. The slow-marked weak-scaling
run is the twin of tests/test_multihost.py::test_weak_scaling_efficiency.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from multihost_fixture import make_global_iq

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_workers(tmp_path, cap, nproc=2, reps=0, threads=None):
    """``nproc`` worker processes (package cap ``cap``, ``reps`` timed
    pushes each, ``threads`` intra-op threads each where given); their
    outputs in process order."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"w{nproc}_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
             coordinator, str(nproc), str(pid), str(out), str(cap),
             str(reps)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [json.loads(out.read_text()) for out in outs]


def _port_one_process(cap):
    from rtl_433_tpu_torch.decoders import Registry
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from rtl_433_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
    reg = Registry()
    reg.register_all()
    eng = ShardedEngine(DetectorParams(sample_rate=250_000, pkg_cap=4), 8,
                        make_mesh(8, devices=[torch.device("cpu")] * 8),
                        registry=reg, pkg_cap_total=cap)
    eng.push(make_global_iq())
    events = [(c, event_to_json(ev)) for c, ev in eng.drain_events()]
    return events, float(eng.noise_floor_db), eng.n_pkg_dropped


def _jax_one_process(cap):
    from rtl_433_tpu.decoders import Registry
    from rtl_433_tpu.dsp.engine import DetectorParams
    from rtl_433_tpu.output.data_model import event_to_json
    from rtl_433_tpu.parallel import make_mesh
    from rtl_433_tpu.parallel.sharding import ShardedEngine
    reg = Registry()
    reg.register_all()
    eng = ShardedEngine(DetectorParams(sample_rate=250_000, pkg_cap=4), 8,
                        make_mesh(8), registry=reg, pkg_cap_total=cap)
    eng.push(make_global_iq())
    events = [(c, event_to_json(ev)) for c, ev in eng.drain_events()]
    return events, float(np.asarray(eng.noise_floor_db))


# 64: no cap binds (4 packages, on channels 0, 2, 4, 6); 3: the cut falls
# inside process 1, which keeps 3 - 2 of its 2; 1: process 0 keeps one of
# its 2 and process 1 none
@pytest.mark.parametrize("cap", [64, 3, 1])
def test_two_processes_match_one_process_and_jax(tmp_path, cap):
    res = _two_workers(tmp_path, cap)
    got = [tuple(e) for r in res for e in r["events"]]
    # every process sees the same all-reduced noise floor
    assert res[0]["noise"] == res[1]["noise"]

    want, noise, dropped = _port_one_process(cap)
    assert got == want
    assert abs(res[0]["noise"] - noise) < 1e-4
    assert sum(r["dropped"] for r in res) == dropped
    jwant, jnoise = _jax_one_process(cap)
    assert got == jwant
    assert abs(res[0]["noise"] - jnoise) < 1e-4

    channels = sorted({c for c, _ in got})
    if cap == 64:
        assert channels == [0, 2, 4, 6] and dropped == 0
        assert any("Nexus" in e for _, e in got)
    else:
        assert channels == [0, 2, 4][:cap] and dropped == 4 - cap


@pytest.mark.slow
def test_weak_scaling_efficiency(tmp_path):
    """Weak scaling, as the JAX package's test measures it: 4 channels per
    process, 1 process and then 2, each pushing its block 3 more times;
    the per-process rate of the 2-process run, corrected for the cores
    the two processes share (``2 / os.cpu_count()``, at least 1), over the
    1-process rate. On one host the two workers share its cores, so the
    correction isolates the collectives' overhead (gloo on loopback) from
    the contention for cores. The correction counts processes, so each
    worker runs one intra-op thread: with torch's default of one thread
    per core, two processes oversubscribe every core, which it does not
    model (on 8 cores that alone cut the ratio to about a quarter)."""
    def rate(nproc):
        return min(r["samples_per_s"] for r in _two_workers(
            tmp_path, 64, nproc, reps=3, threads=1))
    r1, r2 = rate(1), rate(2)
    oversub = max(1.0, 2.0 / (os.cpu_count() or 1))
    eff = r2 * oversub / r1
    print(f"\nweak scaling: 1p={r1 / 1e6:.3f} MS/s/proc, "
          f"2p={r2 / 1e6:.3f} MS/s/proc, oversub x{oversub:.0f}, "
          f"efficiency ~{eff * 100:.0f}%")
    assert eff > 0.5, "the collectives' overhead dominates the 2-process run"

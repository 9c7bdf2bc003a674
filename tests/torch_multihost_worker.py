"""Worker process for the port's 2-process test (tests/test_torch_multihost.py).

Usage: torch_multihost_worker.py <coordinator> <nproc> <pid> <outfile> [cap
       [bench_reps]]

The port's twin of tests/multihost_worker.py: each process joins a gloo
process group over loopback, owns 4 channels on a mesh of 4 CPU devices
and pushes its rows of tests/multihost_fixture.py's block through
rtl_433_tpu_torch's MultiHostEngine (package cap ``cap``, default 64).
Decoded (global channel, event-json) pairs of the LOCAL channels, the
noise floor and the packages dropped by the cap are written to
<outfile>. With ``bench_reps`` the block is pushed and drained that many
times more, and the process's rate (``samples_per_s``: samples of its
channels per second, as tests/multihost_worker.py reports it) is written
too. Imports neither jax nor the JAX package.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multihost_fixture import make_local_iq  # noqa: E402
from rtl_433_tpu_torch.decoders import Registry  # noqa: E402
from rtl_433_tpu_torch.dsp.engine import DetectorParams  # noqa: E402
from rtl_433_tpu_torch.output.data_model import event_to_json  # noqa: E402
from rtl_433_tpu_torch.parallel import multihost  # noqa: E402


def main(argv):
    coordinator, nproc, pid, outfile = argv[:4]
    cap = int(argv[4]) if len(argv) > 4 else 64
    bench_reps = int(argv[5]) if len(argv) > 5 else 0
    nproc, pid = int(nproc), int(pid)
    multihost.initialize(coordinator, nproc, pid)
    try:
        params = DetectorParams(sample_rate=250_000, pkg_cap=4)
        reg = Registry()
        reg.register_all()
        eng = multihost.MultiHostEngine(
            params, channels_per_process=4, registry=reg, pkg_cap_total=cap,
            devices=[torch.device("cpu")] * 4)
        iq = make_local_iq(pid)
        eng.push(iq)
        noise = eng.noise_floor_db
        events = [(c, event_to_json(ev)) for c, ev in eng.local_events()]
        rate = None
        if bench_reps:
            t0 = time.perf_counter()
            for _ in range(bench_reps):
                eng.push(iq)
                eng.local_events()
            rate = bench_reps * iq.shape[1] * iq.shape[0] / (
                time.perf_counter() - t0)
        with open(outfile, "w") as f:
            json.dump({"pid": pid, "noise": noise, "events": events,
                       "dropped": eng.n_pkg_dropped,
                       "samples_per_s": rate}, f)
    finally:
        torch.distributed.destroy_process_group()
    print(f"worker {pid}: {len(events)} events")


if __name__ == "__main__":
    main(sys.argv[1:])

"""The port stands alone: it imports neither jax nor the JAX package.

A subprocess with ``jax`` and ``rtl_433_tpu`` made unimportable imports
every port module (``parallel/`` and ``decoders/pool.py`` among them) and
decodes a fixture on the CPU, through the API, the CLI (also as SigMF
through a conf file's flex decoder: ``io/sigmf.py``, ``confparse.py``,
``decoders/flex.py``; and with ``-A``, ``-K FILE`` and ``-F syslog``:
``pulse/analyzer.py``, ``output/network.py``), the HTTP server's control
verbs (``output/http_server.py``), and a
``ShardedEngine`` on a 2-device CPU mesh whose events come from forked
``DecodePool`` workers, and a ``TimeShardEngine`` on a 4-segment CPU mesh.
Another runs a copy of the port alone in a directory, with
neither ``native/`` nor the JAX package beside it, and decodes a fixture
under the default registration: the fast dispatch builds its slicer
library from the port's own ``csrc/slicers.cpp``. The port's sources,
chip_smoke.py and the jax-free test helpers (the multihost worker, the
time-shard cases) are scanned for imports of either; the port's sources name
neither ``native/`` nor the JAX package. The GPU entry points refuse to
run, rather than fall back to the CPU, where there is no GPU.
"""

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "rtl_433_tpu_torch")
NEXUS = os.path.join(REPO, "tests", "fixtures", "nexus",
                     "g001_433.92M_250k.cu8")

_BLOCKED = r'''
import importlib.abc, io, json, pkgutil, sys, contextlib
sys.modules["jax"] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "rtl_433_tpu" or name.startswith("rtl_433_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, REPO)
import rtl_433_tpu_torch
for m in pkgutil.walk_packages(rtl_433_tpu_torch.__path__,
                               "rtl_433_tpu_torch."):
    __import__(m.name)
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.output.data_model import event_to_json
rx = RtlTpu(register_all=False, report_time="off", device="cpu")
rx.registry.register(19)
api = [json.loads(event_to_json(e)) for e in rx.decode_file(NEXUS)]
# device slicing (decoders/device_dispatch.py, ops/slice.py) on the CPU
rx = RtlTpu(register_all=False, report_time="off", device="cpu",
            device_slice=True)
rx.registry.register(19)
sliced = [json.loads(event_to_json(e)) for e in rx.decode_file(NEXUS)]
assert rx.registry._train_cache
from rtl_433_tpu_torch import cli
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(["-R", "19", "-r", NEXUS, "-F", "json", "--device", "cpu"])
cli_events = [json.loads(l) for l in buf.getvalue().splitlines() if l]
# two channels (the fixture, and silence) on a 2-device CPU mesh, decoded
# on a forked worker pool
import numpy as np
import torch
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.dsp.engine import DetectorParams
from rtl_433_tpu_torch.io import load_iq
from rtl_433_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
one = load_iq(NEXUS, "cu8")
# the replay CLI's inputs of their own modules: a conf file (confparse.py)
# whose flex decoder (decoders/flex.py) takes the capture, as SigMF
# (io/sigmf.py)
import os, shutil, tempfile
from rtl_433_tpu_torch.io import sigmf
tmpd = tempfile.mkdtemp()
sm = os.path.join(tmpd, "nexus.sigmf")
sigmf.write(sm, one, 250_000, 433_920_000)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc_flex = cli.main(["-c", os.path.join(REPO, "conf", "nexus_th.conf"),
                        "-R", "19", "-r", sm, "-F", "json", "--device",
                        "cpu"])
flex_cli = [json.loads(l) for l in buf.getvalue().splitlines() if l]
shutil.rmtree(tmpd)
# the analyzer, a data tag and a network output (pulse/analyzer.py,
# output/network.py), and the HTTP server's verbs (output/http_server.py)
import socket
udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
udp.bind(("127.0.0.1", 0))
udp.settimeout(10)
buf, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
    rc_net = cli.main(["-R", "19", "-r", NEXUS, "-F", "json", "-A", "-K",
                       "FILE", "-F", "syslog:127.0.0.1:%d"
                       % udp.getsockname()[1], "--device", "cpu"])
net_cli = [json.loads(l) for l in buf.getvalue().splitlines() if l]
syslog = udp.recv(4096).decode()
analyzer = err.getvalue()
from rtl_433_tpu_torch.output.http_server import HttpServerSink
srv = HttpServerSink(RtlTpu(register_all=False, device="cpu"),
                     "127.0.0.1", 0)
verbs = [srv.handle_cmd("device_info", None),
         srv.handle_cmd("center_frequency", 868300000)]
srv.close()
n = one.shape[0] + (-one.shape[0]) % 128
blk = np.full((2, n, 2), 128, np.uint8)
blk[0, :one.shape[0]] = one
reg = Registry()
reg.register(19)
eng = ShardedEngine(DetectorParams(), 2,
                    make_mesh(devices=[torch.device("cpu")] * 2),
                    registry=reg)
eng.use_decode_pool(2)
eng.push(blk, n_valid=one.shape[0], flush=True)
sharded = [[c, json.loads(event_to_json(e))] for c, e in eng.drain_events()]
eng.close_decode_pool()
# one channel split over time on a 4-segment CPU mesh
from rtl_433_tpu_torch.parallel import Mesh, TimeShardEngine
reg = Registry()
reg.register(19)
eng = TimeShardEngine(DetectorParams(), 1,
                      Mesh([torch.device("cpu")] * 4, ("sp",), (4,)),
                      registry=reg)
tblk = np.full((1, one.shape[0] + (-one.shape[0]) % 512, 2), 128, np.uint8)
tblk[0, :one.shape[0]] = one
eng.push(tblk, n_valid=one.shape[0], flush=True)
timeshard = [json.loads(event_to_json(e)) for c, e in eng.drain_events()]
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "rtl_433_tpu" or k.startswith("rtl_433_tpu."))
print(json.dumps({"api": api, "cli": cli_events, "rc": rc,
                  "flex_cli": flex_cli, "rc_flex": rc_flex,
                  "net_cli": net_cli, "rc_net": rc_net, "syslog": syslog,
                  "analyzer": analyzer, "verbs": verbs,
                  "sharded": sharded, "sliced": sliced,
                  "timeshard": timeshard,
                  "loaded": [k for k in bad if sys.modules[k] is not None]}))
'''


_ALONE = r'''
import importlib.abc, json, sys
sys.modules["jax"] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "rtl_433_tpu" or name.startswith("rtl_433_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.decoders.base import Registry
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse import native_slicers
calls = {"_run_fast": 0, "_run_host": 0}
for name in calls:
    def wrap(fn, name=name):
        def run(self, *a, **k):
            calls[name] += 1
            return fn(self, *a, **k)
        return run
    setattr(Registry, name, wrap(getattr(Registry, name)))
rx = RtlTpu(report_time="off", device="cpu")
events = [json.loads(event_to_json(e)) for e in rx.decode_file(NEXUS)]
lib = native_slicers._lib._name
print(json.dumps({"events": events, "calls": calls, "lib": lib,
                  "active": len(rx.registry.active)}))
'''


def test_port_alone_takes_the_fast_path(tmp_path):
    """A copy of the port in a directory of its own: no native/, no JAX
    package. The default registration decodes on the fast path, with a
    slicer library built into the copy's own _build/."""
    shutil.copytree(PKG, tmp_path / "rtl_433_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    nexus = tmp_path / "nexus_433.92M_250k.cu8"
    shutil.copy(NEXUS, nexus)
    code = f"ROOT = {str(tmp_path)!r}\nNEXUS = {str(nexus)!r}\n" + _ALONE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not (tmp_path / "native").exists()
    assert not (tmp_path / "rtl_433_tpu").exists()
    assert res["active"] == 335
    assert res["calls"]["_run_host"] == 0
    assert res["calls"]["_run_fast"] >= 1
    assert res["lib"].startswith(str(tmp_path / "rtl_433_tpu_torch"
                                     / "_build" / "libslicers-"))
    assert res["events"] == _want()


def _want():
    with open(NEXUS[:-4] + ".json") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_port_runs_with_jax_and_reference_blocked():
    code = f"REPO = {REPO!r}\nNEXUS = {NEXUS!r}\n" + _BLOCKED
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["rc"] == 0
    want = _want()
    assert res["api"] == want
    # the CLI stamps file replay with the stream position
    assert [e.pop("time").startswith("@") for e in res["cli"]] == \
        [True] * len(want)
    assert res["cli"] == want
    # nexus_th.conf's flex decoder (priority 0) takes the package first
    assert res["rc_flex"] == 0
    assert [(e["model"], e["rows"][0]["id"]) for e in res["flex_cli"]] == \
        [("nexus", want[0]["id"])]
    # -K FILE, -A and -F syslog
    assert res["rc_net"] == 0
    assert [e.pop("file") for e in res["net_cli"]] == \
        [os.path.basename(NEXUS)] * len(want)
    assert [dict(e, time=None) for e in res["net_cli"]] == \
        [dict(e, time=None) for e in res["cli"]]
    assert '"model":"Nexus-TH"' in res["syslog"]
    assert "Guessing modulation: Pulse Position Modulation" in \
        res["analyzer"]
    assert res["verbs"] == [{"driver": "cpu", "backend": "torch"},
                            {"center_frequency": 868300000.0}]
    assert res["sharded"] == [[0, e] for e in want]
    assert res["timeshard"] == want


def _sources():
    files = [f for f in glob.glob(os.path.join(PKG, "**", "*.py"),
                                  recursive=True)
             if os.sep + "_build" + os.sep not in f]
    # and the helpers the port's GPU runs and process workers import
    helpers = ["chip_smoke.py", "tests/torch_multihost_worker.py",
               "tests/torch_timeshard_cases.py", "tests/torch_decl_cases.py",
               "tests/torch_replay_cases.py", "tests/torch_live_cases.py",
               "tests/torch_output_cases.py"]
    return sorted(files) + [os.path.join(REPO, h) for h in helpers]


@pytest.mark.parametrize("path", _sources(),
                         ids=[os.path.relpath(p, REPO) for p in _sources()])
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "rtl_433_tpu"), \
                f"{path}: imports {n}"


def _port_sources():
    return [f for f in _sources() if f.startswith(PKG + os.sep)]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=[os.path.relpath(p, REPO)
                              for p in _port_sources()])
def test_port_names_neither_native_nor_the_jax_package(path):
    """No path into native/ or the JAX package, in code or in text."""
    with open(path) as f:
        text = f.read()
    hits = re.findall(r"rtl_433_tpu\b|\bnative/", text)
    assert not hits, f"{path}: {hits}"


def test_cuda_device_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal path is not taken")
    from rtl_433_tpu_torch.api import RtlTpu
    from rtl_433_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RtlTpu(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RtlTpu(channels=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh()


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    """chip_smoke.py exits non-zero with no result line where there is no
    GPU, and when it is alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    runs = [os.path.join(REPO, "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(runs[0], alone)
    runs.append(str(alone))
    for script in runs:
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120,
                             cwd=os.path.dirname(script))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

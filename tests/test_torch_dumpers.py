"""The IQ taps of the block loop: the port against the JAX package.

``process_block(..., streams=True)`` hands back channel 0's filtered am/fm
streams from the front end; they equal the JAX package's host recompute
(``RtlTpu._dumper_streams``: the same IIRs from the same carries) with FM
on and off, the AM envelope and the magnitude estimate, on a block whose
envelope reaches 32768 (with FM off the fm stream is the raw estimator,
which wraps to -32768 in int16). Then each package's CLI replays one short
capture twice: with FM off (``-R 19``), every ``-w`` format, ``-S all``
and a ``-F rtltcp`` passthrough client; with FM on (``-R 19 -R 75``),
every format through ``-W`` over old files and a ``.sr`` session. Every
file, the session's members, the client's bytes and stdout and stderr
equal the JAX CLI's.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from rtl_433_tpu import cli as jcli
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.dsp.engine import DetectorParams as JaxParams
from rtl_433_tpu_torch import cli as tcli
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.io import load_iq

sys.path.insert(0, os.path.dirname(__file__))
from torch_live_cases import (DUMP_FORMATS, Passthrough,  # noqa: E402
                              dump_argv, fixed_localtime, free_port,
                              read_dumps)
from torch_replay_cases import PinnedClock, fixture, run_cli  # noqa: E402

CPU = torch.device("cpu")


def _capture():
    """The nexus capture with 2000 saturated samples (envelope 32768)
    after it: one partial block."""
    iq = load_iq(fixture("nexus"), "cu8")
    sat = np.full((2000, 2), 255, np.uint8)
    return np.concatenate([iq, sat, iq[:3000]])


@pytest.mark.parametrize("use_mag_est", [False, True],
                         ids=["ampest", "magest"])
@pytest.mark.parametrize("enable_fm", [False, True], ids=["fm_off", "fm_on"])
def test_streams_match_jax(enable_fm, use_mag_est):
    """A whole block (the saturated samples in it) then a partial one:
    each block's streams equal JAX's ``_dumper_streams`` from the carries
    the block starts with."""
    iq = _capture()
    sat = np.nonzero(iq[:, 0] == 255)[0][0]
    blocks = [iq[sat - 4096:sat + 4096], iq[sat + 4096:sat + 10096]]
    N = 8192
    kw = dict(sample_rate=250_000, use_mag_est=use_mag_est,
              enable_fm=enable_fm, fsk_minmax=False)
    params = te.DetectorParams(**kw)
    jparams = JaxParams(**kw)
    state = te.detector_init(params, 1, CPU)
    wrapped = False
    for blk in blocks:
        n = blk.shape[0]
        x = np.full((1, N, 2), 128, np.uint8)
        x[0, :n] = blk
        before = {k: v.numpy().copy() for k, v in state.items()}
        state, _, got = te.process_block(
            params, state, torch.from_numpy(x), None if n == N else n,
            streams=True)
        me = types.SimpleNamespace(_state=before, use_mag_est=use_mag_est,
                                   _params=jparams, sample_rate=250_000)
        am, fm = JaxRtlTpu._dumper_streams(me, blk)
        assert got.dtype == np.int16 and got.shape == (2, n)
        np.testing.assert_array_equal(got[0], am)
        np.testing.assert_array_equal(got[1], fm)
        wrapped |= bool((got[1] == -32768).any())
    assert wrapped == (not enable_fm and not use_mag_est)


def test_streams_of_a_segmented_block():
    """A block longer than one segment hands back its segments' streams
    end to end: the same as the segments pushed as blocks."""
    params = te.DetectorParams(sample_rate=250_000)
    iq = np.concatenate([_capture()] * 3)[:te.SEG + 4096]
    one = te.detector_init(params, 1, CPU)
    two = te.detector_init(params, 1, CPU)
    _, _, got = te.process_block(params, one,
                                 torch.from_numpy(iq[None].copy()),
                                 streams=True)
    parts = []
    for lo, hi in ((0, te.SEG), (te.SEG, len(iq))):
        two, _, s = te.process_block(
            params, two, torch.from_numpy(iq[None, lo:hi].copy()),
            streams=True)
        parts.append(s)
    np.testing.assert_array_equal(got, np.concatenate(parts, 1))


class GateClock(PinnedClock):
    """The pinned clock; its first sleep (``-M replay``'s, before the first
    block) waits until the passthrough client is connected."""

    def __init__(self, gate):
        super().__init__()
        self.gate = gate

    def sleep(self, s):
        if self.gate is not None:
            self.gate.wait(60)
            self.gate = None
        super().sleep(s)


def _run(main, pkg_dir, cap, fm_on):
    """One CLI run in ``pkg_dir`` (its working directory): the outputs and
    the files it wrote."""
    os.makedirs(pkg_dir)
    cwd = os.getcwd()
    os.chdir(pkg_dir)
    try:
        argv = ["-R", "19", "-r", cap, "-F", "json"]
        if main is tcli.main:
            argv += ["--device", "cpu"]
        reader = None
        if fm_on:
            # -W over old files, and a PulseView session of five channels
            for fmt in DUMP_FORMATS:
                with open(f"dump.{fmt}", "wb") as f:
                    f.write(b"old contents")
            opts = dump_argv(".")
            argv += ["-R", "75", "-w", "session.sr"] + [
                "-W" if o == "-w" else o for o in opts]
            res = run_cli(main, argv)
        else:
            port = free_port()
            reader = Passthrough(port)
            reader.start()
            argv += dump_argv(".") + ["-S", "all", "-M", "replay", "-F",
                                      f"rtltcp:127.0.0.1:{port}"]
            res = run_cli(main, argv, clock=GateClock(reader.connected))
            reader.done.set()
            reader.join(timeout=30)
        return res, read_dumps("."), reader and reader.data
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dumps")
    cap = str(tmp / "cap_433.92M_250k.cu8")
    _capture().tofile(cap)
    out = {}
    with fixed_localtime():
        for fm_on in (False, True):
            for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
                out[fm_on, pkg] = _run(main, str(tmp / f"{pkg}_{fm_on}"),
                                       cap, fm_on)
    return out


@pytest.mark.parametrize("fmt", DUMP_FORMATS)
@pytest.mark.parametrize("fm_on", [False, True], ids=["fm_off", "fm_on"])
def test_dump_matches_jax(fm_on, fmt, runs):
    name = f"dump.{fmt}"
    port, jax = runs[fm_on, "port"][1], runs[fm_on, "jax"][1]
    assert port[name] == jax[name]
    assert port[name] != b"old contents"


@pytest.mark.parametrize("fm_on", [False, True], ids=["fm_off", "fm_on"])
def test_outputs_and_files_match_jax(fm_on, runs):
    """Exit code, stdout and stderr, and the same set of files (-S all
    writes none: the grabber only keeps its ring)."""
    port, jax = runs[fm_on, "port"], runs[fm_on, "jax"]
    assert port[0] == jax[0] and port[0][0] == 0
    assert '"Nexus-TH"' in port[0][1]
    assert sorted(port[1]) == sorted(jax[1])
    want = {f"dump.{f}" for f in DUMP_FORMATS}
    assert set(port[1]) - want == ({"session.sr"} if fm_on else set())
    samples = len(_capture())
    assert len(port[1]["dump.cu8"]) == 2 * samples
    assert len(port[1]["dump.am.s16"]) == 2 * samples


def test_sigrok_session_matches_jax(runs):
    """The .sr zip: the same members with the same bytes."""
    port = runs[True, "port"][1]["session.sr"]
    jax = runs[True, "jax"][1]["session.sr"]
    assert port == jax
    assert sorted(port) == ["analog-1-4-1", "analog-1-5-1", "analog-1-6-1",
                            "analog-1-7-1", "logic-1-1", "metadata",
                            "version"]
    assert len(port["logic-1-1"]) == len(_capture())


def test_rtltcp_passthrough_matches_jax(runs):
    """The bytes a client of -F rtltcp reads: the header, then the block."""
    port, jax = runs[False, "port"][2], runs[False, "jax"][2]
    assert port == jax
    cap = _capture()
    assert port[:4] == b"RTL0" and port[12:] == cap.tobytes()

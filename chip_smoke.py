#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rtl_433_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device  -- the card's name and power limit;
2. build   -- compile every CUDA source of csrc/ (one nvcc each,
              in parallel) and show ptxas's register report; build the host
              slicer library (csrc/slicers.cpp, host c++) and lower the
              declarative specs, so that neither one-time cost falls into
              a timed decode below (a failed build fails the run);
3. frontend -- the front-end kernel against its plain version, bit-exact,
              for every (use_mag_est, enable_fm) at C=8, N=131072, plus an
              n_valid case and the 1024 kS/s FM coefficients; then its
              time at C=1 and C=4096;
4. detector -- the detector-scan kernel against its plain version,
              bit-exact on registers, logs and the count of quiet chunks,
              at C=4, N=131072 with classic and minmax tracking, FM on and
              off, on IQ with real OOK and FSK bursts made from a seed;
              then on the quiet path's edge cases of
              tests/torch_scan_cases.py at N=131072 (33 channels, the
              fixed high level, a ramp on the quiet bound, n_valid inside a
              chunk, lead_in crossing 1024 in a quiet chunk, 512-sample
              chunks voting in groups of 16, every batched run of
              detector_step.cuh leaving on every offset of a batch); then
              its time at C=1 and C=4096, with two whole 32-channel groups
              of the C=4096 run checked, quiet counts included;
4b. compact -- the package-compaction kernel against its plain version,
              bit-exact on all five outputs, at C=4096, S=8, P=1200 and cap
              768 and 2048, on a sparse state (total below both caps) and a
              dense one (above both), out_n over 0..12 and meta over the
              whole int32 range; then its device time (every call queued
              behind a spinning card) and its time per call with the
              host's launch cost, the same two for the gather by
              torch.index_select (the library yardstick), and its bound;
4c. slice -- device slicing's kernels against their plain versions,
              bit-exact on every plane of every lane: csrc/slice.cu for each
              of the nine slicer families on fuzz trains
              (tests/torch_slice_cases.py) at the bank's caps and at caps
              that flag most lanes, and csrc/dispatch.cu's content dedup
              and record gather on those outputs and on planes with
              planted repeats;
4d. decl_bank -- the declarative decode bank's kernel (csrc/decl_bank.cu)
              against its plain version, bit-exact on code and raws, on a
              fuzz batch of 8192 candidates over all 77 specs
              (tests/torch_decl_cases.py: the oracle vectors' candidates,
              flipped, inverted and with stale stored bits; planted
              preambles, Manchester rows, n from 0 to 512); its device
              time, the plain version's and the bound;
4e. mic   -- each of the twelve MIC digests (csrc/mic.cu) at 65536 rows,
              with the nbytes/poly/key cases of tests/test_mic_kernels.py,
              uint8 and int32 rows, bit-exact against the plain version and
              against bits/util.py on a sample of rows; through the entry
              points with the launch counts set to 0 before and read after;
              device time, plain time, bound;
5. main    -- RtlTpu(device="cuda").decode_file with -R <n> on all 106
              fixtures of tests/fixtures/ (250, 1024 and 4096 kS/s); events
              must equal the committed .json. Then the fixtures are decoded
              again with every kernel call's inputs recorded (C=1,
              N=131072: FM off for the OOK fixtures, FM on for the FSK
              ones), and each recorded call is checked against the plain
              version, bit-exact, the detector's quiet-chunk count
              included; printed by kernel x sample rate x FM on/off (calls,
              max_abs_err, share of chunks that took the quiet path); then
              all 106 again with device slicing (main_device_slice): the
              committed events, every slicer family launched, and every
              kernel call those decodes made held to the plain version
              (with each family's lanes and flagged lanes), the
              declarative bank's launches among them (the prewarm's
              drain-wide batch runs on the card), and each device-backed
              DeclRunner.decode_many of those decodes timed on the card
              and on the NumPy host backend on the same items (the same
              result), with its kernel, plain and bound times;
6. stream  -- nexus and lacrosse_tx35 concatenated 64 times, lacrosse_tx29
              16 times, decoded end to end: copies x the committed events;
              MS/s and ms/block, then the same decode under torch.profiler
              (checked too) for device ms per block by kernel and the
              device's busy share. Then mixed_250k and mixed_1024k: the 82
              fixtures at 250 kS/s and the 20 at 1024 kS/s, each set
              concatenated in sorted order, decoded under the default
              registration (335 protocols) on the default dispatch
              (Registry._run_fast for every package), untraced and traced,
              equal to the port's own device="cpu" decode of the same
              file, with the host ms per block spent in the decoders; a
              third decode splits that host time into native slicing,
              gate/plan building, Python decode calls and the declarative
              bank. Each is decoded again with device slicing: the same
              events, no train left to the host slicer, and the prewarm
              split into the kernels' device spans, the host part of
              batch_slice, the memo plans and the record freeze; every
              kernel call of one more such decode of each stream is held
              to the plain version, and its decode_many calls timed on the
              card and on the host backend (slice_inputs). mixed_250k is
              decoded once more on the per-decoder host path
              (Registry._use_native forced off): the same events;
6b. multichannel -- bench.py's signal-dense workload at full width through
              ShardedEngine on the card: C=4096 channels x N=131072 samples,
              four rotation blocks (tests/torch_bench_blocks.py, equal to
              bench.py's), a quarter of the channels bursting (80% LaCrosse
              TX35, 20% Silvercrest), default registration, compaction cap
              768. One warm-up rotation, then 12 timed blocks: zero overflow
              and drop counters, bench.py's event floor, MS/s, ms per block
              split into the engine step, the harvest (compaction + copy)
              and the host decode, train-memo builds per block; each
              compaction call of the warm-up, and two whole 32-channel
              groups (channels 0-31 and C-32..C-1) of the last warm-up
              block's front-end and detector calls, held to the plain
              version; 12 more blocks under torch.profiler for device ms
              per block by kernel and the busy share; 64 sampled channels
              (every burst kind and rotation, and quiet ones) run alone
              through ShardedEngine(channels=1), the same events; then a
              fresh engine on the forked decode pool (os.cpu_count() - 1
              workers): its events equal the inline run's, in order. The
              timed blocks repeat the warm-up's, so their trains hit the
              registry's train memo and decode cache; the same blocks run
              once more inline and on the pool with both cut to one entry
              (no_cache: the cost of trains not seen before), the same
              events in order; then inline with both emptied before every
              drain (no_cache.per_drain): on the host path with the host
              decode split as the mixed lines carry it, and with device
              slicing (its prewarm split, memo builds per block), the same
              events; the device pass's warm-up drain's kernel calls are
              held to the plain version and timed, its declarative batch
              on the card against the host backend; each process's rows of
              the four rotation blocks are saved for 6d;
6c. timeshard -- nexus x 64, lacrosse_tx35 x 64 and the default
              registration's mixed_250k and mixed_1024k, 131072-sample blocks
              at one channel, through TimeShardEngine on Mesh([cuda] * D)
              for D in 8 and 32 and, in the same call, the one-channel
              ShardedEngine: equal events, fallbacks and verified blocks,
              wall ms per block of both, and under torch.profiler the
              device ms per block of both by kernel (front end, detector,
              timeshard_chain, timeshard_gather, compaction, copies, other:
              the drain); every per-lane-origin front-end and detector call
              and every chain and gather call of one more lacrosse_tx35
              decode held to its plain version;
6d. multihost -- two processes on the one card (gloo on loopback), each
              with 2048 channels of the rotation blocks through
              MultiHostEngine: per block, their events in process order
              equal the multichannel warm-up's one-process events, and
              their all-reduced noise floor its noise floor within 1e-4
              dB; each process's wall ms per block, cold and cached, and
              the all-reduce's ms;
7. kernels -- one line per kernel with its launches on the main path, its
              largest error against the plain version over every check
              above, its times and bound, and its cycles per sample at
              C=1 at the SM clock that nvidia-smi read while the same
              launch ran back to back (sm_clock_mhz). The front end and the
              detector are timed at C=1, the shape of file replay, and at
              C=4096; compaction at the multichannel phase's real state;
              the device-slicing kernels (slice_<family>, content_dup,
              gather_records) with their launches on the device-slicing
              paths and their times summed over every one of one
              dense_4096 drain's calls (NRZS, which no default spec runs,
              at its fuzz call); the time-shard chain and gather with
              their launches on the timeshard phase and their times at
              its first lacrosse_tx35 call at the most segments that made
              one (a block that fails verification stops after the chain,
              so the gather runs only on verified blocks), the gather
              beside index_select and torch.where; the declarative bank
              with its launches on the device-slicing paths, timed at the
              dense_4096 drain's batch and at the fuzz batch; each MIC
              digest with its launches and times at the mic phase.

Every phase line carries its seconds. The line before the last is
nvidia-smi's name and power limit; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_BLOCK = 131072
SEED = 20261016

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
# int32 ops/s = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BPS = 3.35e12
INT32_OPS = 132 * 64 * 1.98e9
# int32 ops per sample, counted from the sources
FRONTEND_OPS = 40
DETECTOR_OPS = 20

FE_OUTS = ("am", "fm", "state", "env_sum")
DET_OUTS = ("regs", "log_key", "log_p", "log_g", "eop_log", "quiet")
COMPACT_OUTS = ("pulse", "gap", "meta", "channel", "count")
# the kernels of single-channel file replay (RtlTpu reads its packages
# with take_packages; compaction runs on the multichannel path)
REPLAY_KERNELS = ("frontend", "detector_scan")
COMPACT_INS = ("out_n", "out_p", "out_g", "out_meta")
# the kernels of the multichannel path without device slicing
MC_KERNELS = ("frontend", "detector_scan", "compact")

# bench.py's signal-dense workload (bench.py:183-201)
MC_CHANNELS = 4096
MC_ROTATIONS = 4
MC_BLOCKS = 12
MC_CAP = 768
MC_SAMPLE = 64
# candidates of the decl_bank phase's fuzz batch
DECL_FUZZ = 8192
# device-slicing kernel calls queued behind one spin of the card when
# every call of a drain is timed (cuda_ms_all)
DS_CHUNK = 64

# (fixture, protocol, copies) byte-concatenated into one file per stream
STREAMS = [("nexus", 19, 64), ("lacrosse_tx35", 75, 64),
           ("lacrosse_tx29", 76, 16)]

# time sharding of one channel (parallel/timeshard.py): segments per block,
# the kernels of its path, and the stream whose every kernel call is held
# to the plain version
TS_SEGMENTS = (8, 32)
TS_KERNELS = ("frontend", "detector_scan", "timeshard_chain",
              "timeshard_gather")
TS_CHECKED = "lacrosse_tx35"
# blocks of each stream decoded under torch.profiler, per engine
TS_TRACED = 8
CHAIN_OUTS = ("sel", "delta", "out", "by_key", "bad")
GATHER_OUTS = ("log_key", "log_p", "log_g", "eop_log")
# processes of the multihost phase (parallel/multihost.py), on one card
MH_PROCS = 2


_T_PHASE = [time.perf_counter()]


def emit(obj):
    """Print one JSON line; a phase line gets the seconds since the last."""
    if "phase" in obj:
        now = time.perf_counter()
        obj["phase_seconds"] = round(now - _T_PHASE[0], 3)
        _T_PHASE[0] = now
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, busy_first=False):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up.
    With ``busy_first`` the card spins for about 25 ms before the first
    event, so that every run is queued before the card reaches it: the
    time is then the device's alone, without the host's cost per call
    (which dominates a launch of a few microseconds)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if busy_first:
        torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms_all(fns, reps=3, chunk=DS_CHUNK):
    """Device ms of every call of ``fns`` once, in order: the mean over
    ``reps`` after one warm-up pass. Each chunk of ``chunk`` calls is queued
    behind about 10 ms of a spinning card, as in cuda_ms(busy_first=True),
    so that the time is the device's alone; the chunks' times are summed."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        for i in range(0, len(fns), chunk):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            a.record()
            for fn in fns[i:i + chunk]:
                fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
    return total / reps


def sm_clock_mhz(fn):
    """The SM clock, in MHz, that nvidia-smi reads while ``fn`` runs back to
    back on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    q = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while q.poll() is None:
            fn()
            torch.cuda.synchronize()
        out, err = q.communicate(timeout=60)
    finally:
        if q.poll() is None:
            q.kill()
            q.wait()
    if q.returncode != 0:
        fail(f"nvidia-smi clocks.sm failed: {err.strip()}")
    return float(out.strip().splitlines()[0])


def host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def device_us(evt) -> float:
    """Self device time of one profiler row, in us."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, k, None)
        if v:
            return float(v)
    return 0.0


def group_of(key: str) -> str:
    if "timeshard_chain_kernel" in key:
        return "timeshard_chain"
    if "timeshard_gather_kernel" in key:
        return "timeshard_gather"
    if "frontend_kernel" in key:
        return "frontend"
    if "detector_kernel" in key:
        return "detector_scan"
    if "compact_" in key:
        return "compact"
    if "memcpy" in key.lower():
        return "copies"
    return "other"


def profile_groups(prof):
    """Device ms by kernel group of a torch.profiler run."""
    groups = {}
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0:
            g = group_of(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
    return groups


def timed(acc, key, fn):
    """``fn`` with its seconds and calls added to ``acc[key]``."""
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
            acc["n_" + key] = acc.get("n_" + key, 0) + 1
    return run


@contextlib.contextmanager
def patched(*items):
    """Set (object, attribute, value) for the block, then restore."""
    old = [(o, k, o.__dict__[k]) for o, k, _v in items]
    try:
        for o, k, v in items:
            setattr(o, k, v)
        yield
    finally:
        for o, k, v in old:
            setattr(o, k, v)


def split_timers(acc):
    """Time the parts of the default dispatch: the native slicing call,
    the train memo around it (gates and plans), the declarative bank
    and every Python decode function (each wraps the decoder that a
    new registry picks up from ``_DECODERS``)."""
    from rtl_433_tpu_torch.decoders import base as dbase
    from rtl_433_tpu_torch.decoders import declarative
    from rtl_433_tpu_torch.pulse import native_slicers
    R, B = dbase.Registry, native_slicers.SlicerBank
    return patched(
        (B, "slice", timed(acc, "slice", B.slice)),
        (R, "_build_train_memo", timed(acc, "memo", R._build_train_memo)),
        (declarative.DeclRunner, "decode_many",
         timed(acc, "decl", declarative.DeclRunner.decode_many)),
        (dbase, "_DECODERS",
         {k: timed(acc, "python", fn) for k, fn in dbase._DECODERS.items()}))


def split_ms(acc, blocks, n_packages=None):
    """The host decode split, in ms per block, from the ``split_timers``
    accumulators and the host decode's seconds (``acc["host_decode"]``)."""
    ms = {k: acc.get(k, 0.0) / blocks * 1e3
          for k in ("host_decode", "slice", "memo", "python", "decl")}
    out = {"host_decode_ms_per_block": ms["host_decode"],
           "native_slicing_ms_per_block": ms["slice"],
           "gate_plan_ms_per_block": ms["memo"] - ms["slice"],
           "python_decode_ms_per_block": ms["python"],
           "decl_bank_ms_per_block": ms["decl"],
           "rest_ms_per_block": ms["host_decode"] - ms["memo"]
           - ms["python"] - ms["decl"],
           "slice_calls": acc.get("n_slice", 0),
           "memo_builds": acc.get("n_memo", 0),
           "python_decode_calls": acc.get("n_python", 0),
           "decl_batches": acc.get("n_decl", 0)}
    if n_packages:
        out["host_decode_ms_per_package"] = \
            acc.get("host_decode", 0.0) * 1e3 / n_packages
    return out


DS_KERNELS = ("slice", "content_dup", "gather_records", "decl_bank")


@contextlib.contextmanager
def kernel_timers(spans):
    """Record a CUDA event pair around every launch of the device
    slicing's C launchers into ``spans`` [(launcher, start, end)]; the
    launchers enqueue only, so each pair spans the kernel alone."""
    import torch
    from rtl_433_tpu_torch.ops import _cuda
    old = {k: _cuda.launcher(k) for k in DS_KERNELS}

    def wrap(k, fn):
        def run(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = fn(*a)
            e1.record()
            spans.append((k, e0, e1))
            return err
        return run
    try:
        for k, fn in old.items():
            _cuda._fns[k] = wrap(k, fn)
        yield
    finally:
        _cuda._fns.update(old)


def span_ms(spans):
    import torch
    torch.cuda.synchronize()
    out = {}
    for k, e0, e1 in spans:
        out[k] = out.get(k, 0.0) + e0.elapsed_time(e1)
    return out


def prewarm_timers(acc):
    """Time the device slicing's prewarm and its parts: the batched slice
    (kernels, their copies to the host, the host slicer's passes over
    flagged lanes and the specs without a kernel, the banks of flagged
    spec subsets, and the host assembly of the summaries), the memo
    plans, and the drain-wide record freeze."""
    from rtl_433_tpu_torch.decoders import base as dbase
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    R, D, L = dbase.Registry, ddp.DeviceBank, ddp.LazyRecords
    real, real_ovf = R.prewarm_trains, D._get_ovf_bank

    def counted(self, *a, **k):
        n = real(self, *a, **k)
        acc["built"] = acc.get("built", 0) + n
        return n

    def ovf_bank(self, key):
        acc["bank_builds"] = acc.get("bank_builds", 0) + (
            key not in self._ovf_banks)
        return real_ovf(self, key)
    return patched(
        (R, "prewarm_trains", timed(acc, "prewarm", counted)),
        (D, "batch_slice", timed(acc, "batch_slice", D.batch_slice)),
        (D, "_native_piece", timed(acc, "host_slice", D._native_piece)),
        (D, "_get_ovf_bank", timed(acc, "ovf_bank", ovf_bank)),
        (R, "_memo_plans", timed(acc, "plans", R._memo_plans)),
        (L, "freeze_many", staticmethod(timed(acc, "freeze",
                                              L.freeze_many))))


def prewarm_ms(acc, spans, blocks):
    """The prewarm's split in ms per block; ``kernel`` is the device time
    of the launches alone, ``batch_slice_host`` the rest of batch_slice."""
    k = span_ms(spans)
    kern = sum(k.values())
    ms = lambda key: acc.get(key, 0.0) / blocks * 1e3
    return {"prewarm_ms_per_block": ms("prewarm"),
            "kernel_ms_per_block": kern / blocks,
            "kernel_ms_by_launcher": {n: v / blocks for n, v in k.items()},
            "batch_slice_ms_per_block": ms("batch_slice"),
            "batch_slice_host_ms_per_block": ms("batch_slice")
            - kern / blocks,
            "host_slicer_ms_per_block": ms("host_slice"),
            "host_slicer_calls": acc.get("n_host_slice", 0),
            "flagged_banks_ms_per_block": ms("ovf_bank"),
            "flagged_bank_calls": acc.get("n_ovf_bank", 0),
            "flagged_bank_builds": acc.get("bank_builds", 0),
            "memo_plans_ms_per_block": ms("plans"),
            "freeze_ms_per_block": ms("freeze"),
            "prewarm_rest_ms_per_block": ms("prewarm") - ms("batch_slice")
            - ms("plans") - ms("freeze"),
            "prewarm_calls": acc.get("n_prewarm", 0),
            "memo_builds_per_block": acc.get("built", 0) / blocks,
            "batch_slice_calls": acc.get("n_batch_slice", 0)}



SLICE_OUTS = ("bytes", "bits_per_row", "syncs", "num_rows", "n_events", "ovf")
# int32 operations per lane step of csrc/slice.cu, counted from the
# sources (compares, selects, adds and the cursor updates; PCM's includes
# its rates pass, DMC's and PIWM-DC's are per symbol, two per pulse)
SLICE_OPS = {"ppm": 30, "pwm": 36, "pcm": 90, "mc": 40, "dmc": 36,
             "piwm_dc": 26, "nrzs": 16, "rzi": 20, "osv1": 44}
SYMBOL_FAMS = ("dmc", "piwm_dc")


def ds_kernel_names():
    from rtl_433_tpu_torch.ops import _cuda
    return [f"slice_{f}" for f in _cuda.SLICE_FAMILIES] + [
        "content_dup", "gather_records", "decl_bank"]


@contextlib.contextmanager
def ds_recorder(calls, dcalls=None, host_calls=None):
    """Record the device slicing's kernel calls as the main path makes
    them, into ``calls`` [(kind, args)], its device-backed
    ``DeclRunner.decode_many`` calls into ``dcalls`` [(items, device)] and
    those on the NumPy backend (the per-train dispatch's) into
    ``host_calls``.
    The inputs are fresh tensors that nothing writes afterwards, so
    references are kept, not copies."""
    from rtl_433_tpu_torch.decoders import declarative
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from rtl_433_tpu_torch.ops import slice as sl
    slice_cuda, dup, gather = (sl.slice_cuda, ddp._content_dup,
                               ddp._gather_records)
    run_torch, decode_many = dbk.run_torch, declarative.DeclRunner.decode_many

    def rec_bank(bank, bits, n_bits, sid, n_store=None):
        calls.append(("decl_bank", (bank, bits, n_bits, sid, n_store)))
        return run_torch(bank, bits, n_bits, sid, n_store)

    def rec_many(self, items, device=None):
        into = host_calls if device is None else dcalls
        if into is not None:
            into.append((list(items), device))
        return decode_many(self, items, device=device)

    def rec_slice(fam, pulse, gap, n_pulses, bounds, caps=sl.SliceCaps()):
        calls.append(("slice", (fam, pulse, gap, n_pulses, bounds, caps)))
        return slice_cuda(fam, pulse, gap, n_pulses, bounds, caps)

    def rec_dup(out):
        calls.append(("content_dup", ({k: out[k] for k in (
            "bytes", "num_rows", "bits_per_row", "syncs")},)))
        return dup(out)

    def rec_gather(by, sy, bs, js, es):
        calls.append(("gather_records", (by, sy, np.array(bs), np.array(js),
                                         np.array(es))))
        return gather(by, sy, bs, js, es)

    with patched((sl, "slice_cuda", rec_slice), (ddp, "_content_dup", rec_dup),
                 (ddp, "_gather_records", rec_gather),
                 (dbk, "run_torch", rec_bank),
                 (declarative.DeclRunner, "decode_many", rec_many)):
        yield


def ds_fns(kind, args):
    """A recorded call as (kernel name, kernel call, plain call, outputs of
    a result as a list of tensors, their names)."""
    import torch
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from rtl_433_tpu_torch.ops import slice as sl
    if kind == "slice":
        fam, pulse, gap, npl, bounds, caps = args
        cols = bounds if isinstance(bounds, dict) \
            else sl.table_columns(fam, bounds)
        return (f"slice_{fam}",
                lambda: sl.slice_cuda(fam, pulse, gap, npl, bounds, caps),
                lambda: sl.PLAIN[fam](pulse, gap, npl, cols, caps),
                lambda o: [o[k] for k in SLICE_OUTS], SLICE_OUTS)
    if kind == "content_dup":
        planes, = args
        return ("content_dup", lambda: ddp._content_dup(planes),
                lambda: ddp._content_dup_plain(planes), lambda o: [o],
                ("dup",))
    if kind == "decl_bank":
        from rtl_433_tpu_torch.ops import decode_bank as dbk
        return ("decl_bank", lambda: dbk.run_torch(*args),
                lambda: dbk.run_torch_plain(*args), list, ("code", "raws"))
    by, sy, bs, js, es = args
    idx = [torch.from_numpy(a.astype(np.int64)).to(by.device)
           for a in (bs, js, es)]
    return ("gather_records",
            lambda: ddp._gather_records(by, sy, bs, js, es),
            lambda: ddp._gather_records_plain(by, sy, *idx),
            lambda o: [torch.as_tensor(x).to(by.device) for x in o],
            ("bytes", "syncs"))


def ds_check(calls, compare, what, flagged=None):
    """Each recorded call once more on the kernel and on its plain version,
    on the card: bit-exact. Returns {kernel name: calls checked}; adds each
    slicer family's lanes (padding included) and flagged lanes (sent to
    the host slicer) to ``flagged``."""
    import torch
    n = {}
    for i, (kind, args) in enumerate(calls):
        name, kern, plain, outs, names = ds_fns(kind, args)
        got = outs(kern())
        torch.cuda.synchronize()
        compare(name, got, outs(plain()), names, f"{what}, call {i}")
        n[name] = n.get(name, 0) + 1
        if flagged is not None and kind == "slice":
            ovf = got[SLICE_OUTS.index("ovf")]
            f = flagged.setdefault(name, {"lanes": 0, "flagged": 0})
            f["lanes"] += ovf.numel()
            f["flagged"] += int(ovf.sum())
    return n


def ds_cost(kind, args):
    """(bytes, int32 operations, shape) that one call must move and do:
    every input read once and every output written once; the operations
    are those this call's trains need (lane steps x specs)."""
    if kind == "slice":
        fam, pulse, _gap, npl, bounds, caps = args
        B, N = pulse.shape
        S = len(bounds["ok"]) if isinstance(bounds, dict) else bounds.shape[0]
        E, R, BY = caps
        nbytes = 8 * B * N + 4 * B + 4 * 12 * S \
            + B * S * (E * R * BY + 8 * E * R + 4 * E + 5)
        steps = int(npl.sum()) * (2 if fam in SYMBOL_FAMS else 1)
        return nbytes, SLICE_OPS[fam] * S * steps, [B, N, S, E, R, BY]
    if kind == "content_dup":
        planes, = args
        vals = sum(planes[k].numel() for k in ("bytes", "bits_per_row",
                                                "syncs"))
        nbytes = planes["bytes"].numel() + 4 * (
            planes["num_rows"].numel() * 2 + planes["bits_per_row"].numel()
            + planes["syncs"].numel())
        return nbytes, vals, list(planes["bytes"].shape)
    if kind == "decl_bank":
        return decl_cost(*args)
    by, _sy, bs, _js, _es = args
    B, J, E, R, W = by.shape
    P = len(bs)
    return 2 * P * (R * W + 4 * R) + 12 * P, 0, [P, R, W]


def ds_measure(calls):
    """Per kernel, summed over every one of ``calls`` (one drain's): device
    ms (cuda_ms_all), the plain version's ms (all calls back to back, one
    sync at the end), the bound (bytes and operations of every call) and,
    for the gather, the library's ms (index_select of the kept records'
    bytes and syncs, every call)."""
    import torch
    from rtl_433_tpu_torch.ops import _cuda
    rows = {}
    for kind, args in calls:
        name, kern, plain, _outs, _names = ds_fns(kind, args)
        r = rows.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0,
                                   "shapes": [], "kern": [], "plain": [],
                                   "library": []})
        nbytes, ops, shape = ds_cost(kind, args)
        r["calls"] += 1
        r["bytes"] += nbytes
        r["ops"] += ops
        if len(r["shapes"]) < 16:
            r["shapes"].append(shape)
        if kind == "gather_records":
            # the launcher alone: the wrapper's index upload and the copy of
            # the result to the host would end each call with a sync
            by, sy, bs, js, es = args
            B, J, E, R, W = by.shape
            P = len(bs)
            ix = torch.from_numpy(np.stack([bs, js, es]).astype(np.int32))\
                .to(by.device)
            ob = torch.empty((P, R, W), dtype=torch.uint8, device=by.device)
            osy = torch.empty((P, R), dtype=torch.int32, device=by.device)
            a = (by.data_ptr(), sy.data_ptr(), ix[0].data_ptr(),
                 ix[1].data_ptr(), ix[2].data_ptr(), P, J, E, R, W,
                 ob.data_ptr(), osy.data_ptr(), _cuda.stream_of(by))
            # the default arguments keep the buffers the launch writes
            kern = (lambda fn=_cuda.launcher("gather_records"), a=a,
                    keep=(ix, ob, osy): fn(*a))
            flat = ((ix[0].long() * J + ix[1].long()) * E + ix[2].long())
            fb, fs = by.reshape(B * J * E, R * W), sy.reshape(B * J * E, R)
            r["library"].append(lambda fb=fb, fs=fs, flat=flat: (
                fb.index_select(0, flat), fs.index_select(0, flat)))
        r["kern"].append(kern)
        r["plain"].append(plain)
    for r in rows.values():
        kern, plain, lib = r.pop("kern"), r.pop("plain"), r.pop("library")
        r["ms"] = cuda_ms_all(kern)
        r["plain_ms"] = host_ms(lambda: [p() for p in plain])
        r["library_ms"] = cuda_ms_all(lib) if lib else None
        b_ms = r["bytes"] / HBM_BPS * 1e3
        o_ms = r["ops"] / INT32_OPS * 1e3
        r["bound_ms"] = max(b_ms, o_ms)
        r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
    return rows


def decl_cost(bank, bits, n_bits, sid, n_store=None):
    """(bytes, int32 operations, shape) of one decode-bank call: the
    candidates' bits, lengths and spec ids read once, code and raws
    written once; per spec present its spec row and the weight tables it
    reads, each once: the table of each live check slot (GF(2) or
    additive, by its kind) and of each of its field rows. Per candidate
    the preamble offsets its search tries up to its first match (one
    compare, xor and mask per pattern word), the frame (an extraction and
    a select per bit, two more for Manchester) and each live check slot
    and field row (a select and a sum per bit)."""
    import torch
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    tabs = dbk.bank_tables(bank, bits.device)
    B, IN = bits.shape
    FB, C, R = bank.frame_bits, bank.n_checks, bank.n_raws
    PW = (bank.pat_len + 31) // 32

    def live_slots(sp):
        return sum((sp[:, dbk.SP_CHECKS + dbk.CK_FIELDS * c]
                    != dbk.CK_OFF).long() for c in range(C))

    present = tabs["spec"][torch.unique(sid).long()]
    tables = int((live_slots(present) + present[:, dbk.SP_NRAW]).sum())
    nbytes = B * (IN + 12 + 4 + 4 * R) + 4 * present.numel() \
        + 4 * FB * tables
    s = sid.long()
    n = n_bits.long()
    found, pos = dbk.preamble_plain(bank, tabs, bits, n, s)
    plen = tabs["plen"][s].long()
    start = tabs["pre_start"][s].long().clamp(min=0)
    end = torch.where(found, pos + 1, (n - plen + 1).clamp(max=IN))
    tried = torch.where(plen > 0, (end - start).clamp(min=0), 0)
    sp = tabs["spec"][s]
    live = live_slots(sp)
    per = FB * (2 + 2 * live + 2 * sp[:, dbk.SP_NRAW].long()
                + 2 * (tabs["transform"][s] == dbk.TF_MANCHESTER).long())
    ops = int((tried * 3 * PW).sum() + per.sum())
    return nbytes, ops, [B, IN, FB, C, R]


def decl_measure(dcalls, kcalls, cpu=False):
    """The device-backed decode_many calls ``dcalls`` of a path and the
    decl_bank kernel calls ``kcalls`` they made: candidates per call, the
    kernel's device ms (cuda_ms_all), the plain version's ms, the bound,
    and the whole decode_many on the card against the NumPy host backend
    on the same items (host wall, each call synchronized; the same
    results, or the run fails); with ``cpu``, also decode_many on
    ``device="cpu"`` (the torch bank's plain version, as CPU device
    slicing runs it). All summed over the path's calls."""
    import torch
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.output.data_model import event_to_json
    runner = get_runner()
    norm = lambda rets: [[event_to_json(e) for e in r]
                         if isinstance(r, list) else repr(r) for r in rets]
    card = host = on_cpu = 0.0
    for items, device in dcalls:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = runner.decode_many(items, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = runner.decode_many(items)
        t2 = time.perf_counter()
        card += t1 - t
        host += t2 - t1
        if norm(got) != norm(want):
            fail("decode_many on the card differs from the host backend")
        if cpu:
            t = time.perf_counter()
            got = runner.decode_many(items, device="cpu")
            on_cpu += time.perf_counter() - t
            if norm(got) != norm(want):
                fail("decode_many on the CPU torch bank differs from the "
                     "NumPy backend")
    m = ds_measure(kcalls).get("decl_bank", {}) if kcalls else {}
    cands = [int(args[1].shape[0]) for _k, args in kcalls]
    return {"decode_many_calls": len(dcalls), "launches": len(kcalls),
            "candidates": sum(cands),
            "candidates_per_call": {"min": min(cands, default=0),
                                    "max": max(cands, default=0)},
            "decode_many_card_ms": card * 1e3,
            "decode_many_host_ms": host * 1e3,
            **({"decode_many_cpu_torch_ms": on_cpu * 1e3} if cpu else {}),
            "kernel_ms": m.get("ms"), "plain_ms": m.get("plain_ms"),
            "bound_ms": m.get("bound_ms"), "bound_by": m.get("bound_by"),
            "equal_results": True}


def per_train_decl(tcalls, compare, what):
    """The default path's per-train decode_many calls ``tcalls`` (NumPy
    backend) once more with the bank on the card: a first pass records
    the kernel calls they make and holds each to the plain version, then
    decl_measure times each call on the card against NumPy."""
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    dcalls = [(items, "cuda") for items, _d in tcalls]
    kcalls = []
    with ds_recorder(kcalls):
        for items, device in dcalls:
            get_runner().decode_many(items, device=device)
    kcalls = [c for c in kcalls if c[0] == "decl_bank"]
    ds_check(kcalls, compare, what)
    return decl_measure(dcalls, kcalls)


# the MIC phase: (digest, nbytes, parameters), the cases of
# tests/test_mic_kernels.py; int32 operations per message byte, counted
# from csrc/mic.cu (per bit a test, a shift, a xor and a mask for the CRCs;
# a test and a xor for the LFSR digests)
MIC_CASES = ([("crc8", *c) for c in ((4, 0x31, 0), (7, 0x31, 0),
                                    (2, 0x07, 0), (14, 0x2F, 0),
                                    (8, 0x31, 0xFF), (6, 0x81, 0),
                                    (5, 0x9C, 0x3D))]
             + [("crc8le", 7, 0x31, 0), ("crc8le", 5, 0x9C, 0x3D)]
             + [(f, *c) for f in ("crc16", "crc16lsb")
                for c in ((10, 0x8005, 0xFFFF), (14, 0x8005, 0xFFFF),
                          (6, 0x1021, 0), (9, 0x1021, 0xFFFF),
                          (4, 0x8810, 0))]
             + [(f, *c) for f in ("lfsr_digest8", "lfsr_digest8_reverse",
                                  "lfsr_digest8_reflect")
                for c in ((5, 0x98, 0xF1), (7, 0x83, 0x7A), (9, 0x31, 0xF4))]
             + [("lfsr_digest16", *c) for c in ((5, 0x8810, 0xABF9),
                                                (9, 0x8810, 0x5412),
                                                (11, 0x8810, 0x0ACC))]
             + [(f, n) for f in ("xor_bytes", "add_bytes", "add_nibbles",
                                 "parity_bytes") for n in (1, 7, 13)])
MIC_OPS = {"crc8": 33, "crc8le": 33, "crc16": 34, "crc16lsb": 33,
           "lfsr_digest8": 17, "lfsr_digest8_reverse": 17,
           "lfsr_digest8_reflect": 17, "lfsr_digest16": 17, "xor_bytes": 1,
           "add_bytes": 1, "add_nibbles": 4, "parity_bytes": 1}
MIC_ROWS = 65536
# the JAX functions (rtl_433_tpu/ops/mic.py)
MIC_LINES = {"crc8": 32, "crc8le": 45, "crc16": 59, "crc16lsb": 72,
             "lfsr_digest8": 110, "lfsr_digest8_reverse": 118,
             "lfsr_digest8_reflect": 128, "lfsr_digest16": 141,
             "xor_bytes": 149, "add_bytes": 154, "add_nibbles": 159,
             "parity_bytes": 164}


def mic_phase(dev, compare, rng):
    """Phase 4e: every MIC case through its entry point at MIC_ROWS rows of
    16 bytes, uint8 and int32 (garbage above the low byte), with the launch
    counts set to 0 before and read after; each result against the plain
    version (bit-exact) and against bits/util.py on 64 sampled rows; then,
    per digest, its largest case timed (device ms, the calls queued behind
    a spinning card), its plain version, its bound and, for add_bytes, the
    one PyTorch call that computes it (``torch.sum`` of the rows' first
    nbytes bytes into int32; equal to the kernel, or the run fails).
    Returns the phase line and the kernels' rows of numbers."""
    import torch
    from rtl_433_tpu_torch.bits import util
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.ops import mic
    msgs = rng.integers(0, 256, (MIC_ROWS, 16), dtype=np.uint8)
    high = (msgs.astype(np.int32)
            + (rng.integers(-99, 99, msgs.shape) << 8).astype(np.int32))
    ins = {"uint8": torch.from_numpy(msgs).to(dev),
           "int32": torch.from_numpy(high).to(dev)}
    sample = rng.integers(0, MIC_ROWS, 64)
    launches = {f"mic_{a}": 0 for a in _cuda.MIC_ALGOS}
    outs = []
    for k in launches:
        _cuda.LAUNCHES[k] = 0
    for name, nbytes, *params in MIC_CASES:
        for t in ins.values():
            outs.append((name, nbytes, params, t,
                         mic.DIGESTS[name][0](t, nbytes, *params)))
    torch.cuda.synchronize()
    for k in launches:
        launches[k] = _cuda.LAUNCHES[k]
        if not launches[k]:
            fail(f"kernel {k} was not launched on the mic phase")
    for name, nbytes, params, t, got in outs:
        want = mic.DIGESTS[name][1](t, nbytes, *params)
        compare(f"mic_{name}", [got], [want], ("digest",),
                f"{name} nbytes={nbytes} {params} {t.dtype}")
        host = [getattr(util, name)(bytes(msgs[i]), nbytes, *params)
                for i in sample]
        if got.cpu().numpy()[sample].tolist() != host:
            fail(f"mic_{name} differs from bits/util.py ({nbytes}, "
                 f"{params})")
    del outs
    rows = {}
    for name in _cuda.MIC_ALGOS:
        _n, nbytes, *params = max((c for c in MIC_CASES if c[0] == name),
                                  key=lambda c: c[1])
        t = ins["uint8"]
        fn, plain = mic.DIGESTS[name]
        ms = cuda_ms(lambda: fn(t, nbytes, *params), reps=20,
                     busy_first=True)
        plain_ms = host_ms(lambda: plain(t, nbytes, *params))
        library_ms = None
        if name == "add_bytes":
            def library():
                return torch.sum(t[..., :nbytes], -1, dtype=torch.int32)
            compare(f"mic_{name}", [fn(t, nbytes)], [library()],
                    ("digest",), f"{name} nbytes={nbytes} against torch.sum")
            library_ms = cuda_ms(library, reps=20, busy_first=True)
        b_ms = (MIC_ROWS * (nbytes + 4) + 32 * nbytes) / HBM_BPS * 1e3
        o_ms = MIC_ROWS * nbytes * MIC_OPS[name] / INT32_OPS * 1e3
        rows[f"mic_{name}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": library_ms, "launches": launches[f"mic_{name}"],
            "shape": [MIC_ROWS, 16, nbytes]}
    line = {"phase": "mic", "rows": MIC_ROWS, "cases": len(MIC_CASES),
            "inputs": list(ins), "bit_exact": True, "host_sampled_rows": 64,
            "launches": launches,
            "ms": {k: v["ms"] for k, v in rows.items()},
            "library_ms": {k: v["library_ms"] for k, v in rows.items()
                           if v["library_ms"] is not None}}
    return line, rows


def synth_iq(rng, n, rate=250_000):
    """One channel of cu8 IQ with OOK PWM bursts and FSK PCM bursts at IF
    tones over noise (the shape of tests/synth.py's signals)."""
    x = np.zeros(n, np.complex128)
    us = rate / 1e6
    t = int(rng.integers(2000, 6000))
    kind = int(rng.integers(0, 2))
    while t < n - 30000:
        ph0 = rng.uniform(0, 2 * math.pi)
        if kind == 0:        # OOK PWM, 264/744 us, on a 50 kHz tone
            for bit in rng.integers(0, 2, 36):
                w = int((264 if bit else 744) * us)
                g = int((744 if bit else 264) * us)
                k = np.arange(w)
                x[t:t + w] = 100 * np.exp(1j * (ph0 + 2 * math.pi * 50e3
                                                / rate * k))
                t += w + g
        else:                # FSK PCM, 100 us bits, 60/20 kHz tones
            bits = np.concatenate([np.tile([1, 0], 16),
                                   rng.integers(0, 2, 48)])
            f = np.repeat(np.where(bits == 1, 60e3, 20e3), int(100 * us))
            ph = ph0 + np.cumsum(2 * math.pi * f / rate)
            x[t:t + len(ph)] = 100 * np.exp(1j * ph)
            t += len(ph)
        kind ^= 1
        t += int(rng.integers(4000, 9000))
    iq = np.stack([x.real, x.imag], -1) + 128 + rng.normal(0, 2.0, (n, 2))
    return np.clip(np.round(iq), 0, 255).astype(np.uint8)


def compact_check(compare, ins, cap, what):
    """The compaction kernel against its plain version on ``ins``."""
    import torch
    from rtl_433_tpu_torch.ops import compact as cmp
    got = cmp.compact_packages_cuda(*ins, cap)
    torch.cuda.synchronize()
    want = cmp.compact_packages_plain(*ins, cap)
    compare("compact", [got[k] for k in COMPACT_OUTS],
            [want[k] for k in COMPACT_OUTS], COMPACT_OUTS, what)


def sampled_channels(C, dev):
    """Two whole 32-channel groups of the front end and the detector, one
    at each end of C channels."""
    import torch
    return torch.cat([torch.arange(0, 32, device=dev),
                      torch.arange(C - 32, C, device=dev)])


def frontend_check_sampled(compare, args, kw, what):
    """The front-end kernel on all C channels of ``args``, two of its
    channel groups held bit for bit to the plain version."""
    import torch
    from rtl_433_tpu_torch.ops import frontend as fe
    iq, st = args
    sel = sampled_channels(iq.shape[0], iq.device)
    got = fe.frontend_cuda(iq, st, **kw)
    torch.cuda.synchronize()
    want = fe.frontend_plain(iq[sel].contiguous(), st[:, sel].contiguous(),
                             **kw)
    got = (got[0][:, sel], got[1][:, sel], got[2][:, sel], got[3][sel])
    compare("frontend", got, want, FE_OUTS, what)


def detector_check_sampled(compare, args, kw, what):
    """The detector kernel on all C channels of ``args``, two of its
    channel groups held bit for bit to the plain version, quiet counts
    included."""
    import torch
    from rtl_433_tpu_torch.ops import detector as det
    am, fm, regs, gen0 = args
    C, dev, R = am.shape[1], am.device, kw["params"].ring
    sel = sampled_channels(C, dev)
    got = det.detector_scan_cuda(am, fm, regs, gen0, **kw)
    torch.cuda.synchronize()
    want = det.detector_scan_plain(
        am[:, sel].contiguous(), fm[:, sel].contiguous(),
        regs[:, sel].contiguous(), gen0[sel].contiguous(), **kw)
    rows = (sel[:, None] * R + torch.arange(R, device=dev)).reshape(-1)
    got = (got[0][:, sel], got[1][rows], got[2][rows], got[3][rows],
           got[4][sel], got[5][sel])
    compare("detector_scan", got, want, DET_OUTS, what)


def compact_measure(ins, cap):
    """The compaction kernel's and the library's device time and time per
    call (index_select on the three flattened planes with a precomputed
    index), the plain version's time,
    and the bound from the bytes this state needs: out_n and the kept rows
    read once, every output row written once."""
    import torch
    from rtl_433_tpu_torch.ops import compact as cmp
    out_n, out_p, out_g, out_meta = ins
    C, S, P = out_p.shape
    F = out_meta.shape[2]
    valid = (torch.arange(S, device=out_p.device)[None, :]
             < out_n.clamp(0, S)[:, None]).reshape(-1)
    idx = torch.nonzero(valid).reshape(-1)[:cap]
    k = idx.numel()
    planes = (out_p.reshape(-1, P), out_g.reshape(-1, P),
              out_meta.reshape(-1, F))
    nbytes = 4 * (C + k * (2 * P + F) + cap * (2 * P + F + 1) + 1)
    kernel = lambda: cmp.compact_packages_cuda(*ins, cap)
    library = lambda: [pl.index_select(0, idx) for pl in planes]
    return {
        "ms": cuda_ms(kernel, reps=20, busy_first=True),
        "library_ms": cuda_ms(library, reps=20, busy_first=True),
        # per call with the host's launch cost, as ShardedEngine pays it
        "call_ms": cuda_ms(kernel, reps=20),
        "library_call_ms": cuda_ms(library, reps=20),
        "plain_ms": host_ms(lambda: cmp.compact_packages_plain(*ins, cap)),
        "bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes, "rows": k,
        "cap": cap, "count": int(valid.sum())}


def multichannel(dev, mesh, compare, ds_kernels, mh_dir,
                 channels=MC_CHANNELS, n=N_BLOCK, n_blocks=MC_BLOCKS,
                 n_sample=MC_SAMPLE, cap=MC_CAP):
    """Phase 6b: bench.py's signal-dense workload through ShardedEngine on
    ``mesh``. Returns (the phase line, the kernel launches of the timed
    blocks, the compaction kernel's numbers at the main path's state, the
    device-slicing kernels' launches on the per-drain no-cache pass, their
    numbers at one drain's calls, and the warm-up rotation's events and
    noise floor per block). ``ds_kernels``: the device-slicing kernels the
    default registration must launch. Each of the MH_PROCS processes' rows
    of every rotation block is saved to ``mh_dir`` for the multihost
    phase."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile
    from rtl_433_tpu_torch.decoders import Registry, garage
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import frontend as fe
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from rtl_433_tpu_torch.parallel.sharding import ShardedEngine
    from torch_bench_blocks import build_blocks, burst_of

    rot = MC_ROTATIONS
    t = time.perf_counter()
    host_blocks, n_bursts = build_blocks(channels, n, rot)
    build_s = time.perf_counter() - t
    per = channels // MH_PROCS
    for r, b in enumerate(host_blocks):
        for p in range(MH_PROCS):
            np.save(os.path.join(mh_dir, f"r{r}_p{p}.npy"),
                    b[p * per:(p + 1) * per])
    blocks = [torch.from_numpy(b).to(dev) for b in host_blocks]
    del host_blocks
    torch.cuda.synchronize()
    # bench.py:195-201
    params = DetectorParams(sample_rate=250_000, fsk_minmax=False,
                            enable_fm=True, chunk=128, ring=8, eops=2,
                            arena=65536)

    def no_cache(reg):
        """Keep at most one entry in the registry's train memo and decode
        cache: the timed blocks repeat the warm-up's byte for byte, so
        that their trains decode as new input, as live input's do."""
        reg.train_cache_max = reg.dec_cache_max = 0

    def engine(c, cold=False):
        reg = Registry()
        reg.register_all()
        if cold:
            no_cache(reg)
        return ShardedEngine(params, c, mesh, registry=reg,
                             pkg_cap_total=cap)

    def count_memo_builds(eng, acc):
        """Count, into ``acc["memo_builds"]``, the pulse trains that the
        engine's registry slices and plans anew (train memo misses)."""
        reg = eng.registry
        build = reg._build_train_memo

        def counted(*a, **k):
            acc["memo_builds"] = acc.get("memo_builds", 0) + 1
            return build(*a, **k)
        reg._build_train_memo = counted

    def timed_blocks(eng, acc):
        """``n_blocks`` blocks with the harvest timed and the packages
        counted into ``acc``; returns (events, wall seconds)."""
        take = eng.take_packages

        def counted_take():
            t0 = time.perf_counter()
            pkgs = take()
            acc["take"] = acc.get("take", 0.0) + time.perf_counter() - t0
            acc["packages"] = acc.get("packages", 0) + len(pkgs)
            return pkgs

        eng.take_packages = counted_take
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            events = run_blocks(eng, n_blocks, acc=acc)
            torch.cuda.synchronize()
        finally:
            eng.take_packages = take
        return events, time.perf_counter() - t0

    def pool_blocks(eng):
        """A warm-up rotation and ``n_blocks`` timed blocks on the forked
        decode pool; returns (events, wall seconds)."""
        try:
            run_blocks(eng, rot)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = run_blocks(eng, n_blocks)
            torch.cuda.synchronize()
            return events, time.perf_counter() - t0
        finally:
            eng.close_decode_pool()

    def split(acc, wall):
        return {"ms_per_block": wall / n_blocks * 1e3,
                "msps": samples / wall / 1e6,
                "step_ms_per_block": acc["push"] / n_blocks * 1e3,
                "harvest_ms_per_block": acc["take"] / n_blocks * 1e3,
                "host_decode_ms_per_block":
                    (acc["drain"] - acc["take"]) / n_blocks * 1e3,
                "packages_per_block": acc["packages"] / n_blocks,
                "memo_builds_per_block": acc.get("memo_builds", 0)
                / n_blocks}

    def as_json(events):
        return [(c, event_to_json(e)) for c, e in events]

    def run_blocks(eng, count, select=None, acc=None, per_block=None):
        """Push ``count`` blocks of the rotation, each followed by a drain,
        and return the events; ``select`` cuts the channels of each
        block; ``acc`` gathers the seconds of the pushes and drains;
        ``per_block`` gets each block's (events as JSON, noise floor)."""
        out = []
        for k in range(count):
            blk = blocks[k % rot]
            if select is not None:
                blk = blk[select]
            t0 = time.perf_counter()
            eng.push(blk)
            t1 = time.perf_counter()
            got = eng.drain_events()
            out.extend(got)
            if per_block is not None:
                per_block.append((as_json(got), float(eng.noise_floor_db)))
            if acc is not None:
                acc["push"] = acc.get("push", 0.0) + t1 - t0
                acc["drain"] = acc.get("drain", 0.0) \
                    + time.perf_counter() - t1
        return out

    def overflow(eng):
        st = eng.state
        got = {k: int(st[k].sum())
               for k in ("n_ring_ovf", "n_fsk_ovf", "n_pkg_drop")}
        got["n_pkg_dropped"] = eng.n_pkg_dropped
        if any(got.values()):
            fail(f"multichannel overflow or drops: {got}")
        return got

    bursts = n_bursts / rot * n_blocks
    floor = 1.5 * bursts * 0.8          # bench.py:297-300
    samples = channels * n * n_blocks
    workers = max(1, (os.cpu_count() or 1) - 1)

    real_time = garage.time
    garage.time = types.SimpleNamespace(monotonic=lambda: 0.0)
    try:
        # warm-up rotation: its compaction calls, and the last front-end
        # and detector calls, are recorded and held to the plain version
        # below
        eng = engine(channels)
        recorded, real_compact = [], eng._compact
        last = {}
        orig = {"frontend": fe.frontend_cuda,
                "detector_scan": det.detector_scan_cuda}

        def recording_compact(st):
            recorded.append([st[k].clone() for k in COMPACT_INS])
            return real_compact(st)

        def recorder(kind):
            def run(*args, **kw):
                last[kind] = ([a.clone() for a in args], kw)
                return orig[kind](*args, **kw)
            return run

        eng._compact = recording_compact
        fe.frontend_cuda = recorder("frontend")
        det.detector_scan_cuda = recorder("detector_scan")
        try:
            t = time.perf_counter()
            warm_blocks = []
            warm = run_blocks(eng, rot, per_block=warm_blocks)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t
        finally:
            eng._compact = real_compact
            fe.frontend_cuda = orig["frontend"]
            det.detector_scan_cuda = orig["detector_scan"]

        # the timed blocks: the main path of this phase
        acc = {}
        count_memo_builds(eng, acc)
        _cuda.reset_launches()
        inline, wall = timed_blocks(eng, acc)
        launches = {k: _cuda.LAUNCHES[k] for k in MC_KERNELS}
        for k, v in launches.items():
            if v <= 0:
                fail(f"kernel {k} was not launched on the multichannel path")
        ovf = overflow(eng)
        if len(inline) < floor:
            fail(f"multichannel: {len(inline)} events for {bursts:.0f} "
                 f"bursts (bench.py's floor: 1.5 x bursts x 0.8)")
        inline_json = as_json(inline)

        # the same engine on more blocks under torch.profiler
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced = run_blocks(eng, n_blocks)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        if len(traced) < floor:
            fail(f"multichannel traced run: {len(traced)} events")
        dgroups = profile_groups(prof)
        busy = sum(dgroups.values())
        del eng, prof, traced
        torch.cuda.empty_cache()

        # the last warm-up block's front-end and detector calls: two whole
        # channel groups of each against the plain version
        t = time.perf_counter()
        frontend_check_sampled(compare, *last["frontend"],
                               "multichannel warm-up, sampled channels")
        detector_check_sampled(compare, *last["detector_scan"],
                               "multichannel warm-up, sampled channels")
        shapes = {k: [list(a.shape) for a in v[0]] for k, v in last.items()}
        del last
        torch.cuda.empty_cache()
        sampled_s = time.perf_counter() - t

        # each compaction call of the warm-up against the plain version,
        # and the kernel's numbers at the last one (the main path's shape)
        n_calls = len(recorded)
        for i, ins in enumerate(recorded):
            compact_check(compare, ins, cap, f"multichannel warm-up call {i}")
        numbers = compact_measure(recorded[-1], cap)
        del recorded
        torch.cuda.empty_cache()

        # sampled channels, each alone through ShardedEngine(channels=1):
        # as many of each burst kind and rotation, and of the quiet ones,
        # spread over the channel range
        groups = {}
        for c in range(channels):
            groups.setdefault(burst_of(c, rot), []).append(c)
        per = n_sample // len(groups)
        sample = []
        for key, g in groups.items():
            k = per + (n_sample - per * len(groups) if key is None else 0)
            sample += g[::max(1, len(g) // k)][:k]
        sample.sort()
        cover = {burst_of(c, rot) for c in sample}
        if len(cover) != 2 * rot + 1:
            fail(f"the channel sample misses a burst kind or rotation: "
                 f"{sorted(cover, key=str)}")
        t = time.perf_counter()
        alone = Counter()
        for c in sample:
            e1 = engine(1)
            run_blocks(e1, rot, select=slice(c, c + 1))
            alone.update((c, j) for _, j in as_json(
                run_blocks(e1, n_blocks, select=slice(c, c + 1))))
        alone_s = time.perf_counter() - t
        in_sample = set(sample)
        picked = Counter(x for x in inline_json if x[0] in in_sample)
        if picked != alone or not picked:
            fail(f"multichannel: the sampled channels' events differ from "
                 f"their single-channel runs ({sum(picked.values())} vs "
                 f"{sum(alone.values())})")

        # a fresh engine on the forked decode pool: the inline events
        eng = engine(channels)
        eng.use_decode_pool(workers)
        pooled, pool_wall = pool_blocks(eng)
        if as_json(pooled) != inline_json:
            fail(f"multichannel: the pool's {len(pooled)} events differ "
                 f"from the inline run's {len(inline)}")
        pool_ovf = overflow(eng)
        del eng

        # the same blocks with the train memo and the decode cache cut to
        # one entry, inline and on the pool (whose forked workers build
        # their registries with the same cut): the same events, at the cost
        # of input whose trains the caches have not seen
        eng = engine(channels, cold=True)
        run_blocks(eng, rot)
        cold_acc = {}
        count_memo_builds(eng, cold_acc)
        cold, cold_wall = timed_blocks(eng, cold_acc)
        if as_json(cold) != inline_json:
            fail(f"multichannel: {len(cold)} events without the caches, "
                 f"{len(inline)} with them")
        cold_ovf = overflow(eng)
        del eng
        eng = engine(channels, cold=True)
        real_init = Registry.__init__

        def cold_init(self, *a, **k):
            real_init(self, *a, **k)
            no_cache(self)

        Registry.__init__ = cold_init
        try:
            eng.use_decode_pool(workers)
        finally:
            Registry.__init__ = real_init
        cold_pooled, cold_pool_wall = pool_blocks(eng)
        if as_json(cold_pooled) != inline_json:
            fail(f"multichannel: the pool's {len(cold_pooled)} events "
                 f"without the caches differ from the inline run's")
        overflow(eng)
        del eng

        # no cache, per drain: the train memo and the decode cache emptied
        # before every drain (no train of an earlier block is reused, as
        # with live input), so that a drain's prewarm can serve its own
        # packages. First the host path with its decode split, then device
        # slicing; one warm-up block each (banks, kernels), whose drain's
        # kernel calls are recorded in the device pass
        def per_drain(eng):
            reg, drain = eng.registry, eng.drain_events

            def fresh_drain(*a, **k):
                reg._train_cache.clear()
                reg._dec_cache.clear()
                return drain(*a, **k)
            eng.drain_events = fresh_drain
            return eng

        split_acc = {}
        with split_timers(split_acc):
            eng = per_drain(engine(channels))
            run_blocks(eng, 1)
            split_acc.clear()
            h_acc = {}
            count_memo_builds(eng, h_acc)
            fresh, fresh_wall = timed_blocks(eng, h_acc)
        if as_json(fresh) != inline_json:
            fail("multichannel: the per-drain no-cache host pass's events "
                 "differ")
        del eng
        ds_acc, spans, drain_calls, drain_dcalls = {}, [], [], []
        with split_timers(ds_acc), prewarm_timers(ds_acc), \
                kernel_timers(spans):
            eng = per_drain(engine(channels))
            eng.registry.device_slice = True
            with ds_recorder(drain_calls, drain_dcalls):
                run_blocks(eng, 1)
            torch.cuda.synchronize()
            ds_acc.clear()
            spans.clear()
            d_acc = {}
            count_memo_builds(eng, d_acc)
            _cuda.reset_launches()
            ds_ev, ds_wall = timed_blocks(eng, d_acc)
            ds_launches = {k: _cuda.LAUNCHES[k] for k in ds_kernel_names()}
            ds_pre = prewarm_ms(ds_acc, spans, n_blocks)
        if as_json(ds_ev) != inline_json:
            fail(f"multichannel: {len(ds_ev)} events with device slicing, "
                 f"{len(inline)} without")
        if d_acc.get("memo_builds", 0):
            fail(f"multichannel: device slicing left "
                 f"{d_acc['memo_builds']} trains to the host slicer")
        for k in ds_kernels:
            if ds_launches[k] <= 0:
                fail(f"kernel {k} was not launched on the multichannel "
                     f"device-slicing pass")
        ds_overflow = overflow(eng)
        del eng
        # the recorded drain's kernel calls: each against the plain version,
        # then timed (device, plain, library) at these shapes
        t = time.perf_counter()
        drain_lanes = {}
        drain_checked = ds_check(drain_calls, compare, "dense_4096 drain",
                                 drain_lanes)
        ds_numbers = ds_measure(drain_calls)
        ds_numbers_s = time.perf_counter() - t
        drain_decl = decl_measure(drain_dcalls, [
            c for c in drain_calls if c[0] == "decl_bank"], cpu=True)
        del drain_calls, drain_dcalls
        torch.cuda.empty_cache()
    finally:
        garage.time = real_time
    del blocks
    torch.cuda.empty_cache()
    row = {
        "phase": "multichannel", "channels": channels, "n": n,
        "rotations": rot, "blocks": n_blocks, "cap": cap,
        "bursts_per_block": n_bursts / rot, "build_blocks_s": build_s,
        "warmup_s": warm_s, "warmup_events": len(warm),
        "events": len(inline), "event_floor": floor, "wall_s": wall,
        **split(acc, wall),
        "launches": launches, "overflow": ovf,
        "sampled_kernel_checks": {"shapes": shapes, "bit_exact": True,
                                  "channels": 64, "seconds": sampled_s},
        "traced": {"wall_ms": traced_ms,
                   "device_ms_per_block": {k: v / n_blocks
                                           for k, v in dgroups.items()},
                   "device_busy_share": busy / traced_ms},
        "compact_calls_checked": n_calls,
        "sample": {"channels": len(sample),
                   "events": sum(picked.values()), "equal": True,
                   "seconds": alone_s},
        "pool": {"workers": workers, "events_equal_in_order": True,
                 "msps": samples / pool_wall / 1e6,
                 "ms_per_block": pool_wall / n_blocks * 1e3,
                 "gain": wall / pool_wall, "overflow": pool_ovf},
        "no_cache": {"events_equal_in_order": True, "overflow": cold_ovf,
                     **split(cold_acc, cold_wall),
                     "per_drain": {
                         "host": {**split(h_acc, fresh_wall),
                                  "split": split_ms(
                                      {**split_acc, "host_decode":
                                       h_acc["drain"] - h_acc["take"]},
                                      n_blocks, h_acc["packages"])},
                         "device_slice": {
                             "events_equal_in_order": True,
                             "overflow": ds_overflow,
                             **split(d_acc, ds_wall),
                             "host_memo_builds_per_block":
                                 d_acc.get("memo_builds", 0) / n_blocks,
                             "python_decode_ms_per_block":
                                 ds_acc.get("python", 0.0) / n_blocks * 1e3,
                             "decl_bank_ms_per_block":
                                 ds_acc.get("decl", 0.0) / n_blocks * 1e3,
                             **ds_pre, "launches": ds_launches,
                             "drain_calls_checked": drain_checked,
                             "drain_lanes": drain_lanes,
                             "drain_measure_s": ds_numbers_s,
                             "drain_decl": drain_decl}},
                     "pool": {"workers": workers,
                              "events_equal_in_order": True,
                              "msps": samples / cold_pool_wall / 1e6,
                              "ms_per_block":
                                  cold_pool_wall / n_blocks * 1e3,
                              "gain": cold_wall / cold_pool_wall}}}
    return (row, launches, numbers, ds_launches, ds_numbers, drain_decl,
            warm_blocks)


def timeshard_streams(fx, rate_of):
    """The phase's single-channel streams: (name, -R numbers or None for
    the default registration, cu8 samples [n, 2], sample rate)."""
    from rtl_433_tpu_torch.io import load_iq
    out = []
    for d, num, copies in STREAMS[:2]:
        cu8 = next(f[2] for f in fx if f[0] == d)
        out.append((d, [num], np.concatenate([load_iq(cu8, "cu8")] * copies),
                    rate_of(cu8)))
    for rate in (250_000, 1_024_000):
        files = [cu8 for _d, _n, cu8, _w in fx if rate_of(cu8) == rate]
        raw = b"".join(open(f, "rb").read() for f in files)
        out.append((f"mixed_{rate // 1000}k", None,
                    np.frombuffer(raw, np.uint8).reshape(-1, 2), rate))
    return out


def ts_recorder(calls):
    """Record every per-lane-origin front-end and detector call and every
    chain and gather call while the block runs (wrappers swapped in their
    modules, restored on exit)."""
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import frontend as fe
    from rtl_433_tpu_torch.ops import timeshard as ots

    def wrap(kind, fn, lanes_only):
        def run(*args, **kw):
            if not lanes_only or kw.get("lane_t0") is not None:
                calls.append((kind, [a.clone() for a in args],
                              {k: v.clone() if hasattr(v, "clone") else v
                               for k, v in kw.items()}))
            return fn(*args, **kw)
        return run
    return patched(
        (fe, "frontend_cuda", wrap("frontend", fe.frontend_cuda, True)),
        (det, "detector_scan_cuda",
         wrap("detector_scan", det.detector_scan_cuda, True)),
        (ots, "timeshard_chain_cuda",
         wrap("timeshard_chain", ots.timeshard_chain_cuda, False)),
        (ots, "timeshard_gather_cuda",
         wrap("timeshard_gather", ots.timeshard_gather_cuda, False)))


def ts_check(calls, compare, what):
    """Each recorded call rerun on the card and held to its plain version
    on the same inputs. Returns the calls checked by kernel."""
    import torch
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import frontend as fe
    from rtl_433_tpu_torch.ops import timeshard as ots
    fns = {"frontend": (fe.frontend_cuda, fe.frontend_plain, FE_OUTS),
           "detector_scan": (det.detector_scan_cuda, det.detector_scan_plain,
                             DET_OUTS),
           "timeshard_chain": (ots.timeshard_chain_cuda,
                               ots.timeshard_chain_plain, CHAIN_OUTS),
           "timeshard_gather": (ots.timeshard_gather_cuda,
                                ots.timeshard_gather_plain, GATHER_OUTS)}
    checked = {}
    for i, (kind, args, kw) in enumerate(calls):
        kernel, plain, names = fns[kind]
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        compare(kind, got, plain(*args, **kw), names, f"{what}, call {i}")
        checked[kind] = checked.get(kind, 0) + 1
    return checked


def ts_measure(picks):
    """The chain's and the gather's device time (queued behind a spinning
    card), plain time and bound at one recorded call of each (``picks``:
    segments -> kernel -> (args, kw); each kernel's call at the most
    segments that recorded one), and for the gather the library's time:
    index_select of the selected lanes' rows and torch.where for the
    rebase. The bound counts the bytes the function needs: the selected
    candidates' registers or logs read once (a third of the candidate
    tensors), the other inputs read once, the outputs written once."""
    import torch
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import timeshard as ots
    pick = {}
    for D in sorted(picks):
        pick.update(picks[D])
    for k in ("timeshard_chain", "timeshard_gather"):
        if k not in pick:
            fail(f"timeshard: no recorded {k} call to time")
    out = {}
    args, kw = pick["timeshard_chain"]
    start, fin, rowinfo = args
    D = kw["D"]
    C = start.shape[1] // D
    nbytes = 4 * (start.numel() + fin.numel() // 3 + rowinfo.numel()
                  + 2 * D * C + start.shape[0] * C + D)
    out["timeshard_chain"] = {
        "ms": cuda_ms(lambda: ots.timeshard_chain_cuda(*args, **kw), reps=20,
                      busy_first=True),
        "plain_ms": host_ms(lambda: ots.timeshard_chain_plain(*args, **kw)),
        "library_ms": None, "bound_ms": nbytes / HBM_BPS * 1e3,
        "bytes": nbytes, "shape": {"start": list(start.shape),
                                   "fin": list(fin.shape), "D": D}}
    args, kw = pick["timeshard_gather"]
    key3, p3, g3, eop3, sel, delta = args
    R = kw["R"]
    D, C = sel.shape
    G = key3.shape[1]
    logs = key3.numel() + p3.numel() + g3.numel() + eop3.numel()
    nbytes = 4 * (2 * logs // 3 + 2 * D * C)
    lanes = ((sel.long() * D + torch.arange(D, device=sel.device)[:, None])
             * C + torch.arange(C, device=sel.device)[None]).reshape(-1)
    drep = (delta.reshape(-1).repeat_interleave(R)[:, None]
            * (1 << det.KEY_IDX_BITS)).expand(D * C * R, G)
    egen = torch.zeros_like(eop3[:D * C])
    egen[:, :, det.M_GEN] = delta.reshape(-1, 1)

    def library():
        k = key3.view(3 * D * C, R, G).index_select(0, lanes).view(-1, G)
        torch.where(k < det.KEY_INVALID, k + drep, k)
        p3.view(3 * D * C, R, G).index_select(0, lanes)
        g3.view(3 * D * C, R, G).index_select(0, lanes)
        e = eop3.index_select(0, lanes)
        torch.where(e[:, :, det.M_TYPE:det.M_TYPE + 1] != det.PKG_NONE,
                    e + egen, e)

    out["timeshard_gather"] = {
        "ms": cuda_ms(lambda: ots.timeshard_gather_cuda(*args, **kw),
                      reps=20, busy_first=True),
        "plain_ms": host_ms(lambda: ots.timeshard_gather_plain(*args, **kw)),
        "library_ms": cuda_ms(library, reps=20, busy_first=True),
        "bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes,
        "shape": {"key3": list(key3.shape), "eop3": list(eop3.shape),
                  "D": D}}
    return out


def ts_reasons(params, mesh, blocks, dev):
    """Why blocks fall back: the time-shard step with its per-link,
    per-key failure flags on every block, each from the sequential
    engine's true state. Returns the links, the failed ones, those that
    failed on low_est/high_est alone, the keys that fail most, and the
    wall ms per block of the time-shard step alone (with debug, which runs
    a failed block to the end) and of the sequential step (process_block)
    on the same blocks, each synchronised."""
    from collections import Counter

    import torch
    from rtl_433_tpu_torch.dsp.engine import detector_init, process_block
    from rtl_433_tpu_torch.ops.timeshard import verify_layout
    from rtl_433_tpu_torch.parallel import timeshard as pts
    names, _ = verify_layout(*pts._verify_keys(params), pts._COUNTER_KEYS)
    steps = {f: pts.timeshard_process_block(params, mesh, flush=f,
                                            debug=True)
             for f in (False, True)}
    st = detector_init(params, 1, dev)
    links = failed = hedge = 0
    step_s = seq_s = 0.0
    keys = Counter()
    for blk, nv, flush in blocks:
        x = torch.from_numpy(blk).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        flags = steps[flush](st, x, nv)[3].cpu()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, _ = process_block(params, st, x, nv, flush=flush)
        torch.cuda.synchronize()
        step_s += t1 - t
        seq_s += time.perf_counter() - t1
        for row in flags:
            links += 1
            if row.any():
                failed += 1
                bad = {names[k] for k in range(len(names)) if row[k]}
                keys.update(bad)
                hedge += bad <= {"low_est", "high_est"}
    nb = len(blocks)
    return {"links": links, "failed_links": failed,
            "failed_on_low_high_only": hedge,
            "failed_links_by_key": dict(keys.most_common(8)),
            "step_ms_per_block": step_s / nb * 1e3,
            "sequential_step_ms_per_block": seq_s / nb * 1e3}


def timeshard_phase(dev, compare, fx, rate_of):
    """Phase 6c: the single-channel streams through TimeShardEngine on
    Mesh([cuda] * D) and, in the same call, through the one-channel
    ShardedEngine: equal events, fallbacks, wall ms per block of both, and
    under torch.profiler the device ms per block of both by kernel. Every
    per-lane-origin front-end and detector call and every chain and gather
    call of TS_CHECKED's decode is held to its plain version. Returns (the
    phase lines, the launches of the time-sharded decodes, the chain's and
    gather's numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rtl_433_tpu_torch.decoders import Registry
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from rtl_433_tpu_torch.parallel.sharding import Mesh, ShardedEngine
    from rtl_433_tpu_torch.parallel.timeshard import TimeShardEngine

    def registry(nums):
        reg = Registry()
        if nums is None:
            reg.register_all()
        for n in nums or ():
            reg.register(n)
        return reg

    def drive(eng, blocks):
        """Push and drain every block; (events as JSON, wall seconds)."""
        out = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for blk, nv, flush in blocks:
            eng.push(blk, n_valid=nv, flush=flush)
            out.extend(eng.drain_events())
        torch.cuda.synchronize()
        return ([(c, event_to_json(e)) for c, e in out],
                time.perf_counter() - t)

    def traced(mk, blocks):
        """A fresh engine over ``blocks`` under torch.profiler: (events,
        wall ms per block, device ms per block by kernel, busy share)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            evs, wall = drive(mk(), blocks)
        groups = profile_groups(prof)
        nb = len(blocks)
        return evs, {
            "blocks": nb, "wall_ms_per_block": wall / nb * 1e3,
            "device_ms_per_block": {k: v / nb for k, v in groups.items()},
            "device_ms_per_block_total": sum(groups.values()) / nb,
            "device_busy_share": sum(groups.values()) / (wall * 1e3)}

    rows = []
    launches = {k: 0 for k in TS_KERNELS}
    picks = {}
    for name, nums, samples, rate in timeshard_streams(fx, rate_of):
        reg = registry(nums)
        params = DetectorParams(
            sample_rate=rate, fsk_minmax=False,
            enable_fm=any(d.is_fsk for d in reg.active), pkg_cap=32)
        n = samples.shape[0]
        blocks = []
        for pos in range(0, n, N_BLOCK):
            blk = samples[pos:pos + N_BLOCK]
            nv = blk.shape[0]
            blk = np.pad(blk, ((0, N_BLOCK - nv), (0, 0)),
                         constant_values=128)[None]
            blocks.append((blk, nv, pos + N_BLOCK >= n))
        nb = len(blocks)
        seq_mesh = Mesh([dev], ("ch",), (1,))
        seq = lambda: ShardedEngine(params, 1, seq_mesh,
                                    registry=registry(nums))
        want, seq_s = drive(seq(), blocks)
        if not want:
            fail(f"timeshard {name}: the sequential engine decoded no "
                 f"events")
        # the profiler's cost grows with the ops it records: trace the
        # first TS_TRACED blocks of each engine
        short = blocks[:TS_TRACED]
        seq_evs, seq_traced = traced(seq, short)
        row = {"phase": "timeshard", "stream": name, "samples": n,
               "blocks": nb, "sample_rate": rate,
               "sequential": {"events": len(want),
                              "wall_ms_per_block": seq_s / nb * 1e3,
                              "traced": seq_traced},
               "segments": {}}
        for D in TS_SEGMENTS:
            ts_mesh = Mesh([dev] * D, ("sp",), (D,))
            ts = lambda: TimeShardEngine(params, 1, ts_mesh,
                                         registry=registry(nums))
            _cuda.reset_launches()
            eng = ts()
            got, ts_s = drive(eng, blocks)
            # this run's own launches, read before any other run; a block
            # that fails verification stops after the chain, so the gather
            # runs only where a block verified
            seg_launches = {k: _cuda.LAUNCHES[k] for k in TS_KERNELS}
            for k in TS_KERNELS:
                if seg_launches[k] <= 0 and (k != "timeshard_gather"
                                             or eng.verified):
                    fail(f"kernel {k} was not launched on timeshard {name} "
                         f"D={D}")
                launches[k] += seg_launches[k]
            if got != want:
                fail(f"timeshard {name} D={D}: {len(got)} events, the "
                     f"sequential engine {len(want)}")
            if eng.fallbacks + eng.verified != nb:
                fail(f"timeshard {name} D={D}: {eng.verified} verified + "
                     f"{eng.fallbacks} fallbacks != {nb} blocks")
            evs, ts_traced = traced(ts, short)
            if evs != seq_evs:
                fail(f"traced timeshard {name} D={D}: events differ from "
                     f"the traced sequential engine's")
            seg = {"events": len(got), "events_equal": True,
                   "fallbacks": eng.fallbacks, "verified": eng.verified,
                   "wall_ms_per_block": ts_s / nb * 1e3,
                   "launches": seg_launches,
                   "traced": ts_traced,
                   "why": ts_reasons(params, ts_mesh, blocks, dev)}
            if name == TS_CHECKED:
                # every kernel call of one more decode, held to the plain
                # versions on its inputs
                rec = []
                with ts_recorder(rec):
                    if drive(ts(), blocks)[0] != want:
                        fail(f"timeshard {name} D={D}: the recorded decode "
                             f"differs")
                t = time.perf_counter()
                seg["checked"] = ts_check(rec, compare,
                                          f"timeshard {name} D={D}")
                seg["check_seconds"] = time.perf_counter() - t
                # each kernel's first call at the most segments it ran at
                for call in rec:
                    picks.setdefault(D, {}).setdefault(call[0], call[1:])
                del rec
            row["segments"][str(D)] = seg
        rows.append(row)
    for k in TS_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the timeshard phase")
    return rows, launches, ts_measure(picks)


def _mh_worker(rank, files, port, out, device):
    """One process of the multihost phase: MultiHostEngine on ``device``
    over its rows of the rotation blocks (``files``), once compared and
    once timed; writes its events, noise floors and times to ``out``."""
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch
    import torch.distributed as dist
    from rtl_433_tpu_torch.decoders import Registry, garage
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from rtl_433_tpu_torch.parallel import multihost
    garage.time = types.SimpleNamespace(monotonic=lambda: 0.0)
    multihost.initialize(f"127.0.0.1:{port}", MH_PROCS, rank)
    try:
        dev = torch.device(device)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        blocks = [torch.from_numpy(np.load(f)).to(dev) for f in files]
        # the multichannel phase's configuration (bench.py:195-201)
        params = DetectorParams(sample_rate=250_000, fsk_minmax=False,
                                enable_fm=True, chunk=128, ring=8, eops=2,
                                arena=65536)
        reg = Registry()
        reg.register_all()
        eng = multihost.MultiHostEngine(params, blocks[0].shape[0],
                                        registry=reg, pkg_cap_total=MC_CAP,
                                        devices=[dev])
        reduce_s = []
        real = dist.all_reduce

        def timed_reduce(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                reduce_s.append(time.perf_counter() - t)
        dist.all_reduce = timed_reduce
        per_block, walls = [], []
        _cuda.reset_launches()
        for blk in blocks:
            sync()
            t = time.perf_counter()
            eng.push(blk)
            ev = eng.local_events()
            sync()
            walls.append(time.perf_counter() - t)
            per_block.append(([(c, event_to_json(e)) for c, e in ev],
                              eng.noise_floor_db))
        launches = {k: _cuda.LAUNCHES[k]
                    for k in ("frontend", "detector_scan", "compact")}
        # the rotation again: its trains hit the train memo and decode
        # cache, as the multichannel phase's timed blocks do
        sync()
        t = time.perf_counter()
        for blk in blocks:
            eng.push(blk)
            eng.local_events()
        sync()
        cached_s = time.perf_counter() - t
        with open(out, "w") as f:
            json.dump({"rank": rank, "channels": blocks[0].shape[0],
                       "per_block": per_block,
                       "wall_ms_per_block": [w * 1e3 for w in walls],
                       "cached_wall_ms_per_block":
                           cached_s / len(blocks) * 1e3,
                       "all_reduce_ms": [x * 1e3 for x in reduce_s],
                       "launches": launches,
                       "n_pkg_dropped": eng.n_pkg_dropped}, f)
    finally:
        dist.destroy_process_group()


def multihost_phase(dev, mh_dir, warm_blocks):
    """Phase 6d: MH_PROCS processes on cuda:0 (gloo on loopback), each
    with its rows of the multichannel phase's rotation blocks through
    MultiHostEngine. Per block, their events in process order must equal
    the multichannel warm-up's one-process events, and every process's
    all-reduced noise floor the one-process floor within 1e-4 dB."""
    import multiprocessing
    import socket
    rot = len(warm_blocks)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(mh_dir, f"w{p}.json") for p in range(MH_PROCS)]
    procs = [ctx.Process(target=_mh_worker, args=(
        p, [os.path.join(mh_dir, f"r{r}_p{p}.npy") for r in range(rot)],
        port, outs[p], str(dev))) for p in range(MH_PROCS)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t
    for i, p in enumerate(procs):
        if p.exitcode != 0:
            fail(f"multihost: process {i} exited with {p.exitcode}")
    res = [json.load(open(o)) for o in outs]
    worst = 0.0
    for r, (want, noise) in enumerate(warm_blocks):
        got = [tuple(e) for w in res for e in w["per_block"][r][0]]
        if got != [tuple(e) for e in want]:
            fail(f"multihost: block {r}: {len(got)} events from "
                 f"{MH_PROCS} processes, one process {len(want)}")
        for w in res:
            worst = max(worst, abs(w["per_block"][r][1] - noise))
    if worst >= 1e-4:
        fail(f"multihost: noise floor {worst} dB from the one-process one")
    for w in res:
        if dev.type == "cuda" and min(w["launches"].values()) <= 0:
            fail(f"multihost: process {w['rank']} launched "
                 f"{w['launches']}")
    reduce_ms = [x for w in res for x in w["all_reduce_ms"]]
    return {"phase": "multihost", "processes": MH_PROCS,
            "channels_per_process": res[0]["channels"],
            "blocks": rot, "events": sum(len(w) for w, _ in warm_blocks),
            "events_equal": True, "noise_max_abs_diff_db": worst,
            "wall_ms_per_block": {w["rank"]: w["wall_ms_per_block"]
                                  for w in res},
            "cached_wall_ms_per_block": {
                w["rank"]: w["cached_wall_ms_per_block"] for w in res},
            "all_reduce_ms": {"calls": len(reduce_ms),
                              "mean": sum(reduce_ms) / len(reduce_ms),
                              "max": max(reduce_ms)},
            "launches": {w["rank"]: w["launches"] for w in res},
            "n_pkg_dropped": sum(w["n_pkg_dropped"] for w in res),
            "processes_wall_s": wall}


def main():
    if not os.path.isdir(os.path.join(HERE, "rtl_433_tpu_torch")):
        print("chip_smoke: run me from the root of a checkout (the "
              "rtl_433_tpu_torch package is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this "
              "script measures the GPU and has nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from rtl_433_tpu_torch.api import RtlTpu
    from rtl_433_tpu_torch.decoders import base as dbase
    from rtl_433_tpu_torch.decoders import declarative
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.dsp.engine import DetectorParams, detector_init
    from rtl_433_tpu_torch.ops import _cuda, _native
    from rtl_433_tpu_torch.pulse import native_slicers
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import frontend as fe
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from torch_fixture_cases import cases as fixture_cases
    from torch_fixture_cases import expected, normalize
    from torch_fixture_cases import sample_rate as rate_of
    from torch_scan_cases import CASES

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    kinds = {}
    errs = {}

    def compare(kind, got, want, names, what):
        """Largest |kernel - plain| over the outputs, into errs[kind] and
        returned; any difference fails the run."""
        worst = 0
        for g, w_, nm in zip(got, want, names):
            if g.shape != w_.shape:
                fail(f"{kind} {nm}: shape {tuple(g.shape)} != "
                     f"{tuple(w_.shape)} ({what})")
            e = int((g.to(torch.int64) - w_.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            errs[kind] = max(errs.get(kind, 0), e)
            worst = max(worst, e)
            if e:
                fail(f"{kind} {nm} differs from the plain version by up to "
                     f"{e} ({what})")
        return worst

    def decode(nums, path, device="cuda", device_slice=False):
        """-R <n> for each of ``nums``; None: the default registration."""
        rx = RtlTpu(device=device, register_all=nums is None,
                    report_time="off", device_slice=device_slice)
        for n in nums or ():
            rx.registry.register(n)
        return [normalize(json.loads(event_to_json(e)))
                for e in rx.decode_file(path)]

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build
    t = time.perf_counter()
    took = _cuda.build()
    for k in _cuda.LAUNCHERS:
        _cuda.launcher(k)
    t_host = time.perf_counter()
    try:
        slicer_lib = _native.build()
        native_slicers.available()
    except RuntimeError as e:
        fail(f"the slicer library did not build: {e}")
    slicer_s = time.perf_counter() - t_host
    t_host = time.perf_counter()
    get_runner()
    runner_s = time.perf_counter() - t_host
    ptxas = {}
    for k in _cuda.SOURCES:
        log = os.path.join(_cuda.BUILD_DIR, f"{k}.log")
        if os.path.exists(log):
            ptxas[k] = [ln.strip() for ln in open(log)
                        if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": ptxas, "slicer_lib": os.path.basename(slicer_lib),
          "slicer_lib_s": round(slicer_s, 3),
          "decl_runner_s": round(runner_s, 3)})

    # ---- 3. frontend kernel vs plain
    C = 8
    iq_np = rng.integers(0, 256, size=(C, N_BLOCK, 2), dtype=np.uint8)
    st_np = rng.integers(-100, 100, size=(6, C)).astype(np.int32)
    st_np[4:] = rng.integers(-128, 128, size=(2, C))
    iq = torch.from_numpy(iq_np).to(dev)
    st = torch.from_numpy(st_np).to(dev)
    # (use_mag_est, enable_fm, n_valid, sample rate, minmax coefficients)
    cases = [(m, f, N_BLOCK, 250_000, False)
             for m in (False, True) for f in (True, False)]
    cases += [(False, True, 100_003, 250_000, False),
              (False, True, N_BLOCK, 1_024_000, False),
              (False, True, N_BLOCK, 1_024_000, True)]
    errs["frontend"] = 0
    for mag, fm_on, nv, rate, mm in cases:
        alp1, blp = fe._coeffs(rate, fm_on, 0.0, mm)
        kw = dict(use_mag_est=mag, enable_fm=fm_on, alp1=alp1, blp=blp,
                  n_valid=nv)
        got = fe.frontend_cuda(iq, st, **kw)
        torch.cuda.synchronize()
        want = fe.frontend_plain(iq, st, **kw)
        compare("frontend", got, want, FE_OUTS,
                f"mag_est={mag}, fm={fm_on}, n_valid={nv}, rate={rate}")
    times = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alp1, blp = fe._coeffs(250_000, True, 0.0, False)
    kw = dict(use_mag_est=False, enable_fm=True, alp1=alp1, blp=blp,
              n_valid=N_BLOCK)
    for Ct in (1, 4096):
        x = torch.randint(0, 256, (Ct, N_BLOCK, 2), dtype=torch.uint8,
                          device=dev, generator=gen)
        s = torch.zeros((6, Ct), dtype=torch.int32, device=dev)
        times[Ct] = cuda_ms(lambda: fe.frontend_cuda(x, s, **kw))
        if Ct == 1:
            mhz = sm_clock_mhz(lambda: fe.frontend_cuda(x, s, **kw))
            plain_ms = host_ms(lambda: fe.frontend_plain(x, s, **kw))
        del x, s
    torch.cuda.empty_cache()
    kinds["frontend"] = dict(
        ms=times[1], ms_c4096=times[4096], plain_ms=plain_ms, mhz=mhz,
        bytes=N_BLOCK * (2 + 2 + 2) + 6 * 4 * 2 + 4,
        ops=N_BLOCK * FRONTEND_OPS)
    emit({"phase": "frontend", "cases": len(cases),
          "max_abs_err": errs["frontend"], "ms_c1": times[1],
          "ms_c4096": times[4096], "plain_ms_c1": plain_ms,
          "sm_clock_mhz_c1": mhz, "n": N_BLOCK})

    # ---- 4. detector kernel vs plain, on real bursts, FM on and off
    C = 4
    iq_np = np.stack([synth_iq(rng, N_BLOCK) for _ in range(C)])
    iq = torch.from_numpy(iq_np).to(dev)
    errs["detector_scan"] = 0
    n_rec = {}
    for fm_on in (True, False):
        for minmax in (False, True):
            tag = f"{'minmax' if minmax else 'classic'}_fm_{'on' if fm_on else 'off'}"
            p = DetectorParams(fsk_minmax=minmax, enable_fm=fm_on, pkg_cap=32)
            state = detector_init(p, C, dev)
            am, fm, state, _ = fe.frontend(iq, state, sample_rate=250_000,
                                           enable_fm=fm_on, fsk_minmax=minmax,
                                           time_major=True)
            regs = det.pack_regs(state)
            gen0 = state["gen"].clone()
            got = det.detector_scan_cuda(am, fm, regs, gen0, params=p)
            torch.cuda.synchronize()
            want = det.detector_scan_plain(am, fm, regs, gen0, params=p)
            compare("detector_scan", got, want, DET_OUTS, tag)
            eops = got[4][:, :, 0]
            n_rec[tag] = {
                "records": int((got[1] < det.KEY_INVALID).sum()),
                "ook_eops": int((eops == det.PKG_OOK).sum()),
                "fsk_eops": int((eops == det.PKG_FSK).sum())}
            if not n_rec[tag]["ook_eops"] or (fm_on and
                                              not n_rec[tag]["fsk_eops"]):
                fail(f"detector test signal produced too few packages "
                     f"({tag}): {n_rec[tag]}")
    edge = {}
    for case_name, build in CASES.items():
        case = build(N_BLOCK)
        args = [case[k].to(dev) for k in ("am", "fm", "regs", "gen0")]
        kw = dict(params=case["params"], n_valid=case["n_valid"])
        got = det.detector_scan_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = det.detector_scan_plain(*args, **kw)
        compare("detector_scan", got, want, DET_OUTS,
                f"edge case {case_name}")
        G = N_BLOCK // case["params"].chunk
        edge[case_name] = {"c": int(args[0].shape[1]),
                           "quiet_share": float(got[5].float().mean()) / G}
    p = DetectorParams(pkg_cap=32)
    times = {}
    for Ct in (1, 4096):
        x = iq[torch.arange(Ct, device=dev) % C].contiguous()
        state = detector_init(p, Ct, dev)
        am, fm, state, _ = fe.frontend(x, state, sample_rate=250_000,
                                       fsk_minmax=False, time_major=True)
        del x
        regs = det.pack_regs(state)
        gen0 = state["gen"].clone()
        times[Ct] = cuda_ms(lambda: det.detector_scan_cuda(
            am, fm, regs, gen0, params=p), reps=3)
        if Ct == 1:
            mhz = sm_clock_mhz(lambda: det.detector_scan_cuda(
                am, fm, regs, gen0, params=p))
            plain_ms = host_ms(lambda: det.detector_scan_plain(
                am, fm, regs, gen0, params=p))
            q1 = int(det.detector_scan_cuda(am, fm, regs, gen0,
                                            params=p)[5][0])
        else:
            detector_check_sampled(compare, (am, fm, regs, gen0),
                                   {"params": p}, "C=4096, sampled channels")
        del am, fm, regs
        torch.cuda.empty_cache()
    G = N_BLOCK // p.chunk
    kinds["detector_scan"] = dict(
        ms=times[1], ms_c4096=times[4096], plain_ms=plain_ms, mhz=mhz,
        bytes=N_BLOCK * (2 + 2) + G * (3 * p.ring + p.eops * 9) * 4
        + 2 * det.NREG * 4 + 4,
        ops=N_BLOCK * DETECTOR_OPS)
    emit({"phase": "detector", "c": C, "n": N_BLOCK,
          "max_abs_err": errs["detector_scan"], "records": n_rec,
          "edge_cases": edge, "ms_c1": times[1], "ms_c4096": times[4096],
          "quiet_share_c1": q1 / G, "plain_ms_c1": plain_ms,
          "sm_clock_mhz_c1": mhz, "sampled_c4096": 64})

    # ---- 4b. compaction kernel vs plain: ragged states at bench.py's widths
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def compact_state(active):
        """out_n over 0..12 (beyond S=8) on a share ``active`` of the
        channels; pulse and gap over 0..2^31, meta over all of int32."""
        C_, S_, P_ = MC_CHANNELS, 8, 1200
        on = torch.rand(C_, device=dev, generator=gen) < active
        out_n = (torch.randint(0, 13, (C_,), device=dev, generator=gen)
                 * on).to(torch.int32)
        rnd = lambda lo, *sh: torch.randint(
            lo, (1 << 31) - 1, sh, device=dev, generator=gen,
            dtype=torch.int64).to(torch.int32)
        return [out_n, rnd(0, C_, S_, P_), rnd(0, C_, S_, P_),
                rnd(-(1 << 31), C_, S_, 9)]

    errs["compact"] = 0
    states = {"sparse": compact_state(0.02), "dense": compact_state(1.0)}
    totals = {k: int(v[0].clamp(0, 8).sum()) for k, v in states.items()}
    if not (totals["sparse"] < 768 and totals["dense"] > 2048):
        fail(f"compaction states do not straddle the caps: {totals}")
    for kind, ins in states.items():
        if int((ins[3].abs() > (1 << 24)).sum()) == 0:
            fail("compaction meta has no value above 2^24")
        for cap in (768, 2048):
            compact_check(compare, ins, cap, f"{kind} state, cap={cap}")
    ctimes = {f"dense_cap{cap}": compact_measure(states["dense"], cap)
              for cap in (768, 2048)}
    del states
    torch.cuda.empty_cache()
    emit({"phase": "compact", "c": MC_CHANNELS, "s": 8, "p": 1200,
          "totals": totals, "max_abs_err": errs["compact"],
          "bit_exact": True, "times": ctimes})

    # ---- 4c. slice: kernel A (nine families) and kernels B and C against
    # their plain versions on fuzz trains (tests/torch_slice_cases.py), at
    # the bank's caps and at caps that flag most lanes; B and C on the
    # slicer outputs and on planes with planted repeats
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, SMALL_CAPS, dup_planes,
                                   family_devices, family_trains, pack)
    fuzz, fuzz_calls = {}, {}
    for i, fam in enumerate(sl.FAMILIES):
        devs = family_devices(fam)
        bounds = getattr(sl, f"{fam}_bounds")(devs, 250_000)
        args = [torch.from_numpy(a).to(dev) for a in
                pack(family_trains(fam, devs, SEED + i, n=48))]
        for cname, caps in (("bank", BANK_CAPS[fam]), ("small", SMALL_CAPS)):
            calls = [("slice", (fam, *args, bounds, caps))]
            ds_check(calls, compare, f"fuzz, {cname} caps")
            got = sl.slice_cuda(fam, *args, bounds, caps)
            calls = [("content_dup", ({k: got[k] for k in SLICE_OUTS[:4]},)),
                     ("gather_records", (got["bytes"], got["syncs"], *(
                         rng.integers(0, n, 64).astype(np.int32)
                         for n in got["num_rows"].shape)))]
            ds_check(calls, compare, f"{fam} fuzz output, {cname} caps")
            fuzz[f"{fam}/{cname}"] = {
                "lanes": got["ovf"].numel(), "flagged": int(got["ovf"].sum()),
                "events": int(got["n_events"].sum())}
            if cname == "bank":
                # timed later with the bound table on the card, as the bank
                # keeps it
                tab = torch.from_numpy(sl.bound_table(fam, bounds)).to(dev)
                fuzz_calls[fam] = [("slice", (fam, *args, tab, caps))]
    planted = {k: torch.from_numpy(v).to(dev) for k, v in
               dup_planes(SEED, B=5, J=7, E=8, R=6, W=20).items()}
    ds_check([("content_dup", (planted,))], compare, "planted repeats")
    repeats = int((ddp._content_dup(planted).cpu()
                   != torch.arange(8, dtype=torch.int32)).sum())
    if not repeats:
        fail("the planted repeats were not found")
    emit({"phase": "slice", "bit_exact": True, "families": fuzz,
          "planted_repeats_found": repeats,
          "max_abs_err": {k: errs[k] for k in ds_kernel_names()
                          if k != "decl_bank"}})

    # ---- 4d. decl_bank: the declarative bank's kernel against its plain
    # version on a fuzz batch that reaches every stage, at the bank's widths
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from torch_decl_cases import fuzz_batch
    bank = get_runner().bank
    fz = fuzz_batch(SEED, DECL_FUZZ)
    fz_args = [torch.from_numpy(a).to(dev) for a in fz[:3]]
    fz_ns = torch.from_numpy(fz[3]).to(dev)
    decl_fuzz_call = [("decl_bank", (bank, *fz_args, fz_ns))]
    ds_check(decl_fuzz_call, compare, "fuzz batch, stale bits")
    zeroed = fz_args[0] * (torch.arange(bank.in_bits, device=dev)[None, :]
                           < fz_args[1][:, None])
    ds_check([("decl_bank", (bank, zeroed, *fz_args[1:], None))], compare,
             "fuzz batch, rows zeroed at n")
    code = dbk.run_torch(bank, *fz_args, fz_ns)[0].cpu().numpy()
    decl_fuzz = ds_measure(decl_fuzz_call)["decl_bank"]
    emit({"phase": "decl_bank", "candidates": DECL_FUZZ,
          "specs": int(np.unique(fz[2]).size),
          "widths": {"in_bits": bank.in_bits, "frame_bits": bank.frame_bits,
                     "pat_len": bank.pat_len, "n_checks": bank.n_checks,
                     "n_raws": bank.n_raws},
          "codes": {str(c): int((code == c).sum())
                    for c in np.unique(code)},
          "stale_rows": int((fz[3] > fz[1]).sum()),
          "bit_exact": True, "max_abs_err": errs["decl_bank"],
          **{k: decl_fuzz[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")}})
    del fz, fz_args, fz_ns, zeroed, decl_fuzz_call

    # ---- 4e. mic: the twelve digests through their entry points
    mic_line, mic_rows = mic_phase(dev, compare, rng)
    emit(mic_line)

    # ---- 5. main path: every fixture through RtlTpu on the card
    fx = [(d, nums, cu8, expected(cu8)) for d, nums, cu8 in fixture_cases()]
    if len(fx) < 106:
        fail(f"only {len(fx)} fixtures in tests/fixtures/")
    by_rate = {}
    for _d, _n, cu8, _w in fx:
        by_rate[rate_of(cu8)] = by_rate.get(rate_of(cu8), 0) + 1

    current = [None]

    def decode_fixtures():
        for d, nums, cu8, want in fx:
            current[0] = (d, rate_of(cu8))
            got = decode(nums, cu8)
            if got != want:
                fail(f"fixture {d}: {got} != {want}")

    _cuda.reset_launches()
    t = time.perf_counter()
    decode_fixtures()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = {k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS}
    emit({"phase": "main", "fixtures": len(fx), "by_rate": by_rate,
          "all_match": True, "seconds": round(main_s, 3),
          "launches": launches})
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # ---- 5b. each kernel against its plain version on the exact inputs the
    # main path gives it: the fixtures are decoded again with the wrappers'
    # arguments recorded, then every recorded call is rerun both ways
    calls = []
    orig = {"frontend": fe.frontend_cuda, "detector_scan":
            det.detector_scan_cuda}

    def recorder(kind):
        def run(*args, **kw):
            calls.append((kind, current[0], [a.clone() for a in args], kw))
            return orig[kind](*args, **kw)
        return run

    fe.frontend_cuda = recorder("frontend")
    det.detector_scan_cuda = recorder("detector_scan")
    try:
        decode_fixtures()
    finally:
        fe.frontend_cuda = orig["frontend"]
        det.detector_scan_cuda = orig["detector_scan"]
    plain = {"frontend": (fe.frontend_plain, FE_OUTS),
             "detector_scan": (det.detector_scan_plain, DET_OUTS)}
    # kernel x sample rate x FM on/off -> calls, largest error, quiet chunks
    groups = {}
    while calls:
        kind, (d, rate), args, kw = calls.pop(0)
        got = orig[kind](*args, **kw)
        torch.cuda.synchronize()
        fn, names = plain[kind]
        e = compare(kind, got, fn(*args, **kw), names,
                    f"main-path call, fixture {d}, {kw}")
        fm_on = kw["enable_fm"] if kind == "frontend" else \
            kw["params"].enable_fm
        g = groups.setdefault(
            f"{kind}/{rate // 1000}k/fm_{'on' if fm_on else 'off'}",
            {"calls": 0, "max_abs_err": 0, "quiet": 0, "chunks": 0})
        g["calls"] += 1
        g["max_abs_err"] = max(g["max_abs_err"], e)
        if kind == "detector_scan":
            g["quiet"] += int(got[5].sum())
            g["chunks"] += got[5].numel() * (args[0].shape[0]
                                             // kw["params"].chunk)
        del got, args
    for g in groups.values():
        chunks = g.pop("chunks")
        q = g.pop("quiet")
        if chunks:
            g["quiet_share"] = q / chunks
    emit({"phase": "main_inputs",
          "calls": sum(g["calls"] for g in groups.values()),
          "bit_exact": True,
          "max_abs_err": {k: errs[k] for k in orig},
          "by_kernel_rate_fm": dict(sorted(groups.items()))})

    # ---- 5c. the fixtures again, with device slicing: every drain's trains
    # sliced by the kernels, the same committed events; then every kernel
    # call those decodes made against its plain version, on its inputs
    ds_paths = {}
    decl_paths = {}
    fx_calls, fx_dcalls = [], []
    _cuda.reset_launches()
    t = time.perf_counter()
    for d, nums, cu8, want in fx:
        calls = []
        with ds_recorder(calls, fx_dcalls):
            got = decode(nums, cu8, device_slice=True)
        if got != want:
            fail(f"fixture {d} with device slicing: {got} != {want}")
        fx_calls.append((d, calls))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    ds_paths["fixtures"] = {k: _cuda.LAUNCHES[k] for k in ds_kernel_names()}
    for k, v in ds_paths["fixtures"].items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the fixtures with device "
                 f"slicing")
    t = time.perf_counter()
    fx_checked, fx_flagged = {}, {}
    for d, calls in fx_calls:
        for k, v in ds_check(calls, compare, f"fixture {d} with device "
                             f"slicing", fx_flagged).items():
            fx_checked[k] = fx_checked.get(k, 0) + v
    if any(fx_checked.get(k, 0) < v for k, v in ds_paths["fixtures"].items()):
        fail(f"the fixtures' checked kernel calls {fx_checked} are fewer "
             f"than their launches {ds_paths['fixtures']}")
    check_s = time.perf_counter() - t
    decl_paths["fixtures"] = decl_measure(
        fx_dcalls, [c for _d, calls in fx_calls for c in calls
                    if c[0] == "decl_bank"])
    del fx_calls, fx_dcalls, calls
    emit({"phase": "main_device_slice", "fixtures": len(fx),
          "all_match": True, "seconds": round(decode_s, 3),
          "launches": ds_paths["fixtures"], "checked": fx_checked,
          "bit_exact": True, "lanes": fx_flagged,
          "check_seconds": round(check_s, 3),
          "decl": decl_paths["fixtures"]})

    # ---- 6. stream: fixtures concatenated, decoded untraced and traced
    from torch.profiler import ProfilerActivity, profile
    from rtl_433_tpu_torch.decoders import garage

    def run_stream(name, nums, path, n, want, extra=None, untraced=None):
        """Decode ``path`` on the card untraced, then traced; both must give
        ``want``. Returns the stream's line, with what ``untraced()``
        returns right after the untraced decode."""
        blocks = -(-n // N_BLOCK)
        _cuda.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = decode(nums, path)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        if got != want:
            fail(f"stream {name}: {len(got)} events, want {len(want)}")
        for k in REPLAY_KERNELS:
            if _cuda.LAUNCHES[k] <= 0:
                fail(f"kernel {k} was not launched on stream {name}")
        row = {"phase": "stream", "fixture": name, "samples": n,
               "blocks": blocks, "events": len(got), "seconds": s,
               "msps": n / s / 1e6, "ms_per_block": s / blocks * 1e3,
               "launches": {k: _cuda.LAUNCHES[k] for k in MC_KERNELS},
               **(extra or {}),
               **(untraced() if untraced else {})}
        # the same decode under torch.profiler: device time by kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            got = decode(nums, path)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t) * 1e3
        if got != want:
            fail(f"traced stream {name}: {len(got)} events")
        groups = profile_groups(prof)
        busy = sum(groups.values())
        row["traced"] = {
            "wall_ms": traced_ms,
            "device_ms_per_block": {k: v / blocks for k, v in groups.items()},
            "device_busy_share": busy / traced_ms if busy else None}
        return row

    def dispatch_timers(acc):
        """Time the package decode and count the two dispatch paths."""
        R = dbase.Registry
        return patched(
            (RtlTpu, "_handle_package",
             timed(acc, "host_decode", RtlTpu._handle_package)),
            (R, "_run_fast", timed(acc, "run_fast", R._run_fast)),
            (R, "_run_host", timed(acc, "run_host", R._run_host)))

    def mixed_stream(rate, host_path):
        """Every fixture at ``rate`` concatenated, decoded on the CPU (the
        reference), then on the card: untraced and traced (run_stream),
        once more with the host decode split, and, if ``host_path``, on
        the per-decoder host path. All decodes must give the same events;
        the card's default decodes must take _run_fast for every
        package."""
        name = f"mixed_{rate // 1000}k"
        files = [cu8 for _d, _n, cu8, _w in fx if rate_of(cu8) == rate]
        raw = b"".join(open(cu8, "rb").read() for cu8 in files)
        path = os.path.join(tmp, f"mixed_433.92M_{rate // 1000}k.cu8")
        with open(path, "wb") as f:
            f.write(raw)
        n = len(raw) // 2
        blocks = -(-n // N_BLOCK)
        t = time.perf_counter()
        want = decode(None, path, device="cpu")
        cpu_s = time.perf_counter() - t
        if not want:
            fail(f"{name} decoded no events")
        acc = {}
        with dispatch_timers(acc):
            row = run_stream(
                name, None, path, n, want,
                {"fixtures": len(files), "cpu_decode_s": cpu_s},
                untraced=lambda: {"packages": acc.get("n_host_decode", 0),
                                  "host_decode_s": acc["host_decode"],
                                  "run_fast_calls": acc.get("n_run_fast", 0),
                                  "run_host_calls": acc.get("n_run_host", 0)})
        if row["run_host_calls"] or \
                row["run_fast_calls"] != row["packages"]:
            fail(f"{name}: the default path took _run_host or skipped "
                 f"_run_fast ({row['run_fast_calls']} fast, "
                 f"{row['run_host_calls']} host, {row['packages']} "
                 f"packages)")
        # host time in RtlTpu._handle_package (run_ook_demods /
        # run_fsk_demods and the package's RSSI) of the untraced decode
        row["host_decode_ms_per_block"] = \
            row["host_decode_s"] / blocks * 1e3
        row["host_decode_share"] = row["host_decode_s"] / row["seconds"]
        # the split, from a third decode with every part timed
        acc = {}
        with dispatch_timers(acc), split_timers(acc):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = decode(None, path)
            torch.cuda.synchronize()
            split_s = time.perf_counter() - t
        if got != want:
            fail(f"{name}: the split decode differs")
        row["split"] = {"wall_ms_per_block": split_s / blocks * 1e3,
                        **split_ms(acc, blocks)}
        # the default path's per-train declarative batches (NumPy), each
        # once more with the bank on the card
        tcalls = []
        with ds_recorder([], host_calls=tcalls):
            if decode(None, path) != want:
                fail(f"{name}: the recorded default decode differs")
        row["per_train_decl"] = per_train_decl(
            tcalls, compare, f"{name} per-train batches")
        del tcalls
        # the same file with device slicing (RtlTpu(device_slice=True)):
        # the same events, no train left to the host slicer, and the
        # prewarm's split: the kernels' device ms, the host part of
        # batch_slice, the memo plans, the record freeze
        acc, spans = {}, []
        _cuda.reset_launches()
        with dispatch_timers(acc), split_timers(acc), prewarm_timers(acc), \
                kernel_timers(spans):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = decode(None, path, device_slice=True)
            torch.cuda.synchronize()
            ds_s = time.perf_counter() - t
        launches = {k: _cuda.LAUNCHES[k] for k in ds_kernel_names()}
        if got != want:
            fail(f"{name}: the device-slicing decode differs")
        if acc.get("n_memo", 0) or acc.get("n_run_host", 0):
            fail(f"{name}: device slicing left {acc.get('n_memo', 0)} "
                 f"trains to the host slicer")
        for k in default_ds_kernels:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on {name} with device "
                     f"slicing")
        ms = lambda k: acc.get(k, 0.0) / blocks * 1e3
        row["device_slice"] = {
            "seconds": ds_s, "msps": n / ds_s / 1e6,
            "ms_per_block": ds_s / blocks * 1e3,
            "host_decode_ms_per_block": ms("host_decode"),
            "python_decode_ms_per_block": ms("python"),
            "decl_bank_ms_per_block": ms("decl"),
            "host_memo_builds": acc.get("n_memo", 0),
            **prewarm_ms(acc, spans, blocks), "launches": launches}
        ds_paths[name] = launches
        # every kernel call of one more such decode against the plain
        # version, on the inputs this stream gives it
        calls, dcalls = [], []
        _cuda.reset_launches()
        with ds_recorder(calls, dcalls):
            if decode(None, path, device_slice=True) != want:
                fail(f"{name}: the recorded device-slicing decode differs")
        recorded = {k: _cuda.LAUNCHES[k] for k in ds_kernel_names()}
        t = time.perf_counter()
        flagged = {}
        checked = ds_check(calls, compare, f"{name} drain", flagged)
        if any(checked.get(k, 0) < v for k, v in recorded.items()):
            fail(f"{name}: the checked kernel calls {checked} are fewer "
                 f"than the decode's launches {recorded}")
        check_s = time.perf_counter() - t
        decl_paths[name] = decl_measure(
            dcalls, [c for c in calls if c[0] == "decl_bank"])
        emit({"phase": "slice_inputs", "stream": name,
              "calls_recorded": len(calls), "checked": checked,
              "bit_exact": True, "lanes": flagged,
              "check_seconds": round(check_s, 3),
              "decl": decl_paths[name]})
        del calls, dcalls
        if host_path:
            acc = {}
            no_native = (dbase.Registry, "_use_native", lambda self: False)
            with dispatch_timers(acc), patched(no_native):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = decode(None, path)
                torch.cuda.synchronize()
                host_s = time.perf_counter() - t
            if got != want:
                fail(f"{name}: the host path's events differ")
            if acc.get("n_run_fast", 0) or not acc.get("n_run_host", 0):
                fail(f"{name}: the forced host path took _run_fast")
            row["host_path"] = {
                "seconds": host_s, "msps": n / host_s / 1e6,
                "ms_per_block": host_s / blocks * 1e3,
                "host_decode_ms_per_block": acc["host_decode"] / blocks
                * 1e3,
                "run_host_calls": acc["n_run_host"]}
        os.remove(path)
        return row

    # the kernels the default registration runs with device slicing (no
    # default spec is NRZS)
    reg = dbase.Registry()
    reg.register_all()
    default_ds_kernels = [f"slice_{f}" for f, mods in ddp._FAM_MODS.items()
                          if any(d.modulation in mods and d.decode_fn
                                 for d in reg.active)]
    default_ds_kernels += ["content_dup", "gather_records", "decl_bank"]
    del reg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for d, num, copies in STREAMS:
            _, _, cu8, want = next(f for f in fx if f[0] == d)
            raw = open(cu8, "rb").read()
            path = os.path.join(tmp, os.path.basename(cu8))
            with open(path, "wb") as f:
                f.write(raw * copies)
            emit(run_stream(d, [num], path, len(raw) * copies // 2,
                            want * copies, {"copies": copies}))
            os.remove(path)

        # mixed_250k and mixed_1024k: every fixture at one rate, in sorted
        # order, under the default registration. The Security+ decoders
        # pair the halves of a code within 0.8 s of time.monotonic(), which
        # would make the result depend on how fast this host decodes the
        # packages in between: every decode runs on one fixed clock.
        real_time = garage.time
        garage.time = types.SimpleNamespace(monotonic=lambda: 0.0)
        try:
            for rate in (250_000, 1_024_000):
                emit(mixed_stream(rate, host_path=rate == 250_000))
        finally:
            garage.time = real_time
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 6b. multichannel: bench.py's workload through ShardedEngine
    from rtl_433_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    if mesh.size != 1:
        fail(f"the multichannel phase wants one card, the mesh has "
             f"{mesh.size}")
    mh_dir = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    try:
        (row, mc_launches, kinds["compact"], ds_paths["dense_4096"],
         ds_numbers, decl_paths["dense_4096"], warm_blocks) = multichannel(
             dev, mesh, compare, default_ds_kernels, mh_dir)
        emit(row)

        # ---- 6c. timeshard: one channel's blocks split over time, on the
        # fixed Security+ clock of the mixed streams
        real_time = garage.time
        garage.time = types.SimpleNamespace(monotonic=lambda: 0.0)
        try:
            ts_rows, ts_launches, ts_numbers = timeshard_phase(
                dev, compare, fx, rate_of)
        finally:
            garage.time = real_time
        for r in ts_rows:
            emit(r)

        # ---- 6d. multihost: MH_PROCS processes over the multichannel
        # phase's blocks
        emit(multihost_phase(dev, mh_dir, warm_blocks))
        del warm_blocks
    finally:
        shutil.rmtree(mh_dir, ignore_errors=True)

    # ---- 7. kernels
    meta = {
        "frontend": ("rtl_433_tpu_torch/csrc/frontend.cu",
                     "rtl_433_tpu/ops/frontend.py:90"),
        "detector_scan": ("rtl_433_tpu_torch/csrc/detector.cu",
                          "rtl_433_tpu/dsp/engine.py:1040"),
    }
    rows = []
    for k, (src, rep) in meta.items():
        m = kinds[k]
        # bytes and ops are per channel: the bound at C channels scales by C
        bytes_ms = m["bytes"] / HBM_BPS * 1e3
        ops_ms = m["ops"] / INT32_OPS * 1e3
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[k], "max_abs_err": errs[k],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "sm_clock_mhz": m["mhz"],
            "cycles_per_sample": m["ms"] * 1e-3 * m["mhz"] * 1e6 / N_BLOCK,
            "ms_c4096": m["ms_c4096"],
            "bound_ms_c4096": 4096 * max(bytes_ms, ops_ms),
            "launches_multichannel": mc_launches[k],
            "launches_timeshard": ts_launches[k],
            "shape": [1, N_BLOCK]})
    m = kinds["compact"]
    rows.append({
        "name": "compact", "route": "cuda",
        "source": "rtl_433_tpu_torch/csrc/compact.cu",
        "replaces": "rtl_433_tpu/dsp/engine.py:1307",
        "launches": mc_launches["compact"], "max_abs_err": errs["compact"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": "bytes", "library_ms": m["library_ms"],
        "call_ms": m["call_ms"], "library_call_ms": m["library_call_ms"],
        "rows": m["rows"], "count": m["count"],
        "dense_cap768_ms": ctimes["dense_cap768"]["ms"],
        "dense_cap2048_ms": ctimes["dense_cap2048"]["ms"],
        "dense_cap2048_bound_ms": ctimes["dense_cap2048"]["bound_ms"],
        "shape": [MC_CHANNELS, 8, 1200, MC_CAP]})
    launches["compact"] = mc_launches["compact"]
    # device slicing's kernels: launches on its paths (the fixtures,
    # mixed_250k and mixed_1024k, the dense_4096 per-drain pass), times at
    # the dense drain's calls (a family no default spec runs: at its fuzz
    # call)
    jax_lines = {"ppm": 185, "pwm": 248, "pcm": 497, "mc": 663, "dmc": 781,
                 "piwm_dc": 869, "nrzs": 989, "rzi": 1055, "osv1": 1115}
    missing = [k for k in ds_kernel_names() if k not in ds_numbers]
    for k in missing:
        if not k.startswith("slice_"):
            fail(f"kernel {k} has no call at the dense drain")
        m = ds_measure(fuzz_calls[k[len("slice_"):]])[k]
        ds_numbers[k] = dict(m, measured_at="fuzz trains, bank caps")
    for k in ds_kernel_names():
        m = ds_numbers[k]
        if k.startswith("slice_"):
            src = "rtl_433_tpu_torch/csrc/slice.cu"
            rep = f"rtl_433_tpu/ops/slice.py:{jax_lines[k[6:]]}"
        elif k == "decl_bank":
            src = "rtl_433_tpu_torch/csrc/decl_bank.cu"
            rep = "rtl_433_tpu/ops/decode_bank.py:334"
        else:
            src = "rtl_433_tpu_torch/csrc/dispatch.cu"
            rep = "rtl_433_tpu/decoders/device_dispatch.py:" + (
                "91" if k == "content_dup" else "80")
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[k] for p in ds_paths.values()),
            "launches_by_path": {p: v[k] for p, v in ds_paths.items()},
            "max_abs_err": errs[k], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "calls": m["calls"],
            "shapes": m["shapes"],
            "measured_at": m.get("measured_at", "dense_4096 drain")})
        if k == "decl_bank":
            rows[-1].update(
                fuzz={x: decl_fuzz[x] for x in ("ms", "plain_ms",
                                                "bound_ms", "bound_by")},
                fuzz_candidates=DECL_FUZZ, by_path=decl_paths)
    # the MIC digests: launches and times at the mic phase
    for k, m in mic_rows.items():
        rows.append({
            "name": k, "route": "cuda",
            "source": "rtl_433_tpu_torch/csrc/mic.cu",
            "replaces": f"rtl_433_tpu/ops/mic.py:{MIC_LINES[k[4:]]}",
            "launches": m["launches"], "max_abs_err": errs[k],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": m["shape"],
            "measured_at": "mic phase"})
    # the time-shard kernels: launches on the timeshard phase's decodes,
    # times at the first call of TS_CHECKED at the most segments that ran it
    for k, line in (("timeshard_chain", 189), ("timeshard_gather", 245)):
        m = ts_numbers[k]
        rows.append({
            "name": k, "route": "cuda",
            "source": "rtl_433_tpu_torch/csrc/timeshard.cu",
            "replaces": f"rtl_433_tpu/parallel/timeshard.py:{line}",
            "launches": ts_launches[k], "max_abs_err": errs[k],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": "bytes",
            "library_ms": m["library_ms"], "bytes": m["bytes"],
            "shape": m["shape"],
            "measured_at": f"{TS_CHECKED}, D={m['shape']['D']}"})
    emit({"kernel_launches": launches,
          "kernel_launches_multichannel": mc_launches,
          "kernel_launches_device_slice": ds_paths,
          "kernel_launches_timeshard": ts_launches,
          "kernel_launches_mic": {k: m["launches"]
                                  for k, m in mic_rows.items()}})
    emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rtl_433_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

(``python3 chip_smoke.py --mic-only`` runs phases 1 and 4e alone,
``--replay-cli-only`` phases 1 and 5d, ``--live-only`` phases 1 and 5e,
``--outputs-only`` phases 1 and 5f,
``--compact-only`` phase 1 and phase 4b's checks and times without the
profiler or the host split, and ``--timeshard-only`` phase 6c on
lacrosse_tx35 alone, against the rtl_433_tpu_torch package beside the
script: copied into an earlier checkout, each times that checkout's
kernels the same way; ``--timeshard-only`` needs a time-shard step that
launches the gather before it reads the chain's verdict, or, for one that
reads it first, pair_behind set to pair_host_read and the gather's copies
counted in ``_cuda.LAUNCHES["timeshard_gather_copied"]``.)

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
              the device activities of 20 calls under torch.profiler (one
              kernel each, or the run fails) and the wrapper's host time by
              part (checks, allocation, launch, the six views);
4c. slice -- device slicing's kernels against their plain versions,
              bit-exact on every plane of every lane: csrc/slice.cu for each
              of the nine slicer families on fuzz trains
              (tests/torch_slice_cases.py) at the bank's caps and at caps
              that flag most lanes, and csrc/dispatch.cu's content dedup
              and record gather on those outputs and on planes with
              planted repeats (also at odd shapes, rows of 13 bytes,
              5 rows, counts of -1 and R + 1, near repeats), and the
              gather once more over every family's output in one call;
4d. decl_bank -- the declarative decode bank's kernel (csrc/decl_bank.cu)
              against its plain version, bit-exact on code and raws, on a
              fuzz batch of 8192 candidates over all 77 specs
              (tests/torch_decl_cases.py: the oracle vectors' candidates,
              flipped, inverted and with stale stored bits; planted
              preambles, Manchester rows, n from 0 to 512), also
              against the sparse evaluation's plain emulation; the sparse
              tables' size; its device time, the plain version's and the
              bound;
4e. mic   -- each of the twelve MIC digests (csrc/mic.cu) at 65536 rows,
              with the nbytes/poly/key cases of tests/test_mic_kernels.py,
              uint8 and int32 rows, bit-exact against the plain version and
              against bits/util.py on a sample of rows; through the entry
              points with the launch counts set to 0 before and read after;
              device time, plain time, bound; then each digest's largest
              case at 2^22 rows of 16 bytes (made on the card from the
              seed, freed after), bit-exact the same way, timed, with its
              bound (MIC_OPS, the least table-driven work per byte; the
              bit-serial kernel's count beside it) and the share of it
              reached;
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
5d. replay_cli -- the port's CLI (cli.main in this process, stdout and
              stderr captured, the API's clock pinned by
              tests/torch_replay_cases.py) on the card, each run byte for
              byte and exit code equal to the same argv with --device cpu:
              a -X flex decoder made from the timings of nexus (OOK_PPM),
              lacrosse_tx141x (OOK_PWM) and lacrosse_tx35 (FSK_PCM) alone
              (-R 0) on its capture, on the default path and with -Y
              deviceslice (the same output); three conf files (-c) beside
              -R <protocol> with device slicing (the protocol's committed
              events among the output); nexus as SigMF (io/sigmf.py's
              writer) and as .ook pulse text (PulseData.dump of the
              replay's packages), each with the .cu8 replay's events; and
              one run each of -F csv, log, jsons, null, -M level/protocol/
              time:unix:usec:utc, -M stats:1, -C si, -v and -vvv. The
              launch counts are set to 0 before the card's runs and read
              after them (the front end, the detector, the PPM, PWM and
              PCM slicers, the dedup, the gather and the bank must each
              launch), then every device-slicing kernel call of those runs
              is held to its plain version;
5e. live   -- live input on the card, RtlTpu.run_live (default
              registration, the Security+ clock pinned) against a loopback
              rtl_tcp server thread (tests/torch_live_cases.py) that paces
              whole 131072-sample blocks to a wall-clock schedule:
              live_1024k (mixed_1024k's samples, then a quiet block, at
              1.024 MS/s, real time) and live_250k (mixed_250k's, at 1.024
              MS/s, four times its rate), each with no block dropped, every
              block received, the events (time removed) equal to the card's
              decode_file of the same samples and one front-end and one
              detector launch a block; per run push_block's wall per block
              (median, max, the first), the device span of process_block
              (CUDA events around it), the consumer's busy share of the 128
              ms period, the ring's highest fill; live_flat (mixed_250k as
              fast as loopback carries it): the consumer's MS/s and the
              drops. A cold start: one run_live in a fresh process (the
              kernels built) against a 1.024 MS/s server: the one-time
              loads run_live does before it connects, its first block's
              wall and drops. Then the CLI (cli.main in this process, clock
              pinned), each run equal to the same argv with --device cpu:
              -d over a stream of 7 blocks with -F rtltcp (the bytes a
              passthrough client reads too), every -w format with FM off
              (a capture whose envelope reaches 32768) and on, with -S all,
              and a .sr session (its members);
5f. outputs -- the network outputs, -K and -A on the card, against
              loopback stubs (tests/torch_output_cases.py: a UDP syslog
              receiver, an MQTT broker, an Influx HTTP collector, a gpsd
              line server with one fixed TPV, a WebSocket reader of
              /ws), the clocks pinned (the API's, the output modules',
              the Security+ clock): outputs_cli replays nexus,
              lacrosse_tx35, mixed_250k (default registration) and nexus
              with -Y deviceslice through -F syslog, mqtt (retained,
              events/devices/states topics), influx, trigger, http, -K
              FILE, -K gpsd and -F json, each equal to --device cpu in
              exit code, stdout, stderr and every byte each stub received
              (device_info, which names the receiver's device, aside), the
              device-slicing kernel calls held to plain; analyzer runs -A
              on a capture of each branch of the modulation guess the
              fixtures reach (ANALYZER_FIXTURES), stderr equal to --device
              cpu's; http_retune_live runs the CLI's -d with -F http
              against 7 blocks of mixed_1024k at 1.024 MS/s (watchdog
              ticks at 60 s), the server paused after block 3 until a
              POST /cmd center_frequency 868000000, sent while block 3 is
              in flight, is answered (the receiver's lock holds it for
              the block; the next blocks run the minmax FSK tracker):
              events, WebSocket frames and server commands equal to
              --device cpu's, no drop, one front-end and one detector
              launch a block, the round trip, the first block's wall
              after the retune and a second client's settings reply;
              live_sinks runs live_250k's stream at 1.024 MS/s through
              run_live with every network sink and two taggers attached
              and with -F json alone: the same events, push_block's wall
              and busy share, no drop;
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
              the drain; the gather's span holds its wait on the chain and
              its launches behind a failed chain, which return early, so
              beside it its time after the chain (gather_own_ms_per_block)
              and its launches and those that copied; the total and the
              busy share count the union of the spans); every
              per-lane-origin front-end and
              detector call and every chain and gather call of one more
              lacrosse_tx35 decode held to its plain version (a gather
              behind a failed chain: no output written);
6d. multihost -- two processes on the one card (gloo on loopback), each
              with 2048 channels of the rotation blocks through
              MultiHostEngine: per block, their events in process order
              equal the multichannel warm-up's one-process events, and
              their all-reduced noise floor its noise floor within 1e-4
              dB; each process's wall ms per block, cold and cached, and
              the all-reduce's ms; every compaction call of one more
              rotation held to the plain version in each process;
7. kernels -- one line per kernel with its launches on the main path, its
              largest error against the plain version over every check
              above, its times and bound, and its cycles per sample at
              C=1 at the SM clock that nvidia-smi read while the same
              launch ran back to back (sm_clock_mhz). The front end and the
              detector are timed at C=1, the shape of file replay, and at
              C=4096, with their launches on the replay_cli, live and outputs
              phases beside; compaction at the multichannel phase's real state;
              the device-slicing kernels (slice_<family>, content_dup,
              gather_records) with their launches on the device-slicing
              paths (replay_cli's among them) and their times summed over
              every one of one dense_4096 drain's calls (NRZS, which no default spec runs,
              at its fuzz call), and per path (fixtures, mixed_250k,
              mixed_1024k, the dense_4096 drain) their device ms summed
              over every recorded call of that path (ms_by_path beside
              calls_by_path, launches_by_path and us_per_call_by_path),
              each beside the floor of any launch (launch_floor_ms, the
              chain's); the gather also with its launches per dense_4096
              drain and per prewarm on every path (a prewarm that makes
              more than three fails the run); the time-shard
              chain
              and gather with their launches on the timeshard phase and
              their times at its first lacrosse_tx35 call at the most
              segments that made one (the gather's first that copied:
              the gather is launched behind every chain and writes
              nothing where the chain failed, so it has launches and
              launches that copied, by D), the chain also at each D with
              its launches by D, beside the device time of a one-element
              fill queued the same way (launch_floor_ms), the gather
              back to back as plain launches (ms, the kernel alone) and
              in the path's launch form (pdl_ms), and behind such a fill
              in either form (behind_fill_ms, behind_fill_pdl_ms),
              beside index_select and torch.where and with the device
              span of chain and gather as the step enqueues them, on a
              block that verified (pair_ms) and on one that failed
              (skip_ms), each also with the gather as a plain launch
              (*_plain_ms), with the host's read of the verdict between
              the launches (*_host_read_ms) and beside the same span of
              the chain alone (*_chain_ms); the declarative bank
              with its launches on the device-slicing paths, timed at the
              dense_4096 drain's batch and at the fuzz batch; each MIC
              digest with its launches and times at the mic phase (both
              batches); compaction and each digest beside the floor of
              any launch (launch_floor_ms).

Every phase line carries its seconds. Before the kernels line, a
"processes" line names the child processes still live after the phases
(multiprocessing's resource tracker, which 6d's spawn starts, and nothing
else is expected): the script is the subreaper of every process it starts,
and stops and reaps each of them there and again when it exits, however it
exits. The line before the last is nvidia-smi's name and power limit; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import shutil
import signal
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


def become_subreaper():
    """Make this process the reaper of every orphan among its descendants
    (Linux prctl PR_SET_CHILD_SUBREAPER), so that stop_children finds a
    process that a child left behind."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def own_children():
    """{pid: state} of this process's children, live or not yet reaped,
    read from /proc."""
    me, kids = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # state and ppid follow the command name's closing parenthesis
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me:
            kids[int(d)] = state
    return kids


def reap():
    """Collect the exit status of every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children(wait_s=5.0):
    """Stop and reap every child of this process: multiprocessing's resource
    tracker is closed (it ends when its pipe does; it ignores SIGTERM), any
    other child gets SIGTERM, then SIGKILL after ``wait_s``; orphans that
    reach this subreaper meanwhile are stopped the same way. Returns the
    pids of the children that were live when it was called."""
    live = sorted(p for p, st in own_children().items() if st != "Z")
    from multiprocessing import resource_tracker
    rt = getattr(resource_tracker, "_resource_tracker", None)
    if rt is not None and getattr(rt, "_fd", None) is not None:
        try:
            os.close(rt._fd)
        except OSError:
            pass
        rt._fd = rt._pid = None
    for sig in (signal.SIGTERM, signal.SIGKILL):
        end = time.monotonic() + wait_s
        sent = set()
        while True:
            reap()
            kids = own_children()
            if not kids or time.monotonic() > end:
                break
            for pid in set(kids) - sent:
                try:
                    os.kill(pid, sig)
                except ProcessLookupError:
                    pass
                sent.add(pid)
            time.sleep(0.02)
        if not kids:
            break
    reap()
    return live


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


def device_spans(prof):
    """(kernel group, start us, end us) of every device event of a
    torch.profiler run."""
    from torch.autograd import DeviceType
    return [(group_of(e.name), e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and e.time_range.end > e.time_range.start]


def union_ms(spans):
    """Milliseconds of the union of ``spans``' intervals: the time in which
    at least one of them ran, overlaps counted once."""
    total, end = 0.0, -math.inf
    for _, a, b in sorted(spans, key=lambda x: x[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


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


@contextlib.contextmanager
def prewarm_gathers(counts):
    """Append to ``counts`` the gather launches that each
    Registry.prewarm_trains call makes (its passes: the MIC gates'
    representatives of each side and the drain-wide freeze); a prewarm
    that makes more than three fails the run."""
    from rtl_433_tpu_torch.decoders import base as dbase
    from rtl_433_tpu_torch.ops import _cuda
    real = dbase.Registry.prewarm_trains

    def run(self, *a, **k):
        before = _cuda.LAUNCHES["gather_records"]
        try:
            return real(self, *a, **k)
        finally:
            counts.append(_cuda.LAUNCHES["gather_records"] - before)
            if counts[-1] > 3:
                fail(f"a prewarm made {counts[-1]} gather launches")
    with patched((dbase.Registry, "prewarm_trains", run)):
        yield


def gathers_per_prewarm(counts):
    """The gather launches per prewarm of one path: prewarms, those that
    launched, launches, their mean over the prewarms that launched, the
    most."""
    hit = [c for c in counts if c]
    return {"prewarms": len(counts), "prewarms_that_gathered": len(hit),
            "launches": sum(counts),
            "mean": sum(hit) / len(hit) if hit else 0.0,
            "max": max(counts, default=0)}


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
# its rates pass, DMC's and PIWM-DC's are per symbol, two per pulse; RZI's
# its segmented scan's adds and selects, OSV1's its OR-scan's)
SLICE_OPS = {"ppm": 30, "pwm": 36, "pcm": 90, "mc": 40, "dmc": 36,
             "piwm_dc": 26, "nrzs": 16, "rzi": 56, "osv1": 54}


def osv1_steps(pulse, gap, npl, bounds):
    """The pulses OSV1's lanes of a call need, summed over its lanes: a
    lane's steps end at the first pulse that leaves phases 0-2 (a failed
    preamble pulse, pulse 11 without its break, a failed sync at 12, the
    flush), where the kernel's CTA may stop; 0 for a spec that is not
    ok."""
    from rtl_433_tpu_torch.ops import slice as sl
    cols = bounds if isinstance(bounds, dict) \
        else sl.table_columns("osv1", bounds)
    K = 12
    n = npl.cpu().numpy().astype(np.int64)
    M = max(pulse.shape[1], K + 1)
    p = np.zeros((len(n), 1, M), np.int64)
    g = np.zeros_like(p)
    p[:, 0, :pulse.shape[1]] = pulse.cpu().numpy()
    g[:, 0, :pulse.shape[1]] = gap.cpu().numpy()
    sh = np.asarray(cols["short"], np.int64)[None, :, None]
    rst = np.asarray(cols["reset"], np.int64)[None, :, None]
    hmin, hmax = sh >> 1, (3 * sh) >> 1
    i = np.arange(M)
    pass0 = (p > hmin) & (g > hmin)
    done = np.broadcast_to((g > rst) | (i == n[:, None, None] - 1),
                           pass0.shape).copy()
    done[..., :K - 1] = ~(pass0 & (g <= hmax))[..., :K - 1]
    done[..., K - 1] = ~(pass0 & (g > hmax))[..., K - 1]
    done[..., K] = ~((p >= 2 * hmax) & (g >= 2 * hmax))[..., K]
    first = np.where(done.any(-1), done.argmax(-1) + 1, M)
    steps = np.minimum(first, n[:, None])
    return int((steps * np.asarray(cols["ok"], bool)[None, :]).sum())


def pcm_split(calls):
    """PCM's recorded calls timed whole and in two cuts (device ms summed
    over the calls, cuda_ms_all): with every spec's ok cleared, so that
    the rate pass runs on every lane while the step tiles find no active
    pulse (the rate pass, the empty tiles and the write-out), and with
    every train empty (the launch and the write-out alone). Their
    difference over the whole's less the write-out bounds the rate pass's
    share from above."""
    import torch
    from rtl_433_tpu_torch.ops import slice as sl
    whole, no_ok, empty = [], [], []
    for kind, args in calls:
        if kind != "slice" or args[0] != "pcm":
            continue
        fam, pulse, gap, npl, bounds, caps = args
        tab = bounds if isinstance(bounds, torch.Tensor) else \
            torch.from_numpy(sl.bound_table(fam, bounds)).to(pulse.device)
        off = tab.clone()
        off[:, -1] = 0
        zero = torch.zeros_like(npl)
        whole.append(lambda a=(pulse, gap, npl, tab, caps):
                     sl.slice_cuda("pcm", *a))
        no_ok.append(lambda a=(pulse, gap, npl, off, caps):
                     sl.slice_cuda("pcm", *a))
        empty.append(lambda a=(pulse, gap, zero, tab, caps):
                     sl.slice_cuda("pcm", *a))
    ms = {k: cuda_ms_all(v) for k, v in (("whole_ms", whole),
                                         ("ok_cleared_ms", no_ok),
                                         ("empty_trains_ms", empty))}
    ms["calls"] = len(whole)
    ms["rate_pass_share_at_most"] = (
        (ms["ok_cleared_ms"] - ms["empty_trains_ms"])
        / max(ms["whole_ms"] - ms["empty_trains_ms"], 1e-9))
    return ms


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
                               ddp._gather_many)
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

    def rec_gather(groups):
        groups = [(by, sy, *(np.array(a) for a in idx))
                  for by, sy, *idx in groups]
        calls.append(("gather_records", (groups,)))
        return gather(groups)

    with patched((sl, "slice_cuda", rec_slice), (ddp, "_content_dup", rec_dup),
                 (ddp, "_gather_many", rec_gather),
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
    groups, = args
    dev = groups[0][0].device
    return ("gather_records", lambda: ddp._gather_many(groups),
            lambda: ddp._gather_many_plain(groups),
            lambda o: [torch.as_tensor(x).to(dev) for pair in o
                       for x in pair],
            tuple(f"{k}[{f}]" for f in range(len(groups))
                  for k in ("bytes", "syncs")))


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
    are those this call's trains need (lane steps x specs; OSV1's lanes
    end early)."""
    if kind == "slice":
        from rtl_433_tpu_torch.ops import slice as sl
        fam, pulse, _gap, npl, bounds, caps = args
        B, N = pulse.shape
        S = len(bounds["ok"]) if isinstance(bounds, dict) else bounds.shape[0]
        E, R, BY = caps
        nbytes = 8 * B * N + 4 * B + 4 * 12 * S \
            + B * S * (E * R * BY + 8 * E * R + 4 * E + 5)
        if fam == "osv1":
            steps = osv1_steps(pulse, _gap, npl, bounds)
        else:
            steps = S * int(npl.sum()) * (
                2 if fam in sl.SYMBOL_FAMILIES else 1)
        return nbytes, SLICE_OPS[fam] * steps, [B, N, S, E, R, BY]
    if kind == "content_dup":
        planes, = args
        nbytes = dup_live_bytes(planes)
        return nbytes, nbytes, list(planes["bytes"].shape)
    if kind == "decl_bank":
        return decl_cost(*args)
    # the batched gather: each record's bytes and syncs read and written
    # once, its (family, b, j, e) and each family's table row read once
    groups, = args
    nbytes = 80 * len(groups)
    for by, _sy, bs, _js, _es in groups:
        R, W = by.shape[3:]
        nbytes += len(bs) * (2 * (R * W + 4 * R) + 16)
    return nbytes, 0, [len(groups), sum(len(g[2]) for g in groups)]


def dup_all_plane_bytes(planes):
    """content_dup's bytes counted as every plane of every event read once
    and dup written once (the bound of PRs 6-11: "all planes")."""
    return planes["bytes"].numel() + 4 * (
        planes["num_rows"].numel() * 2 + planes["bits_per_row"].numel()
        + planes["syncs"].numel())


def dup_live_bytes(planes):
    """The bytes content_dup must move: every count read and every dup
    written (4 bytes each), and the live prefix of each event that shares
    its count with another event of its lane, read once: its rows below
    the clamped count, W bytes and a bit count and a sync each. The
    operations are one compare per byte read."""
    import torch
    nr = planes["num_rows"]
    R, W = planes["bytes"].shape[-2:]
    shared = (nr[..., :, None] == nr[..., None, :]).sum(-1) > 1
    rows = nr.clamp(0, R).to(torch.int64)
    return 8 * nr.numel() + int((rows * shared).sum()) * (W + 8)


def ds_timed(kind, args):
    """A recorded call as it is timed: (kernel name, the kernel call, the
    library call or None). The gather is timed at its launcher alone (the
    wrapper's table upload and the copy of the result to the host would
    end each call with a sync), every family of the call in its one
    launch; the library call is index_select of each family's kept
    records' bytes and syncs."""
    import torch
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from rtl_433_tpu_torch.ops import _cuda
    name, kern, _plain, _outs, _names = ds_fns(kind, args)
    if kind != "gather_records":
        return name, kern, None
    groups = ddp._gather_groups(args[0])
    meta, out, P, _parts, keep = ddp._gather_plan(groups)
    a = (meta.data_ptr(), len(groups), P, out.data_ptr(),
         _cuda.stream_of(out))
    # the default arguments keep the buffers the launch reads and writes
    kern = (lambda fn=_cuda.launcher("gather_records"), a=a,
            keep=(meta, out, keep): fn(*a))
    lib = []
    for by, sy, bs, js, es in groups:
        B, J, E, R, W = by.shape
        flat = torch.from_numpy((bs * J + js) * E + es).to(by.device)
        lib.append((by.reshape(B * J * E, R * W), sy.reshape(B * J * E, R),
                    flat))
    return name, kern, lambda: [(fb.index_select(0, f),
                                 fs.index_select(0, f))
                                for fb, fs, f in lib]


def ds_path_ms(calls):
    """Device ms of each kernel summed over every one of ``calls`` (one
    path's recorded calls, cuda_ms_all), with the number of calls."""
    fns = {}
    for kind, args in calls:
        name, kern, _lib = ds_timed(kind, args)
        fns.setdefault(name, []).append(kern)
    return {k: {"ms": cuda_ms_all(v), "calls": len(v)}
            for k, v in sorted(fns.items())}


def ds_measure(calls):
    """Per kernel, summed over every one of ``calls`` (one drain's): device
    ms (cuda_ms_all), the plain version's ms (all calls back to back, one
    sync at the end), the bound (bytes and operations of every call) and,
    for the gather, the library's ms (index_select of the kept records'
    bytes and syncs, every call)."""
    rows = {}
    for kind, args in calls:
        name, kern, lib = ds_timed(kind, args)
        plain = ds_fns(kind, args)[2]
        r = rows.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0,
                                   "shapes": [], "kern": [], "plain": [],
                                   "library": []})
        nbytes, ops, shape = ds_cost(kind, args)
        r["calls"] += 1
        r["bytes"] += nbytes
        if kind == "content_dup":
            r["bytes_all_planes"] = r.get("bytes_all_planes", 0) + \
                dup_all_plane_bytes(args[0])
        r["ops"] += ops
        if len(r["shapes"]) < 16:
            r["shapes"].append(shape)
        r["kern"].append(kern)
        r["plain"].append(plain)
        if lib is not None:
            r["library"].append(lib)
    for r in rows.values():
        kern, plain, lib = r.pop("kern"), r.pop("plain"), r.pop("library")
        r["ms"] = cuda_ms_all(kern)
        r["plain_ms"] = host_ms(lambda: [p() for p in plain])
        r["library_ms"] = cuda_ms_all(lib) if lib else None
        b_ms = r["bytes"] / HBM_BPS * 1e3
        o_ms = r["ops"] / INT32_OPS * 1e3
        r["bound_ms"] = max(b_ms, o_ms)
        r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        if "bytes_all_planes" in r:
            r["bound_all_planes_ms"] = r["bytes_all_planes"] / HBM_BPS * 1e3
    return rows


def decl_cost(bank, bits, n_bits, sid, n_store=None):
    """(bytes, int32 operations, shape) of one decode-bank call: the
    candidates' bits, lengths and spec ids read once, code and raws
    written once; per spec present its spec row and the non-zero entries
    of its live check slots and field rows (a frame bit and a weight, 8
    bytes each: the sparse tables without their padding), each once. Per
    candidate the preamble offsets its search tries up to its first match
    (one compare, xor and mask per pattern word), the frame as words
    (six word operations per frame word: the shift, four masks, the
    invert; twelve more for Manchester) and three operations per
    non-zero entry of its spec (the bit, the select, the XOR or add)."""
    import torch
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    tabs = dbk.bank_tables(bank, bits.device)
    B, IN = bits.shape
    FB, C, R = bank.frame_bits, bank.n_checks, bank.n_raws
    PW = (bank.pat_len + 31) // 32
    NF = -(-FB // 32)
    start = tabs["chunk_start"].long()
    live = (tabs["entries"][:, 1] != 0).long()
    nz = torch.cat([live.new_zeros(1), live.cumsum(0)])[dbk.CHUNK * start]
    nz_spec = nz[1:] - nz[:-1]                               # [S]
    present = torch.unique(sid).long()
    nbytes = B * (IN + 12 + 4 + 4 * R) \
        + 4 * tabs["spec"][present].numel() + 8 * int(nz_spec[present].sum())
    s = sid.long()
    n = n_bits.long()
    found, pos = dbk.preamble_plain(bank, tabs, bits, n, s)
    plen = tabs["plen"][s].long()
    start_t = tabs["pre_start"][s].long().clamp(min=0)
    end = torch.where(found, pos + 1, (n - plen + 1).clamp(max=IN))
    tried = torch.where(plen > 0, (end - start_t).clamp(min=0), 0)
    mc = (tabs["transform"][s] == dbk.TF_MANCHESTER).long()
    per = NF * (6 + 12 * mc) + 3 * nz_spec[s]
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
# tests/test_mic_kernels.py
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
# integer operations per message byte that a table-driven digest needs,
# each table read counted and none of a kernel's own address arithmetic: a
# CRC byte step is the byte's extraction, its index (crc8, crc8le: v ^ b;
# crc16: v >> 8, ^ b; crc16lsb: v ^ b, & 0xFF), the table read and the new
# remainder (crc16: (v << 8) & 0xFFFF, ^; crc16lsb: v >> 8, ^); an LFSR
# digest's byte is its extraction, one read of a 256-word table for its
# position and one XOR; a fold is one operation per four bytes (add_nibbles
# five: two masks, a shift, an add and the byte sum). csrc/mic.cu does
# more (an LFSR byte there is two nibble reads, two address adds and two
# byte selects besides), which the bound does not credit.
MIC_OPS = {"crc8": 3, "crc8le": 3, "crc16": 7, "crc16lsb": 6,
           "lfsr_digest8": 3, "lfsr_digest8_reverse": 3,
           "lfsr_digest8_reflect": 3, "lfsr_digest16": 3,
           "xor_bytes": 0.25, "add_bytes": 0.25, "add_nibbles": 1.25,
           "parity_bytes": 0.25}
# the same count for the earlier, bit-serial kernel (per bit a test, a
# shift, a xor and a mask for the CRCs; a test and a xor for the LFSR
# digests; a byte load an operation for the folds)
MIC_OPS_BITSERIAL = {"crc8": 33, "crc8le": 33, "crc16": 34, "crc16lsb": 33,
                     "lfsr_digest8": 17, "lfsr_digest8_reverse": 17,
                     "lfsr_digest8_reflect": 17, "lfsr_digest16": 17,
                     "xor_bytes": 1, "add_bytes": 1, "add_nibbles": 4,
                     "parity_bytes": 1}
MIC_ROWS = 65536
# the large batch: 2^22 rows of 16 bytes (64 MB of uint8)
MIC_BIG_ROWS = 1 << 22
# the JAX functions (rtl_433_tpu/ops/mic.py)
MIC_LINES = {"crc8": 32, "crc8le": 45, "crc16": 59, "crc16lsb": 72,
             "lfsr_digest8": 110, "lfsr_digest8_reverse": 118,
             "lfsr_digest8_reflect": 128, "lfsr_digest16": 141,
             "xor_bytes": 149, "add_bytes": 154, "add_nibbles": 159,
             "parity_bytes": 164}


def mic_bound(name, rows, nbytes, ops=MIC_OPS):
    """The least time of one digest call over ``rows`` rows: the message
    bytes read once, one int32 written per row and the kernel's table read
    once (a CRC's 256 words, an LFSR digest's 32 words per byte position),
    or ``ops`` per message byte at the int32 peak.
    (ms, "bytes" or "operations")."""
    table = 1024 if name.startswith("crc") else \
        128 * nbytes if name.startswith("lfsr") else 0
    b_ms = (rows * (nbytes + 4) + table) / HBM_BPS * 1e3
    o_ms = rows * nbytes * ops[name] / INT32_OPS * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def launch_floor_ms(dev):
    """The floor of any launch: a one-element fill, queued behind a
    spinning card as cuda_ms(busy_first=True) queues a kernel."""
    import torch
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    return cuda_ms(lambda: one.fill_(1), reps=20, busy_first=True)


def mic_phase(dev, compare, rng):
    """Phase 4e: every MIC case through its entry point at MIC_ROWS rows of
    16 bytes, uint8 and int32 (garbage above the low byte), with the launch
    counts set to 0 before and read after; each result against the plain
    version (bit-exact) and against bits/util.py on 64 sampled rows; then,
    per digest, its largest case timed (device ms, the calls queued behind
    a spinning card), its plain version, its bound and, for add_bytes, the
    one PyTorch call that computes it (``torch.sum`` of the rows' first
    nbytes bytes into int32; equal to the kernel, or the run fails). Then
    each digest's largest case once more at MIC_BIG_ROWS rows of 16 bytes
    of uint8 (made on the card from SEED): bit-exact against the plain
    version and bits/util.py on 64 sampled rows, timed, with its bound from
    MIC_OPS, the share of it reached and the bound by the bit-serial count
    beside it; the batch is freed after. Uses only the entry points, so
    that ``--mic-only`` also measures an earlier checkout's kernel.
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

    def host_check(got, rows, idx, name, nbytes, params):
        host = [getattr(util, name)(bytes(rows[i]), nbytes, *params)
                for i in idx]
        if got.cpu().numpy()[idx].tolist() != host:
            fail(f"mic_{name} differs from bits/util.py ({nbytes}, "
                 f"{params}, {len(got)} rows)")

    for name, nbytes, params, t, got in outs:
        want = mic.DIGESTS[name][1](t, nbytes, *params)
        compare(f"mic_{name}", [got], [want], ("digest",),
                f"{name} nbytes={nbytes} {params} {t.dtype}")
        host_check(got, msgs, sample, name, nbytes, params)
    del outs
    largest = {name: max((c for c in MIC_CASES if c[0] == name),
                         key=lambda c: c[1])[1:]
               for name in _cuda.MIC_ALGOS}
    rows = {}
    for name in _cuda.MIC_ALGOS:
        nbytes, *params = largest[name]
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
        bound, by = mic_bound(name, MIC_ROWS, nbytes)
        rows[f"mic_{name}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "bound_bitserial_ms": mic_bound(name, MIC_ROWS, nbytes,
                                            MIC_OPS_BITSERIAL)[0],
            "launches": launches[f"mic_{name}"],
            "shape": [MIC_ROWS, 16, nbytes]}
    del ins
    # the large batch: 2^22 rows of 16 bytes, each digest's largest case
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(0, 256, (MIC_BIG_ROWS, 16), device=dev,
                        generator=gen, dtype=torch.uint8)
    big_sample = np.random.default_rng(SEED).integers(0, MIC_BIG_ROWS, 64)
    big_rows = big[torch.from_numpy(big_sample).to(dev)].cpu().numpy()
    for name in _cuda.MIC_ALGOS:
        nbytes, *params = largest[name]
        fn, plain = mic.DIGESTS[name]
        got = fn(big, nbytes, *params)
        compare(f"mic_{name}", [got], [plain(big, nbytes, *params)],
                ("digest",), f"{name} nbytes={nbytes} at {MIC_BIG_ROWS} rows")
        host_check(got[torch.from_numpy(big_sample).to(dev)], big_rows,
                   np.arange(64), name, nbytes, params)
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fn(big, nbytes, *params), reps=20,
                     busy_first=True)
        bound, by = mic_bound(name, MIC_BIG_ROWS, nbytes)
        # the same bound with the rows' bytes counted whole: two 16-byte
        # rows share each 32-byte sector, so every byte of them moves
        whole = MIC_BIG_ROWS * (16 + 4) / HBM_BPS * 1e3
        rows[f"mic_{name}"]["large"] = {
            "rows": MIC_BIG_ROWS, "nbytes": nbytes, "ms": ms,
            "bound_ms": bound, "bound_by": by, "share": bound / ms,
            "bound_whole_rows_ms": max(whole, bound),
            "bound_bitserial_ms": mic_bound(name, MIC_BIG_ROWS, nbytes,
                                            MIC_OPS_BITSERIAL)[0]}
    del big
    torch.cuda.empty_cache()
    line = {"phase": "mic", "rows": MIC_ROWS, "cases": len(MIC_CASES),
            "inputs": ["uint8", "int32"], "bit_exact": True,
            "host_sampled_rows": 64, "launches": launches,
            "launch_floor_ms": launch_floor_ms(dev),
            "ms": {k: v["ms"] for k, v in rows.items()},
            "library_ms": {k: v["library_ms"] for k, v in rows.items()
                           if v["library_ms"] is not None},
            "large": {k: v["large"] for k, v in rows.items()}}
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


def device_kernels(fn, calls=20):
    """The names of the device activities (kernels, copies, fills) that
    ``calls`` calls of ``fn`` run back to back, from one torch.profiler
    window around them. Taken only early in the run (phase 4b): a window
    that follows the stream phases' long traced runs has come back on the
    card with none or only some of its device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def compact_host_split(ins, cap, reps=200):
    """Host ms per call of each part of the compaction wrapper
    (ops/compact.py compact_packages_cuda), each run ``reps`` times back to
    back: the checks, the one allocation, the launch through ctypes, the
    six views of the buffer; then the whole call."""
    import torch
    from rtl_433_tpu_torch.ops import compact as cmp
    out_n, out_p, out_g, out_meta = ins
    C, _, P = out_p.shape
    F = out_meta.shape[2]
    n = cmp.buffer_ints(C, P, F, cap)
    buf = torch.empty(n, dtype=torch.int32, device=out_p.device)

    def per_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / reps * 1e3

    return {
        "check_ms": per_call(lambda: cmp._check_cuda(*ins, cap)),
        "alloc_ms": per_call(lambda: torch.empty(
            n, dtype=torch.int32, device=out_p.device)),
        "launch_ms": per_call(lambda: cmp._run(*ins, cap, buf)),
        "views_ms": per_call(lambda: cmp.views_of(buf, cap, P, F)),
        "call_ms": per_call(lambda: cmp.compact_packages_cuda(*ins, cap))}


def compact_states(dev, compare):
    """Phase 4b's two ragged states at bench.py's widths (C=MC_CHANNELS,
    S=8, P=1200): out_n over 0..12 (beyond S) on 2% and on all of the
    channels, pulse and gap over 0..2^31, meta over all of int32, made on
    the card from SEED; each compacted at caps 768 and 2048 and held to
    the plain version. Returns the states and their valid totals."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def compact_state(active):
        C_, S_, P_ = MC_CHANNELS, 8, 1200
        on = torch.rand(C_, device=dev, generator=gen) < active
        out_n = (torch.randint(0, 13, (C_,), device=dev, generator=gen)
                 * on).to(torch.int32)
        rnd = lambda lo, *sh: torch.randint(
            lo, (1 << 31) - 1, sh, device=dev, generator=gen,
            dtype=torch.int64).to(torch.int32)
        return [out_n, rnd(0, C_, S_, P_), rnd(0, C_, S_, P_),
                rnd(-(1 << 31), C_, S_, 9)]

    states = {"sparse": compact_state(0.02), "dense": compact_state(1.0)}
    totals = {k: int(v[0].clamp(0, 8).sum()) for k, v in states.items()}
    if not (totals["sparse"] < 768 and totals["dense"] > 2048):
        fail(f"compaction states do not straddle the caps: {totals}")
    for kind, ins in states.items():
        if int((ins[3].abs() > (1 << 24)).sum()) == 0:
            fail("compaction meta has no value above 2^24")
        for cap in (768, 2048):
            compact_check(compare, ins, cap, f"{kind} state, cap={cap}")
    return states, totals


def compact_measure(ins, cap, count_kernels=False):
    """The compaction kernel's and the library's device time and time per
    call (index_select on the three flattened planes with a precomputed
    index), the plain version's time,
    and the bound from the bytes this state needs: out_n and the kept rows
    read once, every output row written once; with ``count_kernels``, the
    device activities of 20 calls under torch.profiler, which must be the
    one kernel each. Uses only the entry points, so that
    ``--compact-only`` also measures an earlier checkout's wrapper."""
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
    out = {}
    if count_kernels:
        kernels = device_kernels(kernel)
        if len(kernels) != 20 or not all("compact_kernel" in k
                                         for k in kernels):
            fail(f"20 compaction calls ran {len(kernels)} device activities "
                 f"({sorted(set(kernels))}), not one kernel each")
        out = {"device_kernels_per_call": len(kernels) / 20,
               "device_activities": sorted(set(kernels))}
    return {**out,
        "ms": cuda_ms(kernel, reps=20, busy_first=True),
        "library_ms": cuda_ms(library, reps=20, busy_first=True),
        # per call with the host's launch cost, as ShardedEngine pays it
        "call_ms": cuda_ms(kernel, reps=20),
        "library_call_ms": cuda_ms(library, reps=20),
        "plain_ms": host_ms(lambda: cmp.compact_packages_plain(*ins, cap)),
        "bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes, "rows": k,
        "cap": cap, "count": int(valid.sum())}


def multichannel(dev, mesh, compare, ds_kernels, mh_dir, gathers,
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
    phase. ``gathers`` collects the gather launches of each prewarm of
    the device-slicing pass's timed drains (prewarm_gathers)."""
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
        numbers["host_split"] = compact_host_split(recorded[-1], cap)
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
            with prewarm_gathers(gathers):
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
        if "slice_pcm" in ds_numbers:
            ds_numbers["slice_pcm"]["split"] = pcm_split(drain_calls)
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
    on the same inputs; a gather recorded behind a failed chain with
    skip_if_bad (the step's launch on a block that falls back) is rerun
    into outputs filled with a sentinel, which must stay as they were.
    Returns the calls checked by kernel (the gather's skipped launches
    apart, as timeshard_gather_skipped)."""
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
    sentinel = -0x5a5a5a5b
    for i, (kind, args, kw) in enumerate(calls):
        kernel, plain, names = fns[kind]
        pkw = {k: v for k, v in kw.items() if k != "skip_if_bad"}
        want = plain(*args, **pkw)
        if ts_skipped(kind, kw):
            out = [torch.full_like(w, sentinel) for w in want]
            kernel(*args, **kw, out=out)
            torch.cuda.synchronize()
            for o, nm in zip(out, names):
                if not bool((o == sentinel).all()):
                    fail(f"{kind} {nm} written behind a failed chain "
                         f"({what}, call {i})")
            kind = "timeshard_gather_skipped"
        else:
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            compare(kind, got, want, names, f"{what}, call {i}")
        checked[kind] = checked.get(kind, 0) + 1
    return checked


def ts_skipped(kind, kw):
    """Whether a recorded gather call was a launch behind a failed chain
    that writes nothing (skip_if_bad given and set)."""
    sk = kw.get("skip_if_bad")
    return kind == "timeshard_gather" and sk is not None and int(sk[0]) != 0


def ts_picks(calls):
    """The calls of one recorded decode that ts_measure times: the first
    chain call, the first gather call that copied, and the first chain
    call, with the gather right behind it, of a block that verified
    (pair_ok) and of one that failed (pair_bad; the gather None where the
    package launches none behind a failed chain)."""
    out = {}
    for i, (kind, args, kw) in enumerate(calls):
        if kind == "timeshard_gather" and not ts_skipped(kind, kw):
            out.setdefault(kind, (args, kw))
        if kind != "timeshard_chain":
            continue
        out.setdefault(kind, (args, kw))
        nxt = calls[i + 1] if i + 1 < len(calls) else None
        gather = nxt[1:] if nxt and nxt[0] == "timeshard_gather" else None
        ok = gather is not None and not ts_skipped(nxt[0], nxt[2])
        out.setdefault("pair_ok" if ok else "pair_bad", ((args, kw), gather))
    return out


def pair_behind(cargs, ckw, logs, R, a, b, pdl=True):
    """The step's order: the chain, the gather right behind it
    (skip_if_bad: the chain's bad; ``pdl``: its launch form) and the
    second event, then the host's one read of bad. Returns the verdict."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    a.record()
    sel, delta, _, _, bad = ots.timeshard_chain_cuda(*cargs, **ckw)
    ots.timeshard_gather_cuda(*logs, sel, delta, R=R, skip_if_bad=bad,
                              pdl=pdl)
    b.record()
    return not bad.item()


def pair_host_read(cargs, ckw, logs, R, a, b):
    """The chain, the host's read of bad, the gather only where the block
    verified, then the second event: the span holds the host's round
    trip."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    a.record()
    sel, delta, _, _, bad = ots.timeshard_chain_cuda(*cargs, **ckw)
    ok = not bool(bad.any())
    if ok:
        ots.timeshard_gather_cuda(*logs, sel, delta, R=R)
    b.record()
    return ok


def pair_chain(cargs, ckw, logs, R, a, b):
    """The chain alone and the second event, then the read."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    a.record()
    bad = ots.timeshard_chain_cuda(*cargs, **ckw)[4]
    b.record()
    return not bad.item()


def ts_pair_ms(chain, gather, reps=20):
    """Device ms from before the chain to after the gather, in each of the
    forms pair_behind (``behind``; ``behind_plain``: the gather as a plain
    launch), pair_host_read and pair_chain: the mean over ``reps`` runs,
    each queued behind about 3 ms of a spinning card (longer than the host
    takes to enqueue both), with CUDA events around the launches, and the
    verdict (``ok``). ``gather`` None: no gather call was recorded behind
    this chain, and only a form that launches none where the chain failed
    can run."""
    import torch
    (cargs, ckw), g = chain, gather
    gargs, gkw = g if g is not None else ((None,) * 6, {})
    logs, R = gargs[:4], gkw.get("R")
    forms = {"behind": pair_behind,
             "behind_plain": lambda *x: pair_behind(*x, pdl=False),
             "host_read": pair_host_read, "chain": pair_chain}
    out = {}
    for name, fn in forms.items():
        total, ok = 0.0, None
        for i in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)
            ok = fn(cargs, ckw, logs, R, a, b)
            torch.cuda.synchronize()
            if i:                                       # the first warms up
                total += a.elapsed_time(b)
        out[name] = total / reps
        out["ok"] = ok
    return out


def ts_measure(picks):
    """The chain's and the gather's device time (queued behind a spinning
    card), plain time and bound at one recorded call of each (``picks``:
    segments -> ts_picks' calls; each kernel's call at the most segments
    that recorded one, the gather's one that copied; the chain also at
    every D, beside the device time of a one-element fill, the floor of
    any launch timed this way), and for the gather the library's time:
    index_select of the selected lanes' rows and torch.where for the
    rebase. The bound counts the bytes the function needs: the selected
    candidates' registers or logs read once (a third of the candidate
    tensors), the other inputs read once, the outputs written once. Then
    the pair (ts_pair_ms) at the gather's segments: pair_ms on the first
    block that verified, skip_ms on the first that failed (at the most
    segments that had one, where none at the gather's did), in the step's
    order (behind) and, beside it, with the host's read between the
    launches (host_read), each beside the same span of its chain alone
    (*_chain_ms), and with the gather as a plain launch (*_plain_ms). The
    gather's ``ms`` is the kernel alone: plain launches back to back, each
    starting after the one before has ended; ``pdl_ms`` the same with the
    launch form of the path, where each launch overlaps the one before
    (so under the launch floor, and no time of the kernel); and
    ``behind_fill_ms``/``behind_fill_pdl_ms`` behind a one-element fill
    each, in either form."""
    import torch
    from rtl_433_tpu_torch.ops import detector as det
    from rtl_433_tpu_torch.ops import timeshard as ots
    pick, at = {}, {}
    for D in sorted(picks):
        pick.update(picks[D])
        at.update({k: D for k in picks[D]})
    for k in ("timeshard_chain", "timeshard_gather"):
        if k not in pick:
            fail(f"timeshard: no recorded {k} call to time")
    out = {}

    def chain_numbers(args, kw):
        start, fin, rowinfo = args
        D = kw["D"]
        C = start.shape[1] // D
        nbytes = 4 * (start.numel() + fin.numel() // 3 + rowinfo.numel()
                      + 2 * D * C + start.shape[0] * C + D)
        return {
            "ms": cuda_ms(lambda: ots.timeshard_chain_cuda(*args, **kw),
                          reps=20, busy_first=True),
            "plain_ms": host_ms(
                lambda: ots.timeshard_chain_plain(*args, **kw)),
            "library_ms": None, "bound_ms": nbytes / HBM_BPS * 1e3,
            "bytes": nbytes, "shape": {"start": list(start.shape),
                                       "fin": list(fin.shape), "D": D}}
    # at the most segments (the parent's figure), then at every D
    out["timeshard_chain"] = chain_numbers(*pick["timeshard_chain"])
    out["timeshard_chain"]["by_D"] = {
        D: chain_numbers(*picks[D]["timeshard_chain"])
        for D in sorted(picks) if "timeshard_chain" in picks[D]}
    # the floor of any launch: a one-element fill, queued the same way
    out["timeshard_chain"]["launch_floor_ms"] = launch_floor_ms(
        pick["timeshard_chain"][0][0].device)
    args, kw = pick["timeshard_gather"]
    pkw = {"R": kw["R"]}
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

    one = torch.zeros(1, dtype=torch.int32, device=key3.device)

    def gather(pdl, fill=False):
        def run():
            if fill:
                one.fill_(1)
            ots.timeshard_gather_cuda(*args, **kw, pdl=pdl)
        return cuda_ms(run, reps=20, busy_first=True)

    out["timeshard_gather"] = {
        # back to back: plain launches (the kernel alone), and as the path
        # launches it (each launch overlapping the one before)
        "ms": gather(False), "pdl_ms": gather(True),
        # behind a kernel that does not release it early: a one-element
        # fill (launch_floor_ms) and the gather
        "behind_fill_ms": gather(False, fill=True),
        "behind_fill_pdl_ms": gather(True, fill=True),
        "plain_ms": host_ms(lambda: ots.timeshard_gather_plain(*args, **pkw)),
        "library_ms": cuda_ms(library, reps=20, busy_first=True),
        "bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes,
        "shape": {"key3": list(key3.shape), "eop3": list(eop3.shape),
                  "D": D}}
    # the pair at the gather's segments: a block that verified, and one
    # that failed (its chain's bad set)
    Dg = at["timeshard_gather"]
    for key, name in (("pair_ok", "pair"), ("pair_bad", "skip")):
        src = picks[Dg] if key in picks[Dg] else pick
        if key not in src:
            fail(f"timeshard: no recorded {key} to time")
        nums = ts_pair_ms(*src[key])
        if nums.pop("ok") != (key == "pair_ok"):
            fail(f"timeshard: the {key} call gave the other verdict")
        out["timeshard_gather"].update({
            f"{name}_ms": nums["behind"],
            f"{name}_plain_ms": nums["behind_plain"],
            f"{name}_host_read_ms": nums["host_read"],
            f"{name}_chain_ms": nums["chain"],
            f"{name}_D": src[key][0][1]["D"]})
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


def timeshard_phase(dev, compare, fx, rate_of, only=None):
    """Phase 6c: the single-channel streams (``only``: those named) through
    TimeShardEngine on Mesh([cuda] * D) and, in the same call, through the
    one-channel ShardedEngine: equal events, fallbacks, wall ms per block of
    both, and under torch.profiler the device ms per block of both by
    kernel. Every per-lane-origin front-end and detector call and every
    chain and gather call of TS_CHECKED's decode is held to its plain
    version. Returns (the phase lines, the launches of the time-sharded
    decodes, the chain's and gather's numbers)."""
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
        wall ms per block, device ms per block by kernel, and the gather's
        launches and those that copied). A gather's span starts when the
        chain releases it, at the chain's start, and so holds its wait on
        the chain (launches behind a failed chain, which return early,
        included): the kernels' sum counts that time twice. The total and
        the busy share count the union of the kernels' spans, and
        gather_own_ms_per_block the gather's time outside every other
        kernel's span (after the chain has ended)."""
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            evs, wall = drive(mk(), blocks)
        launched = dict(_cuda.LAUNCHES)
        groups = profile_groups(prof)
        spans = device_spans(prof)
        if groups and not spans:
            fail("timeshard: the profiler gave device times but no spans")
        busy = union_ms(spans)
        own = busy - union_ms([x for x in spans
                               if x[0] != "timeshard_gather"])
        nb = len(blocks)
        return evs, {
            "blocks": nb, "wall_ms_per_block": wall / nb * 1e3,
            "device_ms_per_block": {k: v / nb for k, v in groups.items()},
            "device_ms_per_block_sum": sum(groups.values()) / nb,
            "device_ms_per_block_total": busy / nb,
            "device_busy_share": busy / (wall * 1e3),
            "gather_own_ms_per_block": own / nb,
            "gather_launches": launched["timeshard_gather"],
            "gather_copied": launched["timeshard_gather_copied"]}

    rows = []
    launches = {k: 0 for k in TS_KERNELS}
    chain_by_D = {D: 0 for D in TS_SEGMENTS}
    gather_by_D = {D: {"launches": 0, "copied": 0} for D in TS_SEGMENTS}
    picks = {}
    for name, nums, samples, rate in timeshard_streams(fx, rate_of):
        if only is not None and name not in only:
            continue
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
            # this run's own launches, read before any other run; the
            # gather launched behind a failed chain writes nothing, so one
            # gather copies for each verified block
            seg_launches = {k: _cuda.LAUNCHES[k] for k in TS_KERNELS}
            copied = _cuda.LAUNCHES["timeshard_gather_copied"]
            for k in TS_KERNELS:
                if seg_launches[k] <= 0 and (k != "timeshard_gather"
                                             or eng.verified):
                    fail(f"kernel {k} was not launched on timeshard {name} "
                         f"D={D}")
                launches[k] += seg_launches[k]
            if copied != eng.verified:
                fail(f"timeshard {name} D={D}: {copied} gathers copied, "
                     f"{eng.verified} blocks verified")
            chain_by_D[D] += seg_launches["timeshard_chain"]
            gather_by_D[D]["launches"] += seg_launches["timeshard_gather"]
            gather_by_D[D]["copied"] += copied
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
                   "launches_gather_copied": copied,
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
                # the calls to time, at each D
                picks[D] = ts_picks(rec)
                del rec
            row["segments"][str(D)] = seg
        rows.append(row)
    for k in TS_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the timeshard phase")
    numbers = ts_measure(picks)
    numbers["timeshard_chain"]["launches_by_D"] = chain_by_D
    numbers["timeshard_gather"]["launches_by_D"] = gather_by_D
    numbers["timeshard_gather"]["launches_copied"] = sum(
        v["copied"] for v in gather_by_D.values())
    return rows, launches, numbers


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
        # one more rotation, untimed: every compaction call against the
        # plain version on the same state, all six outputs
        from rtl_433_tpu_torch.ops import compact as cmp
        real_compact, checked = eng._compact, []

        def checking_compact(st):
            got = real_compact(st)
            want = cmp.compact_packages_plain(
                st["out_n"], st["out_p"], st["out_g"], st["out_meta"],
                got["rows"].shape[0])
            checked.append(all(torch.equal(got[k], want[k]) for k in want))
            return got
        eng._compact = checking_compact
        for blk in blocks:
            eng.push(blk)
            eng.local_events()
        eng._compact = real_compact
        with open(out, "w") as f:
            json.dump({"rank": rank, "channels": blocks[0].shape[0],
                       "per_block": per_block,
                       "wall_ms_per_block": [w * 1e3 for w in walls],
                       "cached_wall_ms_per_block":
                           cached_s / len(blocks) * 1e3,
                       "all_reduce_ms": [x * 1e3 for x in reduce_s],
                       "launches": launches,
                       "compact_calls_checked": len(checked),
                       "compact_bit_exact": all(checked),
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
        if dev.type == "cuda" and not (w["compact_calls_checked"]
                                       and w["compact_bit_exact"]):
            fail(f"multihost: process {w['rank']}: a compaction call "
                 f"differs from the plain version, or none was checked")
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
            "compact_calls_checked": {w["rank"]: w["compact_calls_checked"]
                                      for w in res},
            "n_pkg_dropped": sum(w["n_pkg_dropped"] for w in res),
            "processes_wall_s": wall}


# the kernels of the replay_cli phase: the front end and detector of every
# replay, and device slicing's over the flex and conf runs (OOK_PPM,
# OOK_PWM and FSK_PCM specs; nexus and prologue reach the bank)
REPLAY_CLI_KERNELS = REPLAY_KERNELS + ("slice_ppm", "slice_pwm", "slice_pcm",
                                       "content_dup", "gather_records",
                                       "decl_bank")


def replay_cli_phase(compare):
    """Phase 5d: the port's CLI (``cli.main``, in this process, stdout and
    stderr captured, the API's clock pinned) on the card. Every run is held,
    byte for byte with its exit code, to the same argv with ``--device
    cpu``; the launch counts are set to 0 before the card's runs and read
    after them; every device-slicing kernel call of those runs is then held
    to its plain version."""
    import torch
    from rtl_433_tpu_torch import cli
    from rtl_433_tpu_torch.decoders import base as dbase
    from rtl_433_tpu_torch.decoders.flex import MODULATIONS
    from rtl_433_tpu_torch.io import load_iq, sigmf
    from rtl_433_tpu_torch.ops import _cuda
    from torch_fixture_cases import expected, normalize
    from torch_replay_cases import (CONF, CONF_RUNS, FLEX_FIXTURES,
                                    OPTION_RUNS, fixture, flex_spec, run_cli)

    t_phase = time.perf_counter()
    secs = {"card": 0.0, "cpu": 0.0}
    calls = []

    def card(argv, record=False):
        t = time.perf_counter()
        if record:
            with ds_recorder(calls):
                res = run_cli(cli.main, argv)
        else:
            res = run_cli(cli.main, argv)
        torch.cuda.synchronize()
        secs["card"] += time.perf_counter() - t
        return res

    def held(what, argv, record=False):
        """``argv`` on the card and with --device cpu: the same exit code,
        stdout and stderr; exit code 0. Returns stdout."""
        got = card(argv, record)
        t = time.perf_counter()
        want = run_cli(cli.main, argv + ["--device", "cpu"])
        secs["cpu"] += time.perf_counter() - t
        if got != want:
            fail(f"replay_cli {what}: the card's run differs from "
                 f"--device cpu: rc {got[0]} vs {want[0]}, stdout "
                 f"{got[1][:400]!r} vs {want[1][:400]!r}, stderr "
                 f"{got[2][-400:]!r} vs {want[2][-400:]!r}")
        if got[0] != 0:
            fail(f"replay_cli {what}: exit code {got[0]}: {got[2][-400:]}")
        return got[1]

    def events(out):
        return [json.loads(ln) for ln in out.splitlines()]

    reg = dbase.Registry()
    runs = {}
    _cuda.reset_launches()
    # flex decoders made from a registered device's timings, alone (-R 0),
    # on the default path and with device slicing
    for name, num in FLEX_FIXTURES:
        spec = flex_spec(reg.get(num), MODULATIONS, name=f"flex_{name}")
        argv = ["-R", "0", "-X", spec, "-r", fixture(name), "-F", "json"]
        out = held(f"flex {name}", argv)
        evs = events(out)
        if not evs or any(e["model"] != f"flex_{name}" for e in evs):
            fail(f"replay_cli flex {name}: {evs}")
        if held(f"flex {name}, device slicing", argv + ["-Y", "deviceslice"],
                record=True) != out:
            fail(f"replay_cli flex {name}: device slicing differs")
        runs[f"flex_{name}"] = len(evs)
    # conf files (-c) beside -R <protocol>, with device slicing: the
    # protocol's events are the committed ones
    for conf, name, num in CONF_RUNS:
        path = fixture(name)
        out = held(f"-c {conf}", ["-c", os.path.join(CONF, conf), "-R",
                                  str(num), "-r", path, "-F", "json", "-Y",
                                  "deviceslice"], record=True)
        evs = [normalize(e) for e in events(out)]
        want = expected(path)
        models = {w["model"] for w in want}
        if [e for e in evs if e["model"] in models] != want:
            fail(f"replay_cli -c {conf}: {evs} lacks {want}")
        runs[f"conf_{conf}"] = {"events": len(evs),
                                "flex_events": len(evs) - len(want)}
    if not any(runs[f"conf_{c}"]["flex_events"] for c, _n, _p in CONF_RUNS):
        fail("replay_cli: no conf file's flex decoder decoded")
    # SigMF and .ook input against the capture's own replay
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        path = fixture("nexus")
        base = ["-R", "19", "-F", "json"]
        pds = []
        real = dbase.Registry.run_ook_demods

        def keep(self, pd, cb):
            pds.append(pd)
            return real(self, pd, cb)

        with patched((dbase.Registry, "run_ook_demods", keep)):
            ref = card(base + ["-r", path])
        if ref[0] != 0 or not ref[1]:
            fail(f"replay_cli: the nexus replay failed: {ref}")
        sm = os.path.join(tmp, "nexus.sigmf")
        sigmf.write(sm, load_iq(path, "cu8"), 250_000, 433_920_000)
        if held("SigMF", base + ["-r", sm]) != ref[1]:
            fail("replay_cli: the SigMF replay differs from the .cu8's")
        ook = os.path.join(tmp, "nexus_433.92M_250k.ook")
        with open(ook, "w") as f:
            f.write("".join(pd.dump() for pd in pds))
        strip = lambda out: [dict(e, time=None) for e in events(out)]
        if strip(held(".ook", base + ["-r", ook])) != strip(ref[1]):
            fail("replay_cli: the .ook replay differs from the .cu8's")
        runs["sigmf_events"] = len(events(ref[1]))
        runs["ook_packages"] = len(pds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # one run each of the replay options
    for opts in OPTION_RUNS:
        held(" ".join(opts), ["-R", "19", "-r", path] + opts)
    runs["options"] = len(OPTION_RUNS)
    launches = {k: _cuda.LAUNCHES[k]
                for k in REPLAY_KERNELS + tuple(ds_kernel_names())}
    for k in REPLAY_CLI_KERNELS:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the replay_cli phase")
    t = time.perf_counter()
    checked = ds_check(calls, compare, "replay_cli with device slicing")
    check_s = time.perf_counter() - t
    if any(checked.get(k, 0) < launches[k] for k in ds_kernel_names()):
        fail(f"replay_cli: the checked kernel calls {checked} are fewer "
             f"than the launches {launches}")
    return {"phase": "replay_cli", "runs": runs,
            "card_s": secs["card"], "cpu_s": secs["cpu"],
            "check_s": check_s,
            "seconds_total": time.perf_counter() - t_phase,
            "launches": launches, "checked": checked, "bit_exact": True,
            "nvidia_smi": smi_line()}, launches


# the live phase: the server's rate (a 128 ms block period), the blocks of
# the CLI's -d run (at most the ring's 15, so that the CPU's run drops
# nothing) and of the cold start
LIVE_RATE = 1_024_000
LIVE_CLI_BLOCKS = 7
LIVE_COLD_BLOCKS = 10

# the cold start: one run_live in a fresh process against the parent's
# server (argv: port, sample rate, checkout); prints one JSON line
LIVE_COLD = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[3])
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.io import rtltcp
t_import = time.perf_counter()
rx = RtlTpu(sample_rate=int(sys.argv[2]), device="cuda")
clients, walls = [], []
real_run, real_push = rtltcp.RtlTcpClient.run, rx.push_block
real_prep, prep = rx._prepare_live, []


def prepare():
    t = time.perf_counter()
    real_prep()
    prep.append(time.perf_counter() - t)


def run(self, *a, **k):
    clients.append((self, time.perf_counter()))
    return real_run(self, *a, **k)


def push(iq, *a, **k):
    t = time.perf_counter()
    out = real_push(iq, *a, **k)
    walls.append((t, time.perf_counter() - t))
    return out


rtltcp.RtlTcpClient.run = run
rx.push_block = push
rx._prepare_live = prepare
t_ready = time.perf_counter()
rx.run_live(f"rtl_tcp:127.0.0.1:{sys.argv[1]}")
print(json.dumps({
    "import_s": t_import - t0, "receiver_s": t_ready - t_import,
    "prepare_s": prep[0],
    "run_live_to_stream_s": clients[0][1] - t_ready,
    "stream_to_first_block_s": walls[0][0] - clients[0][1],
    "first_block_ms": walls[0][1] * 1e3,
    "second_block_ms": walls[1][1] * 1e3 if len(walls) > 1 else None,
    "blocks": len(walls), "blocks_dropped": clients[0][0].blocks_dropped,
    "events": len(rx.events), "exit_code": rx.exit_code}))
"""


def live_run(rx, blocks, rate):
    """``rx.run_live`` on the card against a loopback server of ``blocks``
    paced at ``rate`` samples a second (None: as fast as loopback carries
    them). Returns the run's numbers: blocks sent, received and dropped,
    push_block's wall per block (median, max, the first block's), the
    device span of each process_block (CUDA events before and after it),
    the consumer's busy share of the block period (over all blocks, and
    after the first, which may carry one-time loads), the ring's highest
    fill and the kernels' launches."""
    import torch
    from rtl_433_tpu_torch import api as tapi
    from rtl_433_tpu_torch.io import native, rtltcp
    from rtl_433_tpu_torch.ops import _cuda
    from torch_live_cases import LoopbackRtlTcp

    walls, spans, clients, high = [], [], [], [0]
    real_push, real_pb = rx.push_block, tapi.process_block
    real_run = rtltcp.RtlTcpClient.run

    def push(iq, *a, **k):
        t = time.perf_counter()
        out = real_push(iq, *a, **k)
        walls.append(time.perf_counter() - t)
        return out

    def pb(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_pb(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    def run(self, *a, **k):
        clients.append(self)
        return real_run(self, *a, **k)

    class Ring(native.BlockRing):
        def pop(self):
            high[0] = max(high[0], self.fill)
            return super().pop()

    srv = LoopbackRtlTcp(blocks, rate=rate)
    srv.start()
    rx.push_block = push
    _cuda.reset_launches()
    t = time.perf_counter()
    with patched((tapi, "process_block", pb),
                 (rtltcp.RtlTcpClient, "run", run),
                 (native, "BlockRing", Ring)):
        rx.run_live(srv.device)
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    srv.join(timeout=60)
    rx.push_block = real_push
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    n = len(walls)
    return {"blocks_sent": len(blocks), "blocks": n,
            "blocks_dropped": clients[0].blocks_dropped,
            "ring_high_fill": high[0], "exit_code": rx.exit_code,
            "seconds": wall,
            "launches": {k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS},
            "push_ms": {"median": 1e3 * float(np.median(walls)),
                        "max": 1e3 * max(walls), "first": 1e3 * walls[0]},
            "device_ms": {"median": float(np.median(dev_ms)),
                          "max": max(dev_ms)},
            "busy_share": sum(walls) / (n * N_BLOCK / LIVE_RATE),
            "busy_share_after_first": sum(walls[1:])
            / max(n - 1, 1) / (N_BLOCK / LIVE_RATE),
            "consumer_msps": n * N_BLOCK / sum(walls) / 1e6,
            "wall_msps": n * N_BLOCK / wall / 1e6}


def live_phase(fx, rate_of):
    """The ``live`` phase (module docstring). Returns (lines, the front
    end's and detector's launches on the paced and flat runs)."""
    import torch
    from rtl_433_tpu_torch import cli
    from rtl_433_tpu_torch.api import RtlTpu
    from rtl_433_tpu_torch.io import load_iq
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from torch_live_cases import (LoopbackRtlTcp, Passthrough, dump_argv,
                                  fixed_localtime, free_port, read_dumps,
                                  stream_blocks)
    from torch_replay_cases import fixture, run_cli

    t_phase = time.perf_counter()
    lines, launches = [], {k: 0 for k in REPLAY_KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_live_")

    def events(evs):
        out = []
        for e in evs:
            d = json.loads(event_to_json(e))
            d.pop("time", None)
            out.append(d)
        return out

    def live(name, rate, blocks, served, check=True, **extra):
        rx = RtlTpu(sample_rate=rate, device="cuda")
        row = live_run(rx, blocks, served)
        for k in REPLAY_KERNELS:
            launches[k] += row["launches"][k]
        row = dict({"phase": "live", "stream": name, "rate": rate,
                    "served_msps": served and served / 1e6, **extra}, **row)
        if check:
            path = os.path.join(tmp, f"{name}_433.92M_{rate // 1000}k.cu8")
            np.concatenate(blocks).tofile(path)
            want = events(RtlTpu(device="cuda").decode_file(path))
            got = events(rx.events)
            if got != want:
                fail(f"live {name}: {len(got)} events differ from "
                     f"decode_file's {len(want)}")
            if row["blocks_dropped"] or row["blocks"] != len(blocks):
                fail(f"live {name}: {row['blocks']} of {len(blocks)} "
                     f"blocks, {row['blocks_dropped']} dropped")
            if any(row["launches"][k] != len(blocks)
                   for k in REPLAY_KERNELS):
                fail(f"live {name}: launches {row['launches']} for "
                     f"{len(blocks)} blocks")
            row["events"] = len(got)
        lines.append(row)

    try:
        mixed = {}
        for rate in (1_024_000, 250_000):
            files = [cu8 for _d, _n, cu8, _w in fx if rate_of(cu8) == rate]
            mixed[rate] = stream_blocks(np.concatenate(
                [load_iq(f, "cu8") for f in files]))
            live(f"live_{rate // 1000}k", rate, mixed[rate], LIVE_RATE,
                 fixtures=len(files))
        live("live_flat", 250_000, mixed[250_000], None, check=False)

        # a cold start: run_live in a fresh process (the kernels built)
        srv = LoopbackRtlTcp(mixed[1_024_000][:LIVE_COLD_BLOCKS],
                             rate=LIVE_RATE)
        srv.start()
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", LIVE_COLD, str(srv.port), "1024000",
             HERE], capture_output=True, text=True, timeout=120)
        srv.join(timeout=60)
        if out.returncode != 0:
            fail(f"live cold start: {out.stderr[-2000:]}")
        cold = json.loads(out.stdout.strip().splitlines()[-1])
        lines.append(dict({"phase": "live_cold_start",
                           "blocks_sent": LIVE_COLD_BLOCKS,
                           "process_s": time.perf_counter() - t}, **cold))

        # the CLI on the card against --device cpu: -d with -F rtltcp,
        # every -w format with FM off and on (-S all beside), a .sr session
        secs = {"card": 0.0, "cpu": 0.0}

        def both(what, argv, run):
            res = {}
            for device in ("cuda", "cpu"):
                t = time.perf_counter()
                res[device] = run(device, argv + ["--device", device])
                secs["card" if device == "cuda" else "cpu"] += \
                    time.perf_counter() - t
            if res["cuda"] != res["cpu"]:
                fail(f"live_cli {what}: the card's run differs from "
                     f"--device cpu: {str(res['cuda'])[:600]} vs "
                     f"{str(res['cpu'])[:600]}")
            if res["cuda"][0][0] != 0:
                fail(f"live_cli {what}: {res['cuda'][0]}")
            return res["cuda"]

        def live_cli(device, argv):
            blocks = mixed[1_024_000][:LIVE_CLI_BLOCKS - 1] \
                + mixed[1_024_000][-1:]
            port = free_port()
            reader = Passthrough(port)
            reader.start()
            srv = LoopbackRtlTcp(blocks, gate=reader.connected)
            srv.start()
            res = run_cli(cli.main, ["-d", srv.device, "-F",
                                     f"rtltcp:127.0.0.1:{port}"] + argv)
            reader.done.set()
            srv.join(timeout=60)
            reader.join(timeout=60)
            want = b"".join(b.tobytes() for b in blocks)
            if reader.data[12:] != want:
                fail(f"live_cli on {device}: the passthrough client read "
                     f"{len(reader.data)} bytes, want 12 + {len(want)}")
            return res, srv.commands, reader.data

        def dumps(device, argv, cwd):
            d = os.path.join(cwd, device)
            os.makedirs(d)
            here = os.getcwd()
            os.chdir(d)
            try:
                return run_cli(cli.main, argv), read_dumps(".")
            finally:
                os.chdir(here)

        _cuda.reset_launches()
        cli_runs = {}
        res = both("-d", ["-s", "1024k", "-F", "json", "-M", "level"],
                   live_cli)
        cli_runs["live_events"] = res[0][1].count("\n")
        cap = os.path.join(tmp, "sat_433.92M_250k.cu8")
        np.concatenate([load_iq(fixture("nexus"), "cu8"),
                        np.full((2000, 2), 255, np.uint8)]).tofile(cap)
        with fixed_localtime():
            for fm, argv in (("fm_off", ["-R", "19", "-r", cap]),
                             ("fm_on", ["-R", "75", "-r",
                                        fixture("lacrosse_tx35")])):
                d = os.path.join(tmp, fm)
                os.makedirs(d)
                res = both(f"-w {fm}", argv + ["-F", "json", "-S", "all"]
                           + dump_argv("."),
                           lambda dv, a, _d=d: dumps(dv, a, _d))
                cli_runs[fm] = {k: len(v) for k, v in res[1].items()}
            d = os.path.join(tmp, "sr")
            os.makedirs(d)
            res = both(".sr", ["-R", "75", "-r", fixture("lacrosse_tx35"),
                               "-F", "json", "-w", "session.sr"],
                       lambda dv, a, _d=d: dumps(dv, a, _d))
        cli_runs["sr_members"] = {k: len(v) for k, v in
                                  res[1]["session.sr"].items()}
        cli_launches = {k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS}
        if any(v <= 0 for v in cli_launches.values()):
            fail(f"live_cli: launches {cli_launches}")
        torch.cuda.synchronize()
        lines.append({"phase": "live_cli", "runs": cli_runs,
                      "card_s": secs["card"], "cpu_s": secs["cpu"],
                      "launches": cli_launches, "byte_equal": True,
                      "seconds_total": time.perf_counter() - t_phase,
                      "nvidia_smi": smi_line()})
        return lines, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the outputs phase: fixture directories whose -A text reaches each branch
# of the analyzer's modulation guess (and whether its packages are FSK),
# the blocks of http_retune_live and the block after which its retune is
# answered
ANALYZER_FIXTURES = (
    ("X10_RF", "Pulse Position Modulation with fixed pulse width", False),
    ("acurite_txr", "Pulse Width Modulation with fixed gap", False),
    ("efergy_optical", "Pulse Width Modulation with fixed gap", True),
    ("abmt", "Pulse Width Modulation with multiple packets", False),
    ("oil_standard", "Pulse Width Modulation with multiple packets", True),
    ("calibeur_RF104", "Pulse Width Modulation with sync/delimiter", False),
    ("arexx_ml", "Pulse Width Modulation with sync/delimiter", True),
    ("ambient_weather", "Manchester coding", False),
    ("alps_fwb1u545_car_remote", "Manchester coding", True),
    ("radiohead_ask", "Non Return to Zero coding (Pulse Code)", False),
    ("current_cost", "Non Return to Zero coding (Pulse Code)", True),
    ("hcs361_vpwm_1_bsel_0", "No clue...", False))
RETUNE_BLOCKS = 7
RETUNE_AFTER = 3
RETUNE_HZ = 868_000_000


def analyzer_branches(err):
    """{(guess, FSK flex hint)} of the -A text ``err``."""
    out = set()
    for blk in err.split("Analyzing pulses...")[1:]:
        line = blk.split("Guessing modulation: ", 1)[1].split("\n", 1)[0]
        out.add((line.strip(), "=FSK_" in blk))
    return out


def outputs_phase(fx, rate_of, compare):
    """The ``outputs`` phase (module docstring). Returns (lines, the front
    end's and detector's launches on its runs)."""
    import functools
    import io
    import threading

    import torch
    from rtl_433_tpu_torch import api as tapi
    from rtl_433_tpu_torch import cli
    from rtl_433_tpu_torch.api import RtlTpu
    from rtl_433_tpu_torch.io import load_iq, rtltcp
    from rtl_433_tpu_torch.ops import _cuda
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from rtl_433_tpu_torch.output.http_server import HttpServerSink
    from rtl_433_tpu_torch.output.network import (DataTagger, InfluxSink,
                                                  MqttSink, SyslogSink,
                                                  TriggerSink)
    from rtl_433_tpu_torch.output.sinks import JsonSink
    from torch_live_cases import LoopbackRtlTcp, stream_blocks
    from torch_output_cases import (MQTT_OPTS, Stubs, WsReader, get_json,
                                    hooked, observed, post_json,
                                    run_network_cli, wait_for)
    from torch_replay_cases import fixture, run_cli

    t_phase = time.perf_counter()
    lines, launches = [], {k: 0 for k in REPLAY_KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_outputs_")
    protocols = {d: nums for d, nums, _c, _w in fx}

    def count_launches():
        for k in REPLAY_KERNELS:
            launches[k] += _cuda.LAUNCHES[k]

    try:
        # ---- outputs_cli: file replay through every network sink
        secs = {"card": 0.0, "cpu": 0.0}
        mixed = os.path.join(tmp, "mixed_433.92M_250k.cu8")
        np.concatenate([load_iq(cu8, "cu8") for _d, _n, cu8, _w in fx
                        if rate_of(cu8) == 250_000]).tofile(mixed)
        runs = {"nexus": ["-R", "19", "-r", fixture("nexus")],
                "lacrosse_tx35": ["-R", "75", "-r",
                                  fixture("lacrosse_tx35")],
                "mixed_250k": ["-r", mixed],
                "nexus_deviceslice": ["-R", "19", "-r", fixture("nexus"),
                                      "-Y", "deviceslice"]}
        per_run, calls = {}, []
        _cuda.reset_launches()
        for name, argv in runs.items():
            argv = argv + ["-F", "json"]
            t = time.perf_counter()
            if name.endswith("deviceslice"):
                with ds_recorder(calls):
                    got = run_network_cli(cli.main, argv,
                                          os.path.join(tmp, name, "cuda"))
            else:
                got = run_network_cli(cli.main, argv,
                                      os.path.join(tmp, name, "cuda"))
            torch.cuda.synchronize()
            secs["card"] += time.perf_counter() - t
            t = time.perf_counter()
            want = run_network_cli(cli.main, argv + ["--device", "cpu"],
                                   os.path.join(tmp, name, "cpu"))
            secs["cpu"] += time.perf_counter() - t
            info = (got[1]["http"][0].pop("device_info"),
                    want[1]["http"][0].pop("device_info"))
            if info != ({"driver": "cuda", "backend": "torch"},
                        {"driver": "cpu", "backend": "torch"}):
                fail(f"outputs_cli {name}: device_info {info}")
            if got != want:
                diff = [k for k in got[1] if got[1][k] != want[1][k]]
                fail(f"outputs_cli {name}: the card's run differs from "
                     f"--device cpu: rc/stdout/stderr equal "
                     f"{got[0] == want[0]}, stubs differing {diff}")
            (rc, out, err), seen = got
            if rc != 0 or not out:
                fail(f"outputs_cli {name}: exit code {rc}: {err[-400:]}")
            n_ev = out.count("\n")
            per_run[name] = {
                "events": n_ev, "syslog": len(seen["syslog"]),
                "mqtt_publishes": len(seen["mqtt"]),
                "mqtt_bytes": sum(len(b) for b in seen["mqtt_raw"]),
                "influx_posts": len(seen["influx"]),
                "trigger": len(seen["trigger"] or ""),
                "ws_frames": len(seen["http"][0]["ws"])}
            if not (n_ev == per_run[name]["syslog"] ==
                    per_run[name]["influx_posts"] ==
                    per_run[name]["trigger"] ==
                    per_run[name]["ws_frames"]):
                fail(f"outputs_cli {name}: events per sink {per_run[name]}")
        cli_launches = {k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS}
        ds_launches = {k: _cuda.LAUNCHES[k] for k in ds_kernel_names()}
        count_launches()
        if any(v <= 0 for v in cli_launches.values()) or \
                not any(ds_launches[k] for k in ds_launches
                        if k.startswith("slice_")):
            fail(f"outputs_cli: launches {cli_launches} {ds_launches}")
        checked = ds_check(calls, compare, "outputs_cli with device slicing")
        if any(checked.get(k, 0) < ds_launches[k] for k in ds_launches):
            fail(f"outputs_cli: checked {checked} < launches {ds_launches}")
        lines.append({"phase": "outputs_cli", "runs": per_run,
                      "card_s": secs["card"], "cpu_s": secs["cpu"],
                      "launches": cli_launches,
                      "device_slice_launches": ds_launches,
                      "device_slice_checked": checked, "byte_equal": True,
                      "nvidia_smi": smi_line()})

        # ---- analyzer: -A on a capture of each branch, card against cpu
        t0 = time.perf_counter()
        reached = {}
        _cuda.reset_launches()
        for name, guess, fsk in ANALYZER_FIXTURES:
            argv = ["-r", fixture(name), "-A"]
            for n in protocols[name]:
                argv = ["-R", str(n)] + argv
            got = run_cli(cli.main, argv)
            want = run_cli(cli.main, argv + ["--device", "cpu"])
            if got != want:
                fail(f"analyzer {name}: the card's -A text differs from "
                     f"--device cpu")
            branches = analyzer_branches(got[2])
            if got[0] != 0 or (guess, fsk) not in branches:
                fail(f"analyzer {name}: {guess} (FSK {fsk}) not in "
                     f"{branches}")
            reached[name] = sorted(f"{g}{' (FSK)' if f else ''}"
                                   for g, f in branches)
        an_launches = {k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS}
        count_launches()
        lines.append({"phase": "analyzer", "fixtures": len(reached),
                      "branches": sorted({f"{g}{' (FSK)' if f else ''}"
                                          for _n, g, f in
                                          ANALYZER_FIXTURES}),
                      "reached": reached, "launches": an_launches,
                      "stderr_equal": True,
                      "seconds": time.perf_counter() - t0})

        # ---- http_retune_live: a POST /cmd center_frequency while a block
        # is in flight, through the CLI's -F http, the server paused after
        # block RETUNE_AFTER until the reply
        blk1024 = [b for b in stream_blocks(np.concatenate(
            [load_iq(cu8, "cu8") for _d, _n, cu8, _w in fx
             if rate_of(cu8) == 1_024_000]))]
        blocks = blk1024[:RETUNE_BLOCKS - 1] + blk1024[-1:]

        def retune_run(device):
            served = threading.Event()
            srv = LoopbackRtlTcp(blocks, rate=LIVE_RATE,
                                 pause=(RETUNE_AFTER, served))
            srv.start()
            started = {"n": 0}
            in_flight = threading.Event()
            walls, clients, numbers = [], [], {}
            real_pb, real_push = tapi.process_block, RtlTpu.push_block
            real_run = rtltcp.RtlTcpClient.run

            def pb(*a, **k):
                started["n"] += 1
                if started["n"] == RETUNE_AFTER:
                    in_flight.set()
                return real_pb(*a, **k)

            def push(self, *a, **k):
                t = time.perf_counter()
                out = real_push(self, *a, **k)
                walls.append(time.perf_counter() - t)
                return out

            def run(self, *a, **k):
                clients.append(self)
                return real_run(self, *a, **k)

            def retune(servers):
                in_flight.wait(120)
                wait_for(lambda: servers, timeout=30)
                port = servers[0]["port"]
                t = time.perf_counter()
                numbers["reply"] = post_json(
                    port, "/cmd", {"cmd": "center_frequency",
                                   "val": RETUNE_HZ})
                numbers["cmd_round_trip_ms"] = \
                    (time.perf_counter() - t) * 1e3
                numbers["block_in_flight_at_reply"] = started["n"]
                served.set()

            def second(servers):
                in_flight.wait(120)
                wait_for(lambda: servers, timeout=30)
                t = time.perf_counter()
                numbers["settings"] = get_json(servers[0]["port"],
                                               "/cmd?cmd=settings")
                numbers["settings_round_trip_ms"] = \
                    (time.perf_counter() - t) * 1e3

            argv = ["-d", srv.device, "-s", "1024k", "-F", "json", "-M",
                    "level", "-F", "http:127.0.0.1:0", "--device", device]
            _cuda.reset_launches()
            with patched((tapi, "process_block", pb),
                         (RtlTpu, "push_block", push),
                         (RtlTpu, "run_live", functools.partialmethod(
                             real_live, watchdog_interval=60)),
                         (rtltcp.RtlTcpClient, "run", run)), \
                    hooked("rtl_433_tpu_torch") as servers:
                threads = [threading.Thread(target=f, args=(servers,),
                                            daemon=True)
                           for f in (retune, second)]
                for th in threads:
                    th.start()
                res = run_cli(cli.main, argv)
                for th in threads:
                    th.join(60)
            srv.join(60)
            if device == "cuda":
                torch.cuda.synchronize()
            numbers.update(
                blocks=len(walls), dropped=clients[0].blocks_dropped,
                launches={k: _cuda.LAUNCHES[k] for k in REPLAY_KERNELS},
                first_block_after_retune_ms=1e3 * walls[RETUNE_AFTER]
                if len(walls) > RETUNE_AFTER else None,
                push_ms_median=1e3 * float(np.median(walls)),
                http=servers[0])
            return res, srv.commands, numbers

        real_live = RtlTpu.run_live
        t0 = time.perf_counter()
        got = retune_run("cuda")
        want = retune_run("cpu")
        card = got[2]
        for what, a, b in (("output", got[0], want[0]),
                           ("server commands", got[1], want[1]),
                           ("WebSocket frames", card["http"]["ws"],
                            want[2]["http"]["ws"])):
            if a != b:
                fail(f"http_retune_live: the card's {what} differ from "
                     f"--device cpu")
        if got[0][0] != 0 or card["dropped"] or \
                card["blocks"] != len(blocks) or \
                (0x01, RETUNE_HZ) not in got[1] or \
                card["block_in_flight_at_reply"] != RETUNE_AFTER or \
                any(v != len(blocks) for v in card["launches"].values()):
            fail(f"http_retune_live: rc {got[0][0]}, {card}, commands "
                 f"{got[1]}")
        for k in REPLAY_KERNELS:
            launches[k] += card["launches"][k]
        lines.append({
            "phase": "http_retune_live", "blocks": card["blocks"],
            "dropped": card["dropped"], "retune_after_block": RETUNE_AFTER,
            "events": got[0][1].count("\n"),
            "cmd_reply": card["reply"],
            "cmd_round_trip_ms": card["cmd_round_trip_ms"],
            "first_block_after_retune_ms":
                card["first_block_after_retune_ms"],
            "push_ms_median": card["push_ms_median"],
            "settings_reply": card["settings"],
            "settings_round_trip_ms": card["settings_round_trip_ms"],
            "cpu_cmd_round_trip_ms": want[2]["cmd_round_trip_ms"],
            "launches": card["launches"], "commands": got[1],
            "events_equal_cpu": True,
            "seconds": time.perf_counter() - t0,
            "nvidia_smi": smi_line()})

        # ---- live_sinks: live_250k's stream, every network sink attached,
        # against -F json alone
        files = [cu8 for _d, _n, cu8, _w in fx if rate_of(cu8) == 250_000]
        stream = stream_blocks(np.concatenate(
            [load_iq(f, "cu8") for f in files]))
        rows = {}
        strip = ("time", "lat", "lon", "key")
        evs = {}
        for name in ("json_only", "all_sinks"):
            rx = RtlTpu(sample_rate=250_000, device="cuda")
            buf = io.StringIO()
            rx.sinks.append(JsonSink(file=buf))
            stubs = Stubs(tmp)
            http = []
            if name == "all_sinks":
                topics = dict(kv.split("=", 1)
                              for kv in MQTT_OPTS.split(",")[1:])
                mqtt = MqttSink("127.0.0.1", stubs.broker.port, retain=True,
                                **topics)
                rx.sinks += [SyslogSink("127.0.0.1", stubs.syslog.port),
                             mqtt, InfluxSink(stubs.influx.url),
                             TriggerSink(stubs.trigger)]
                sink = HttpServerSink(rx, "127.0.0.1", 0)
                rx.sinks.append(sink)
                reader = WsReader(sink.server.server_address[1])
                reader.start()
                rx.taggers += [
                    DataTagger(f"gpsd:127.0.0.1:{stubs.gpsd.port},lat,lon"),
                    DataTagger("key=value")]
                wait_for(lambda: rx.taggers[0].client.msg)
            try:
                row = live_run(rx, stream, LIVE_RATE)
            finally:
                if name == "all_sinks":
                    wait_for(lambda: len(reader.frames) >= len(rx.events))
                    reader.close()
                    sink.close()
                    mqtt.close()
                    for tg in rx.taggers:
                        tg.close()
                    http.append({"ws": reader.frames})
                seen = observed(stubs, http)
                stubs.close()
            evs[name] = [{k: v for k, v in json.loads(
                event_to_json(e)).items() if k not in strip}
                for e in rx.events]
            if row["blocks_dropped"] or row["blocks"] != len(stream) or \
                    any(row["launches"][k] != len(stream)
                        for k in REPLAY_KERNELS):
                fail(f"live_sinks {name}: {row}")
            for k in REPLAY_KERNELS:
                launches[k] += row["launches"][k]
            row["events"] = len(rx.events)
            row["json_lines"] = buf.getvalue().count("\n")
            if name == "all_sinks":
                row["per_sink"] = {
                    "syslog": len(seen["syslog"]),
                    "mqtt_publishes": len(seen["mqtt"]),
                    "influx_posts": len(seen["influx"]),
                    "trigger": len(seen["trigger"] or ""),
                    "ws_frames": len(seen["http"][0]["ws"])}
                n = row["events"]
                if any(v < n for k, v in row["per_sink"].items()
                       if k != "mqtt_publishes"):
                    fail(f"live_sinks: events per sink {row['per_sink']} "
                         f"for {n} events")
            rows[name] = row
        if evs["json_only"] != evs["all_sinks"]:
            fail("live_sinks: the events with every sink attached differ "
                 "from -F json alone's")
        for name, row in rows.items():
            lines.append(dict({"phase": "live_sinks", "run": name,
                               "fixtures": len(files)}, **row))
        lines[-1]["nvidia_smi"] = smi_line()
        lines[-1]["seconds_total"] = time.perf_counter() - t_phase
        return lines, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    become_subreaper()
    atexit.register(stop_children)
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

    if "--mic-only" in sys.argv[1:]:
        # the MIC kernel alone (phase 4e), for a comparison with another
        # checkout of the package beside this script
        _cuda.build(["mic"])
        emit(mic_phase(dev, compare, rng)[0])
        return 0
    if "--timeshard-only" in sys.argv[1:]:
        # phase 6c on TS_CHECKED alone, for a comparison with another
        # checkout of the package
        from rtl_433_tpu_torch.decoders import garage
        _cuda.build()
        fx = [(d, nums, cu8, None) for d, nums, cu8 in fixture_cases()]
        real_time = garage.time
        garage.time = types.SimpleNamespace(monotonic=lambda: 0.0)
        try:
            rows, launches, numbers = timeshard_phase(
                dev, compare, fx, rate_of, only=(TS_CHECKED,))
        finally:
            garage.time = real_time
        for r in rows:
            emit(r)
        emit({"phase": "timeshard_only", "launches": launches,
              "numbers": numbers, "nvidia_smi": smi_line()})
        return 0
    if "--replay-cli-only" in sys.argv[1:]:
        # phase 5d alone, for a first check of the CLI on the card
        _cuda.build()
        _native.build()
        get_runner()
        emit(replay_cli_phase(compare)[0])
        return 0
    if "--live-only" in sys.argv[1:]:
        # phase 5e alone, for a first check of live input on the card
        from rtl_433_tpu_torch.decoders import garage
        _cuda.build()
        _native.build()
        _native.build(_native.INGEST_SOURCE)
        get_runner()
        fx = [(d, nums, cu8, None) for d, nums, cu8 in fixture_cases()]
        with patched((garage, "time",
                      types.SimpleNamespace(monotonic=lambda: 0.0))):
            for line in live_phase(fx, rate_of)[0]:
                emit(line)
        return 0
    if "--outputs-only" in sys.argv[1:]:
        # phase 5f alone, for a first check of the outputs on the card
        from rtl_433_tpu_torch.decoders import garage
        _cuda.build()
        _native.build()
        _native.build(_native.INGEST_SOURCE)
        get_runner()
        fx = [(d, nums, cu8, None) for d, nums, cu8 in fixture_cases()]
        with patched((garage, "time",
                      types.SimpleNamespace(monotonic=lambda: 0.0))):
            lines, launches = outputs_phase(fx, rate_of, compare)
        for line in lines:
            emit(line)
        emit({"kernel_launches_outputs": launches,
              "max_abs_err": errs})
        return 0
    if "--compact-only" in sys.argv[1:]:
        # the compaction wrapper and kernel alone at phase 4b's states,
        # for a comparison with another checkout of the package
        _cuda.build(["compact"])
        states, totals = compact_states(dev, compare)
        emit({"phase": "compact_only", "totals": totals, "bit_exact": True,
              "launch_floor_ms": launch_floor_ms(dev),
              "times": {f"{kind}_cap{cap}": compact_measure(ins, cap)
                        for kind, ins in states.items()
                        for cap in (768, 2048)}})
        return 0

    # ---- 2. build
    t = time.perf_counter()
    took = _cuda.build()
    for k in _cuda.LAUNCHERS:
        _cuda.launcher(k)
    t_host = time.perf_counter()
    try:
        slicer_lib = _native.build()
        native_slicers.available()
        ingest_lib = _native.build(_native.INGEST_SOURCE)
    except RuntimeError as e:
        fail(f"a host library did not build: {e}")
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
          "ingest_lib": os.path.basename(ingest_lib),
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
    errs["compact"] = 0
    states, totals = compact_states(dev, compare)
    ctimes = {f"dense_cap{cap}": compact_measure(states["dense"], cap,
                                                 count_kernels=True)
              for cap in (768, 2048)}
    for cap in (768, 2048):
        ctimes[f"dense_cap{cap}"]["host_split"] = compact_host_split(
            states["dense"], cap)
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
    from torch_slice_cases import (BANK_CAPS, SMALL_CAPS, dup_edge_planes,
                                   dup_planes, family_devices, family_trains,
                                   pack)
    fuzz, fuzz_calls, every_family = {}, {}, []
    for i, fam in enumerate(sl.FAMILIES):
        devs = family_devices(fam)
        bounds = getattr(sl, f"{fam}_bounds")(devs, 250_000)
        args = [torch.from_numpy(a).to(dev) for a in
                pack(family_trains(fam, devs, SEED + i, n=48))]
        for cname, caps in (("bank", BANK_CAPS[fam]), ("small", SMALL_CAPS)):
            calls = [("slice", (fam, *args, bounds, caps))]
            ds_check(calls, compare, f"fuzz, {cname} caps")
            got = sl.slice_cuda(fam, *args, bounds, caps)
            group = (got["bytes"], got["syncs"], *(
                rng.integers(0, n, 64 + 3 * i).astype(np.int32)
                for n in got["num_rows"].shape))
            every_family.append(group)
            calls = [("content_dup", ({k: got[k] for k in SLICE_OUTS[:4]},)),
                     ("gather_records", ([group],))]
            ds_check(calls, compare, f"{fam} fuzz output, {cname} caps")
            fuzz[f"{fam}/{cname}"] = {
                "lanes": got["ovf"].numel(), "flagged": int(got["ovf"].sum()),
                "events": int(got["n_events"].sum())}
            if cname == "bank":
                # timed later with the bound table on the card, as the bank
                # keeps it
                tab = torch.from_numpy(sl.bound_table(fam, bounds)).to(dev)
                fuzz_calls[fam] = [("slice", (fam, *args, tab, caps))]
    # the batched gather: every family's fuzz output at both caps (18
    # families of four shapes) in one launch
    ds_check([("gather_records", (every_family,))], compare,
             "every family's fuzz output, one call")
    del every_family
    repeats = {}
    for what, planted in (
            ("planted repeats", dup_planes(SEED, B=5, J=7, E=8, R=6, W=20)),
            ("planted repeats, W=13, R=5",
             dup_edge_planes(SEED, B=64, J=91, E=4, R=5, W=13)),
            ("planted repeats, W=13, R=5, E=8",
             dup_edge_planes(SEED + 1, B=64, J=91, E=8, R=5, W=13))):
        planted = {k: torch.from_numpy(v).to(dev) for k, v in planted.items()}
        ds_check([("content_dup", (planted,))], compare, what)
        E = planted["num_rows"].shape[-1]
        repeats[what] = int((ddp._content_dup(planted).cpu()
                             != torch.arange(E, dtype=torch.int32)).sum())
        if not repeats[what]:
            fail(f"the {what} were not found")
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
    got = dbk.run_torch(bank, *fz_args, fz_ns)
    compare("decl_bank", list(got),
            list(dbk.run_torch_sparse_plain(bank, *fz_args, fz_ns)),
            ("code", "raws"), "fuzz batch, against the sparse emulation")
    code = got[0].cpu().numpy()
    decl_fuzz = ds_measure(decl_fuzz_call)["decl_bank"]
    tabs = dbk.bank_tables(bank, dev)
    emit({"phase": "decl_bank", "candidates": DECL_FUZZ,
          "specs": int(np.unique(fz[2]).size),
          "widths": {"in_bits": bank.in_bits, "frame_bits": bank.frame_bits,
                     "pat_len": bank.pat_len, "n_checks": bank.n_checks,
                     "n_raws": bank.n_raws},
          "codes": {str(c): int((code == c).sum())
                    for c in np.unique(code)},
          "stale_rows": int((fz[3] > fz[1]).sum()),
          "sparse_tables": {"chunks": int(tabs["chunk_dir"].numel()),
                            "entries": int(tabs["entries"].shape[0]),
                            "nonzero": int((tabs["entries"][:, 1] != 0)
                                           .sum()),
                            "bytes": 4 * (tabs["entries"].numel()
                                          + tabs["chunk_dir"].numel()
                                          + tabs["chunk_start"].numel())},
          "bit_exact": True, "max_abs_err": errs["decl_bank"],
          **{k: decl_fuzz[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")}})
    del fz, fz_args, fz_ns, zeroed, decl_fuzz_call, got, tabs

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
    # per path, each device-slicing kernel's device ms summed over every
    # recorded call (the fixtures', each mixed stream's one decode, the
    # dense_4096 drain's)
    ds_ms_by_path = {}
    decl_paths = {}
    # per path, the gather launches of each prewarm (prewarm_gathers)
    ds_gathers = {"fixtures": []}
    fx_calls, fx_dcalls = [], []
    _cuda.reset_launches()
    t = time.perf_counter()
    for d, nums, cu8, want in fx:
        calls = []
        with ds_recorder(calls, fx_dcalls), \
                prewarm_gathers(ds_gathers["fixtures"]):
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
    ds_ms_by_path["fixtures"] = ds_path_ms(
        [c for _d, calls in fx_calls for c in calls])
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

    # ---- 5d. replay_cli: the port's CLI on the card against --device cpu
    rc_line, rc_launches = replay_cli_phase(compare)
    emit(rc_line)
    ds_paths["replay_cli"] = {k: rc_launches[k] for k in ds_kernel_names()}
    launches_cli = {k: rc_launches[k] for k in REPLAY_KERNELS}

    # ---- 5e. live: run_live against loopback rtl_tcp servers, a cold
    # start, the CLI's live run and dumps against --device cpu; on the
    # fixed Security+ clock of the mixed streams
    from rtl_433_tpu_torch.decoders import garage
    with patched((garage, "time",
                  types.SimpleNamespace(monotonic=lambda: 0.0))):
        live_lines, launches_live = live_phase(fx, rate_of)
    for line in live_lines:
        emit(line)

    # ---- 5f. outputs: the network sinks, -K and -A through the CLI, the
    # HTTP server's retune of a live run, the sinks' cost on a live stream
    with patched((garage, "time",
                  types.SimpleNamespace(monotonic=lambda: 0.0))):
        out_lines, launches_outputs = outputs_phase(fx, rate_of, compare)
    for line in out_lines:
        emit(line)

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
        ds_gathers[name] = []
        _cuda.reset_launches()
        with dispatch_timers(acc), split_timers(acc), prewarm_timers(acc), \
                kernel_timers(spans), prewarm_gathers(ds_gathers[name]):
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
        ds_ms_by_path[name] = ds_path_ms(calls)
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
        ds_gathers["dense_4096"] = []
        (row, mc_launches, kinds["compact"], ds_paths["dense_4096"],
         ds_numbers, decl_paths["dense_4096"], warm_blocks) = multichannel(
             dev, mesh, compare, default_ds_kernels, mh_dir,
             ds_gathers["dense_4096"])
        ds_ms_by_path["dense_4096"] = {
            k: {"ms": v["ms"], "calls": v["calls"]}
            for k, v in ds_numbers.items()}
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
            "launches_replay_cli": launches_cli[k],
            "launches_live": launches_live[k],
            "launches_outputs": launches_outputs[k],
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
        # the profiler's count at phase 4b's state at this cap
        "device_kernels_per_call": ctimes["dense_cap768"][
            "device_kernels_per_call"],
        "device_activities": ctimes["dense_cap768"]["device_activities"],
        "host_split": m["host_split"],
        "launch_floor_ms": ts_numbers["timeshard_chain"]["launch_floor_ms"],
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
            "ms_by_path": {p: v[k]["ms"] for p, v in ds_ms_by_path.items()
                           if k in v},
            "calls_by_path": {p: v[k]["calls"]
                              for p, v in ds_ms_by_path.items() if k in v},
            "max_abs_err": errs[k], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "calls": m["calls"],
            "shapes": m["shapes"],
            "launch_floor_ms": ts_numbers["timeshard_chain"][
                "launch_floor_ms"],
            "measured_at": m.get("measured_at", "dense_4096 drain")})
        if k == "slice_pcm" and "split" in m:
            rows[-1]["rate_pass_split"] = m["split"]
        if k == "content_dup":
            # the bound: the bytes the compare must read (dup_live_bytes);
            # beside it the earlier figure, every plane read once
            rows[-1]["bound_all_planes_ms"] = m["bound_all_planes_ms"]
        # the mean device us a call, per path
        rows[-1]["us_per_call_by_path"] = {
            p: 1e3 * v[k]["ms"] / v[k]["calls"]
            for p, v in ds_ms_by_path.items() if k in v and v[k]["calls"]}
        if k == "decl_bank":
            rows[-1].update(
                fuzz={x: decl_fuzz[x] for x in ("ms", "plain_ms",
                                                "bound_ms", "bound_by")},
                fuzz_candidates=DECL_FUZZ, by_path=decl_paths)
        if k == "gather_records":
            # launches per dense_4096 drain (a prewarm each) and per
            # prewarm on every path
            per = {p: gathers_per_prewarm(c) for p, c in ds_gathers.items()}
            rows[-1].update(
                launches_per_drain=ds_paths["dense_4096"][k]
                / max(per["dense_4096"]["prewarms"], 1),
                launches_per_prewarm=per)
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
            "bound_bitserial_ms": m["bound_bitserial_ms"],
            "launch_floor_ms": ts_numbers["timeshard_chain"][
                "launch_floor_ms"],
            "large": m["large"], "measured_at": "mic phase"})
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
        if k == "timeshard_chain":
            rows[-1].update(
                launches_by_D=m["launches_by_D"],
                launch_floor_ms=m["launch_floor_ms"],
                **{f"{x}_by_D": {D: v[x] for D, v in m["by_D"].items()}
                   for x in ("ms", "plain_ms", "bound_ms")})
        else:
            rows[-1].update({x: m[x] for x in (
                "launches_by_D", "launches_copied", "pdl_ms",
                "behind_fill_ms", "behind_fill_pdl_ms", "pair_ms",
                "pair_plain_ms", "pair_host_read_ms", "pair_chain_ms",
                "pair_D", "skip_ms", "skip_plain_ms", "skip_host_read_ms",
                "skip_chain_ms", "skip_D")})
    emit({"processes": {"live_children_stopped": stop_children()}})
    emit({"kernel_launches": launches,
          "kernel_launches_replay_cli": launches_cli,
          "kernel_launches_live": launches_live,
          "kernel_launches_outputs": launches_outputs,
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

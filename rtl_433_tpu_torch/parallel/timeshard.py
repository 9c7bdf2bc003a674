"""Time-axis (sequence) sharding of the pulse-detection engine.

Splits ONE block's sample axis into D segments so that a single channel's
scan is no longer one serial chain over the whole block. The numeric
contracts kept are the block-boundary carries (AM low-pass carry, ref
src/baseband.c:167-168; FM discriminator one-sample carry,
src/baseband.c:263-271; detector FSM continuation,
src/pulse_detect.c:285-289).

Design -- *speculative overlap-save with inductive verification*, as the
JAX package's engine step:

1. The block [C, N, 2] is split into D contiguous segments of S = N / D
   samples. Segment ``d`` also gets an H-sample *halo*: the tail of
   segment ``d-1`` (segment 0 has none).
2. Every segment starts from the *block-incoming* registers (the seed) and
   scans its halo, then its segment. For segment 0 the seed is exact; for
   d > 0 it is wrong, but the detector forgets: the IIRs contract, the
   level estimates re-converge, and the hysteresis FSM re-synchronises at
   the first end-of-package gap inside the halo. ``low_est`` alone keeps
   the parity of its error through a quiet halo, so each segment runs from
   three *hedge candidates*, ``low_est`` - 1, + 0, + 1 (with ``high_est``
   kept consistent while IDLE).
3. **Verification makes the speculation exact, not approximate**: segment
   ``d-1``'s selected final registers are compared with segment ``d``'s
   halo-end registers, the same stream position; the candidate whose
   ``low_est`` matches is selected. If every link matches, then by
   induction from segment 0 every segment ran from the exact sequential
   state, so the concatenated record logs ARE the sequential block's log,
   bit for bit. One mismatch anywhere (a package longer than the halo
   straddling a boundary) makes ``ok`` False, and :class:`TimeShardEngine`
   replays the block on the sequential engine from the untouched pre-block
   state: output is *always* bit-identical to the sequential engine.
4. Write-only counters (``gen``, the overflow diagnostics) cannot converge
   from a stale seed; they are excluded from the compare and *re-based*:
   each segment's generation offset is added to its record keys and EOP
   metadata, and the counters become seed + the segments' increments.

The drain then runs once on the gathered logs -- identical inputs to the
sequential drain, identical outputs.

Segment ``d`` runs on ``mesh.devices[d]``. Entries that compare equal
make one *group*, which runs its segments as lanes: its halos, and its
3 x D_k candidate segments, are lanes of one front-end and one detector
launch each with a per-lane origin (``ops/frontend.py``,
``ops/detector.py``). The front end never reads ``low_est``, so it runs
once per (segment, channel) and the three candidates' detector lanes read
the same am/fm columns. A halo is the tail of the segment before, which
is in the block already, so no device sends another a halo: each group
takes its segments and halos from the block. The chain runs on
``mesh.devices[0]``, where the state lives: the groups' boundary
registers come to it (JAX's ``all_gather``), the verification chain and
the candidate gather are ``csrc/timeshard.cu`` (``ops/timeshard.py``),
and each group gathers its own segments' selected logs, of which only
those travel to ``devices[0]``. On the card every gather is queued
before the host reads the chain's verdict (cross-device copies are
ordered by stream; a gather waits on the card for the chain, and writes
nothing where it failed). ``Mesh([device] * D, ("sp",), (D,))`` is one
group: D halos in one launch, 3D candidate lanes in the next.
``torch.device("cuda")`` and ``torch.device("cuda", 0)`` are two entries
of one card, and so two groups, each with its own launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dsp.engine import (SEG, DetectorParams, _drain_block, _flush,
                          detector_init, process_block)
from ..ops.detector import (KEY_INVALID, M_TYPE, NREG, PKG_NONE, REG_KEYS,
                            ST_IDLE, detector_scan, pack_regs, unpack_regs)
from ..ops.frontend import STATE_KEYS, frontend
from ..ops import timeshard as ots
from ..ops.timeshard import verify_layout
from .sharding import Mesh, ShardedEngine

# State keys that are legitimately different between a speculative run and
# the sequential run even after full convergence:
#   - write-only counters (never read by the FSM transition; re-based)
#   - drain-only buffers the scan never touches
_COUNTER_KEYS = ("gen", "n_ring_ovf", "n_pkg_drop", "n_fsk_ovf")
_DRAIN_ONLY = ("out_p", "out_g", "out_meta", "out_n", "carry_p", "carry_g")

# Registers that are live at every sample -- compared unconditionally.
_VERIFY_ALWAYS = ("lp_y", "lp_x", "fm_y", "fm_phi_prev", "fm_xr", "fm_xi",
                  "ook_state", "lead_in", "low_est", "high_est", "min_high",
                  "eop_spur")
# Package-scoped registers: every one of these is rewritten by the
# package-start reset (ref src/pulse_detect.c:312-323 +
# pulse_detect_fsk_init) before its next read, so while the detector is
# IDLE they hold stale-but-DEAD values that a speculative run cannot know.
# They are compared only where the true (predecessor) state has a package
# open; the unconditional ``ook_state`` compare guarantees both sides agree
# on open-ness itself. The rewind history (hist_p/hist_g) is package-scoped
# too: a classic-FSK rewind only corrects pairs the *current* package
# committed.
_VERIFY_OPEN = ("plen", "max_pulse", "num", "cur_pulse", "ook_f1",
                "pkg_start", "fsk_state", "flen", "f1", "f2", "vmax", "vmin",
                "skip", "fsk_num", "fsk_cur_pulse", "hist_p", "hist_g")


def _verify_keys(params: DetectorParams):
    """Every persistent state key must be classified: returns the sorted
    always-compared and open-compared keys, and raises on any key that is
    in neither list nor skipped."""
    skip = set(_COUNTER_KEYS) | set(_DRAIN_ONLY)
    keys = set(detector_init(params, 1, "cpu")) - skip
    classified = set(_VERIFY_ALWAYS) | set(_VERIFY_OPEN)
    missing = keys - classified
    if missing:
        raise ValueError(f"unclassified detector state keys: {missing}")
    return (tuple(sorted(keys & set(_VERIFY_ALWAYS))),
            tuple(sorted(keys & set(_VERIFY_OPEN))))


class _Group:
    """The segments of one device of the mesh: ``ids`` in order, their
    index on ``devices[0]`` (None where they are one run, taken as a
    view), their halos' predecessors, and the lane-origin base on the
    group's device."""

    def __init__(self, device, ids, dev0):
        self.device = device
        self.ids = ids
        self.halo_ids = [d for d in ids if d > 0]
        i32 = torch.int32
        self.seg_base = torch.tensor(ids, dtype=i32, device=device)
        self.halo_base = torch.tensor(self.halo_ids, dtype=i32,
                                      device=device)
        self.offs = torch.tensor([-1, 0, 1], dtype=i32, device=device)
        self._idx = {}
        for name, rows in (("seg", ids),
                           ("pred", [d - 1 for d in self.halo_ids])):
            run = rows == list(range(rows[0], rows[0] + len(rows))) \
                if rows else True
            self._idx[name] = (rows[0] if rows else 0, len(rows),
                               None if run else torch.tensor(rows,
                                                             device=dev0))

    def take(self, x, dim, name="seg"):
        """Entries of ``x`` along ``dim`` for this group's segments
        (``"pred"``: their halos' predecessors)."""
        first, n, idx = self._idx[name]
        return x.narrow(dim, first, n) if idx is None \
            else x.index_select(dim, idx)

    def rows(self, x):
        """The rows of this group's segments of ``x`` [D, ...]."""
        return self.take(x, 0)


def _segment_groups(mesh: Mesh, axis: str):
    """The groups of the ``axis`` of ``mesh``, one per distinct entry in
    the order of first appearance. Entries are compared as the mesh holds
    them, never by a tensor's device. Raises where they are not all of
    one device type: the step runs every group's kernels, or every
    group's plain versions."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    D = int(mesh.shape[mesh.axis_names.index(axis)])
    if len(mesh.devices) != D:
        raise ValueError(f"a time-shard mesh holds one entry per segment: "
                         f"{len(mesh.devices)} entries, {D} segments")
    types = {torch.device(dev).type for dev in mesh.devices}
    if len(types) > 1:
        raise ValueError(f"a time-shard mesh holds devices of one type, "
                         f"got {sorted(types)}")
    ids = {}
    for d, dev in enumerate(mesh.devices):
        ids.setdefault(dev, []).append(d)
    return [_Group(dev, v, mesh.devices[0]) for dev, v in ids.items()]


def _merge(parts, dim, inv, device):
    """Per-group tensors whose axis ``dim`` runs over the group's segments,
    brought to ``device`` and put in segment order (``inv``: the position
    of each segment in the groups' concatenation, None where that is the
    order already; one group's tensor is taken as it is)."""
    if len(parts) == 1 and inv is None:
        return parts[0].to(device)
    x = torch.cat([p.to(device) for p in parts], dim)
    return x if inv is None else x.index_select(dim, inv)


def _frontend_lanes(params, regs, iq, n_valid, lane_t0):
    """The front end over lanes that each run their own region of the block
    (``lane_t0``, block frame). ``regs`` [NROW, L] in the rows of
    ``ops/timeshard.py``; ``iq`` [L, len, 2]. Returns (the front end's
    final carry rows [6, L], am, fm, avg_db [L])."""
    fe_state = {k: regs[NREG + i] for i, k in enumerate(STATE_KEYS)}
    am, fm, fe_state, avg_db = frontend(
        iq, fe_state, sample_rate=params.sample_rate,
        use_mag_est=params.use_mag_est, enable_fm=params.enable_fm,
        fm_low_pass=params.fm_low_pass, fsk_minmax=params.fsk_minmax,
        n_valid=n_valid, time_major=True, lane_t0=lane_t0)
    fe_rows = torch.stack([fe_state[k] for k in STATE_KEYS])
    return fe_rows, am, fm, avg_db


def _region_fm_carry(fe_rows, iq, n_valid, lane_t0, enable_fm):
    """The JAX engine's FM-carry quirk per region: a region with no valid
    sample carries its own first sample (``_block_scan`` :993-1004, index
    ``clip(local_valid - 1, 0, N - 1)``), where the port's front end keeps
    the incoming carry. Applied to every region so that the verification
    compares what JAX compares; the outgoing carry is set from the whole
    block afterwards, as in the sequential engine."""
    if not enable_fm:
        return fe_rows
    empty = (n_valid - lane_t0) <= 0
    x0 = iq[:, 0].to(torch.int32) - 128                     # [L, 2]
    xr, xi = STATE_KEYS.index("fm_xr"), STATE_KEYS.index("fm_xi")
    fe_rows = fe_rows.clone()
    fe_rows[xr] = torch.where(empty, x0[:, 0], fe_rows[xr])
    fe_rows[xi] = torch.where(empty, x0[:, 1], fe_rows[xi])
    return fe_rows


def timeshard_process_block(params: DetectorParams, mesh: Mesh,
                            axis: str = "sp", halo_chunks: int = 10,
                            flush: bool = False, masked: bool = True,
                            debug: bool = False):
    """Build the time-sharded engine step.

    Returns ``fn(state, iq[, n_valid]) -> (state, avg_db, ok)``. ``iq`` is
    the full block [C, N, 2] on ``mesh.devices[0]``, where ``state`` lives
    and the returned state is made; ``state`` is not modified. ``ok`` (a
    bool) True means the speculation verified and the result is
    bit-identical to :func:`~..dsp.engine.process_block`; False means the
    caller MUST discard the returned state and re-run the block
    sequentially (see :class:`TimeShardEngine`): without ``debug`` the step
    then stops after the chain (and, on the card, the gathers launched
    behind it, which write nothing) and returns the incoming ``state``,
    with ``debug`` it runs to the end as JAX does. With ``debug`` a fourth
    value is the per-link, per-key failure flags, bool ``[D-1, K]`` in the
    order of :func:`~..ops.timeshard.verify_layout`.
    """
    groups = _segment_groups(mesh, axis)
    device = mesh.devices[0]
    D = len(mesh.devices)
    Ts = params.chunk
    if halo_chunks < 1:
        raise ValueError("halo must cover at least one chunk")
    H = halo_chunks * Ts
    # NOTE: the idle lead-in counter saturates after OOK_EST_LOW_RATIO+1
    # samples (1025 at the default ratio); a halo shorter than that can
    # never re-converge it from a fresh seed, so default to 10 chunks.
    vkeys_always, vkeys_open = _verify_keys(params)
    names, rowinfo = verify_layout(vkeys_always, vkeys_open, _COUNTER_KEYS)
    rowinfo = rowinfo.to(device)
    K = len(names)
    R = params.ring
    i32 = torch.int32
    ratio = params.ook_high_low_ratio
    low, high, ook, mh = (REG_KEYS.index(k) for k in (
        "low_est", "high_est", "ook_state", "min_high"))
    # each segment's place in the groups' concatenation
    order = [d for g in groups for d in g.ids]
    inv = None if order == list(range(D)) else torch.tensor(
        [order.index(d) for d in range(D)], device=device)

    def run_group(g, segs, seed, gen0, nv, S):
        """One group's halos, then its segments from three low_est
        candidates each: (start [NROW, D_k*C], fin [NROW, 3*D_k*C], the
        segments' levels [D_k*C], the candidates' logs)."""
        C = segs.shape[0]
        Dk, dev = len(g.ids), g.device
        seed, gen0 = seed.to(dev), gen0.to(dev)
        # segment d starts from its halo-end registers (segment 0: the seed)
        start = seed.repeat(1, Dk)                            # [NROW, Dk*C]
        if g.halo_ids:
            Hk = len(g.halo_ids)
            halo_t0 = (g.halo_base * S - H).repeat_interleave(C)
            halo = g.take(segs, 1, "pred")[:, :, S - H:].transpose(
                0, 1).reshape(Hk * C, H, 2).to(dev).contiguous()
            hseed = seed.repeat(1, Hk)
            fe_rows, am, fm, _ = _frontend_lanes(params, hseed, halo, nv,
                                                 halo_t0)
            det = detector_scan(am, fm, hseed[:NREG].contiguous(),
                                gen0.repeat(Hk), params=params,
                                n_valid=nv, lane_t0=halo_t0)
            fe_rows = _region_fm_carry(fe_rows, halo, nv, halo_t0,
                                       params.enable_fm)
            start[:, (Dk - Hk) * C:] = torch.cat([det[0], fe_rows])

        # the segments, each from its start and three low_est candidates
        seg_t0 = (g.seg_base * S).repeat_interleave(C)
        seg_iq = g.take(segs, 1).transpose(0, 1).reshape(
            Dk * C, S, 2).to(dev).contiguous()
        fe_rows, am, fm, avg = _frontend_lanes(params, start, seg_iq, nv,
                                               seg_t0)
        fe_rows = _region_fm_carry(fe_rows, seg_iq, nv, seg_t0,
                                   params.enable_fm)
        cand = start[:NREG].repeat(1, 3)                      # [NREG, 3DkC]
        cand[low] += g.offs.repeat_interleave(Dk * C)
        cand[high] = torch.where(
            cand[ook] == ST_IDLE,
            torch.maximum(ratio * cand[low], cand[mh]), cand[high])
        regs3, key3, p3, g3, eop3, _ = detector_scan(
            am.repeat(1, 3), fm.repeat(1, 3), cand, gen0.repeat(3 * Dk),
            params=params, n_valid=nv, lane_t0=seg_t0.repeat(3))
        fin = torch.cat([regs3, fe_rows.repeat(1, 3)])
        return start, fin, avg, (key3, p3, g3, eop3)

    def fn(state, iq, n_valid=None):
        C, N, _ = iq.shape
        if N % D:
            raise ValueError("block length must divide the sp mesh axis")
        S = N // D
        if S % Ts:
            raise ValueError("per-segment length must be a chunk multiple")
        if H > S:
            raise ValueError("halo must fit in the neighbour's segment")
        if S > SEG:
            raise ValueError(f"segments of at most {SEG} samples (int32 "
                             f"record keys)")
        nv = N if n_valid is None else int(n_valid)

        # per-call resets -- the same seed for every segment (ref
        # src/pulse_detect.c:283 and :291; mirrors process_block)
        regs = dict(state)
        regs["high_est"] = torch.maximum(regs["high_est"], regs["min_high"])
        regs["eop_spur"] = torch.zeros_like(regs["eop_spur"])
        regs["pkg_start"] = regs["pkg_start"] - nv
        gen0 = regs["gen"].clone()
        seed = torch.cat([pack_regs(regs),
                          torch.stack([regs[k].to(i32) for k in STATE_KEYS])])
        segs = iq.reshape(C, D, S, 2)
        runs = [run_group(g, segs, seed, gen0, nv, S) for g in groups]

        # the groups' boundary registers to devices[0] in the chain's lane
        # layout (JAX's all_gather); one group's are already there
        nrow = seed.shape[0]
        start = _merge([r[0].view(nrow, -1, C) for r in runs], 1, inv,
                       device).view(nrow, D * C)
        fin = _merge([r[1].view(nrow, 3, -1, C) for r in runs], 2, inv,
                     device).view(nrow, 3 * D * C)
        avg = _merge([r[2].view(-1, C) for r in runs], 0, inv, device)
        # verification chain, candidate select, generation rebase: on the
        # card every launch is queued before the one read of the verdict
        (_, _, out, by_key, _), ok, logs = ots.timeshard_chain_gather(
            start, fin, rowinfo,
            [(g.device, g.rows, r[3]) for g, r in zip(groups, runs)], D=D,
            ratio=ratio, R=R, debug=debug)
        if logs is not None:
            # the selected logs to devices[0], segment d at d*G..
            d0 = len(groups[0].ids)
            G, (_, GE, F) = logs[0][0].shape[1] // d0, logs[0][3].shape
            GE //= d0
            planes = [_merge([lg[i].view(C * R, -1, G) for lg in logs], 1,
                             inv, device).view(C * R, D * G)
                      for i in range(3)]
            logs = (*planes, _merge([lg[3].view(C, -1, GE, F)
                                     for lg in logs], 1, inv,
                                    device).view(C, D * GE, F))
        # the level is the mean of the segments' levels (JAX's pmean)
        avg_db = avg.view(D, C).mean(0)
        if logs is None:
            # the caller discards a failed step's result and replays the
            # block: skip the flush and drain
            return state, avg_db, False
        log_key, log_p, log_g, eop_log = logs

        regs = unpack_regs(out[:NREG], regs)
        for i, k in enumerate(STATE_KEYS):
            regs[k] = out[NREG + i]
        if flush:
            regs, frow = _flush(params, regs, nv, gen0)
            log_key = torch.cat([log_key, frow[0].reshape(-1, 1)], 1)
            log_p = torch.cat([log_p, frow[1].reshape(-1, 1)], 1)
            log_g = torch.cat([log_g, frow[2].reshape(-1, 1)], 1)
            eop_log = torch.cat([eop_log, frow[3]], 1)
        has_work = bool((log_key < KEY_INVALID).any()
                        | (eop_log[:, :, M_TYPE] != PKG_NONE).any())
        if has_work:
            regs = _drain_block(params, regs, log_key, log_p, log_g,
                                eop_log, gen0)
        # the FM discriminator carry is the block's last valid sample, as
        # the sequential front end leaves it (a block with none keeps it)
        if params.enable_fm and nv > 0:
            last = min(nv, N) - 1
            regs["fm_xr"] = iq[:, last, 0].to(i32) - 128
            regs["fm_xi"] = iq[:, last, 1].to(i32) - 128
        elif params.enable_fm:
            regs["fm_xr"], regs["fm_xi"] = state["fm_xr"], state["fm_xi"]
        if debug:
            bits = torch.arange(K, device=device)
            flags = ((by_key[:, None].long() >> bits) & 1).bool()
            return regs, avg_db, ok, flags
        return regs, avg_db, ok

    if masked:
        return fn
    return lambda state, iq: fn(state, iq, None)


class TimeShardEngine(ShardedEngine):
    """A (possibly single-channel) engine whose *sample axis* is sharded.

    Same surface as :class:`~.sharding.ShardedEngine` (push / take_packages
    / drain_events), but each pushed block is split into time segments.
    Every block's speculation is verified; a failure (a package longer
    than the halo straddling a segment boundary, a level estimate still
    more than one step off at a halo's end) falls back to the sequential
    engine, so the event stream is ALWAYS bit-identical to the unsharded
    engine. ``fallbacks`` counts the blocks that took the
    sequential path, ``verified`` those that did not.
    """

    def __init__(self, params: DetectorParams, channels: int = 1,
                 mesh: Optional[Mesh] = None, axis: str = "sp",
                 halo_chunks: int = 10, registry=None,
                 center_frequency: float = 433_920_000.0,
                 pkg_cap_total: int = 2048):
        if mesh is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TimeShardEngine: no CUDA GPU is available (pass mesh=, "
                    "e.g. Mesh([torch.device('cpu')] * 8, ('sp',), (8,)))")
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            mesh = Mesh(devs, (axis,), (len(devs),))
        step = timeshard_process_block(
            params, mesh, axis=axis, halo_chunks=halo_chunks, flush=False)
        flush_step = timeshard_process_block(
            params, mesh, axis=axis, halo_chunks=halo_chunks, flush=True)
        # the state, harvest and decode of a ShardedEngine on the
        # mesh's first device, where the chain runs
        super().__init__(params, channels,
                         Mesh([mesh.devices[0]], ("ch",), (1,)),
                         registry=registry, center_frequency=center_frequency,
                         pkg_cap_total=pkg_cap_total)
        self.mesh = mesh
        self.axis = axis
        self._step = step
        self._flush_step = flush_step
        self.fallbacks = 0
        self.verified = 0

    def push(self, iq, n_valid=None, flush: bool = False):
        """Feed one [C, N, 2] CU8 block, time-sharded."""
        if n_valid is None:
            n_valid = iq.shape[1]
        if self._undrained:
            self._harvest()
        self._base = self._stream_pos
        self._stream_pos += int(n_valid)
        self._undrained = True
        device = self.mesh.devices[0]
        if isinstance(iq, np.ndarray):
            iq = torch.from_numpy(np.ascontiguousarray(iq))
        iq = iq.to(device)
        step = self._flush_step if flush else self._step
        prev_state = self.shards[0]
        new_state, avg_db, ok = step(prev_state, iq, int(n_valid))
        if ok:
            self.verified += 1
        else:
            # speculation failed (package longer than the halo crossed a
            # segment boundary): replay this block on the sequential engine
            # from the untouched pre-block state -- output stays
            # bit-identical
            self.fallbacks += 1
            new_state, avg_db = process_block(self.params, prev_state, iq,
                                              int(n_valid), flush=flush)
        self.shards = [new_state]
        self.noise_floor_db = float(avg_db.mean())
        return avg_db

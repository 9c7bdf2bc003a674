"""The pulse-detection engine over [channels, samples] blocks.

The GPU re-cast of rtl_433's per-sample hot loops (ref
src/r_flow.c:104-372): AM low-pass IIR, FM low-pass IIR, the 4-state OOK
hysteresis machine (ref src/pulse_detect.c:199-483) and the FSK trackers
(ref src/pulse_detect_fsk.c), with exact C integer semantics so pulse
trains match the reference bit for bit.

A block runs in three passes:

- the fused front end (``ops/frontend.py``, one CUDA kernel) turns the CU8
  block into filtered time-major am/fm streams;
- the detector scan (``ops/detector.py``, one CUDA kernel, one warp lane
  per channel) walks the samples and emits each 128-sample chunk's ring of
  committed pulse/gap records and its EOP metadata as a record log;
- the drain (:func:`_drain_block`, plain torch) compacts the log, drops
  FSK-rewind duplicates, assigns finished packages to output slots and
  rebuilds the carry of the still-open package.

Published packages are in ``state["out_*"]``; :func:`take_packages`
fetches them to the host, or :func:`compact_packages` (one CUDA kernel)
gathers them into dense rows first and :func:`packages_from_compact` reads
only those rows. Caps and overflows are counted in diagnostics
rather than silently lost. Sequential state carried across blocks: IIR
carries, detector FSM state, the open package's pulse train, lead-in
counter, level estimates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import baseband
from ..ops.detector import (
    FSK_FH, FSK_INIT, KEY_FSK_SHIFT, KEY_IDX_BITS, KEY_INVALID, M_END, M_F1,
    M_F2, M_GEN, M_HIGH, M_LOW, M_NUM, M_START, M_TYPE, META_FIELDS,
    PD_MAX_PULSES, PD_MIN_PULSE_SAMPLES, PD_MIN_PULSES, PKG_FSK, PKG_NONE,
    PKG_OOK, ST_GAP, ST_GAP_START, ST_IDLE, ST_PULSE, detector_scan,
    pack_regs, unpack_regs)
from ..ops import compact as _compact
from ..ops.frontend import frontend

# Dedup window after validity compaction: between a record and its
# FSK-rewind recommit only other commits can intervene, and the rewind
# history is 4 deep (ref src/pulse_detect_fsk.c:81-89), so the same key
# recurs at distance <= 4. Window 8 = 2x margin.
_DEDUP_WINDOW = 8

# blocks longer than this are segmented so record keys stay int32
SEG = 1 << 17


class DetectorParams(NamedTuple):
    """Static detector configuration (the fields of the JAX engine's).

    Levels follow pulse_detect_set_levels (ref src/pulse_detect.c:86-105)
    with rtl_433 defaults fixed=0, min=-12.1442 dB, snr=9 dB
    (ref src/r_api.c:153-156). ``unroll``, ``pallas_frontend`` and
    ``chan_groups`` tune the TPU engine and have no effect here.
    """
    sample_rate: int = 250_000
    use_mag_est: bool = False
    fsk_minmax: bool = False          # False = "classic" detector
    enable_fm: bool = True
    fixed_high_level: float = 0.0     # dB, <0 enables manual override
    min_high_level: float = -12.1442  # dB
    high_low_ratio: float = 9.0       # dB
    fm_low_pass: float = 0.0          # 0 = auto (0.2 minmax / 0.1 classic)
    chunk: int = 128                  # samples per record-ring chunk
    ring: int = 8                     # records per chunk per channel
                                      # (overflow counted in n_ring_ovf)
    eops: int = 2                     # EOP records per chunk per channel
    pkg_cap: int = 8                  # published packages kept per block
    max_pulses: int = PD_MAX_PULSES
    unroll: int = 1
    pallas_frontend: bool = False
    arena: int = 32768                # records per block, all channels,
                                      # the drain publishes (overflow
                                      # counted in n_ring_ovf)
    chan_groups: int = 128

    @property
    def ook_fixed_high_level(self) -> int:
        if self.fixed_high_level >= 0.0:
            return 0
        f = baseband.db_to_mag if self.use_mag_est else baseband.db_to_amp
        return f(self.fixed_high_level)

    @property
    def ook_min_high_level(self) -> int:
        f = baseband.db_to_mag if self.use_mag_est else baseband.db_to_amp
        return f(self.min_high_level)

    @property
    def ook_high_low_ratio(self) -> int:
        f = baseband.db_to_mag_f if self.use_mag_est else baseband.db_to_amp_f
        return f(self.high_low_ratio)


def detector_init(params: DetectorParams, channels: int, device="cuda"):
    """Fresh per-channel detector state (ref pulse_detect_reset,
    src/pulse_detect.c:74-84, and pulse_detect_fsk_init :26-32): a dict of
    int32 tensors on ``device``."""
    C = channels
    cap = params.pkg_cap
    mp = params.max_pulses

    def i32(v=0, shape=(C,)):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return {
        # IIR carries (ref src/baseband.c:167-168, :267-271)
        "lp_y": i32(), "lp_x": i32(),
        "fm_y": i32(), "fm_phi_prev": i32(),
        "fm_xr": i32(), "fm_xi": i32(),
        # OOK FSM
        "ook_state": i32(ST_IDLE), "plen": i32(), "max_pulse": i32(),
        "lead_in": i32(), "low_est": i32(), "high_est": i32(),
        # minimum high-level estimate, raw units
        # (pulse_detect_set_levels, ref src/pulse_detect.c:86-105)
        "min_high": i32(params.ook_min_high_level),
        "num": i32(), "cur_pulse": i32(), "ook_f1": i32(),
        "pkg_start": i32(), "eop_spur": i32(), "gen": i32(),
        # FSK tracker
        "fsk_state": i32(FSK_INIT), "flen": i32(),
        "f1": i32(), "f2": i32(),
        "vmax": i32(-32768), "vmin": i32(32767), "skip": i32(40),
        "fsk_num": i32(), "fsk_cur_pulse": i32(),
        # classic-rewind history (last 4 committed pairs, newest first)
        "hist_p": i32(0, (C, 4)),
        "hist_g": i32(0, (C, 4)),
        # cross-block carry of the open package's pulse train
        # (dim1: 0 = OOK package, 1 = FSK package)
        "carry_p": i32(0, (C, 2, mp)),
        "carry_g": i32(0, (C, 2, mp)),
        # published packages
        "out_p": i32(0, (C, cap, mp)),
        "out_g": i32(0, (C, cap, mp)),
        "out_meta": i32(0, (C, cap, META_FIELDS)),
        "out_n": i32(),
        # diagnostics
        "n_ring_ovf": i32(), "n_pkg_drop": i32(), "n_fsk_ovf": i32(),
    }


def _block_scan(params: DetectorParams, regs, iq, n_valid, gen0, t0=0,
                streams=False):
    """Front end + detector scan over one contiguous region.

    ``regs`` has the per-call resets applied. ``t0`` is the block-frame
    position of ``iq[:, 0]``: validity masking, record positions and
    ``pkg_start`` stamps all use ``t0 + local_index``. ``n_valid`` stays in
    the block frame; ``gen0`` is the block-incoming package generation the
    record keys are made relative to.

    Returns ``(regs, log_key, log_p, log_g, eop_log, avg_db)`` with logs in
    temporal order for this region, and with ``streams`` a seventh item:
    channel 0's filtered am and fm over the region's valid samples, int16
    ``[2, n]`` on the host (see :func:`process_block`).
    """
    C, N, _ = iq.shape
    if N % params.chunk or N > SEG:
        # N <= SEG keeps record keys int32 (see process_block)
        raise ValueError(f"region of {N} samples: must be a multiple of "
                         f"chunk={params.chunk} and at most {SEG}")
    local_valid = None if n_valid is None else min(max(n_valid - t0, 0), N)
    am, fm, regs, avg_db = frontend(
        iq, regs, sample_rate=params.sample_rate,
        use_mag_est=params.use_mag_est, enable_fm=params.enable_fm,
        fm_low_pass=params.fm_low_pass, fsk_minmax=params.fsk_minmax,
        n_valid=local_valid, time_major=True)
    packed, log_key, log_p, log_g, eop_log, _ = detector_scan(
        am, fm, pack_regs(regs), gen0, params=params, n_valid=n_valid, t0=t0)
    out = (unpack_regs(packed, regs), log_key, log_p, log_g, eop_log, avg_db)
    if not streams:
        return out
    n = N if local_valid is None else local_valid
    # one copy to the host; with FM off fm is the int32 estimator, which
    # wraps to int16 (32768 -> -32768) as the JAX package's dump writes it
    both = torch.stack([am[:n, 0], fm[:n, 0].to(torch.int16)])
    return out + (both.cpu().numpy(),)


def preload(device) -> None:
    """Load the libraries of the kernels :func:`_block_scan` launches on
    ``device`` ahead of the first block (nothing for the CPU, whose
    tensors take the plain versions)."""
    if torch.device(device).type == "cuda":
        from ..ops import _cuda
        for name in ("frontend", "detector_scan"):
            _cuda.launcher(name)


def _ring_keys(tag, idx, gen0):
    """Ring slots -> record keys (invalid slots get KEY_INVALID)."""
    valid = (tag & 1) == 1
    fsk = (tag >> 1) & 1
    relgen = (tag >> 2) - gen0[:, None]
    key = fsk * KEY_FSK_SHIFT + relgen * (1 << KEY_IDX_BITS) + idx
    return torch.where(valid, key, torch.full_like(key, KEY_INVALID))


def _flush(params: DetectorParams, r, N, gen0):
    """EOF flush (len==0 call, ref src/pulse_detect.c:203-278): finalize any
    partial package so file decodes match streaming decodes. Returns the
    state and the flush record/EOP log rows to append to the block log."""
    st = r["ook_state"]
    r = dict(r)
    R = params.ring
    zero = torch.zeros_like(st)

    def w(c, a, b):
        return torch.where(c, a, b)

    in_pulse = st == ST_PULSE
    spur = in_pulse & (r["plen"] < PD_MIN_PULSE_SAMPLES)
    spur_gap = spur & (r["num"] > 1)
    p_ok = in_pulse & ~spur
    # store pulse width, fall through to GAP_START (ref :222-227); the
    # spurious-with-data path also falls through the GAP_START body
    cur_pulse = w(p_ok, r["plen"], r["cur_pulse"])
    eff_gap_start = (st == ST_GAP_START) | p_ok | spur_gap
    # FSK classification (ref :236-254)
    fsk_pub = eff_gap_start & (r["fsk_num"] > PD_MIN_PULSES)
    wrap_valid = torch.zeros_like(st, dtype=torch.bool)
    wrap_p = wrap_g = zero
    fsk_final = r["fsk_num"]
    if not params.fsk_minmax:
        # classic wrap_up (ref src/pulse_detect_fsk.c:143-156)
        can = fsk_pub & (r["fsk_num"] < params.max_pulses)
        wlen = r["flen"] + 1
        at_fh = r["fsk_state"] == FSK_FH
        wrap_valid = can
        wrap_p = w(at_fh, wlen, r["fsk_cur_pulse"])
        wrap_g = w(at_fh, zero, wlen)
        fsk_final = w(can, r["fsk_num"] + 1, r["fsk_num"])
    # OOK fallthrough to GAP publish (ref :263-272)
    ook_pub = (eff_gap_start & ~fsk_pub) | (st == ST_GAP)
    ook_final = w(ook_pub, r["num"] + 1, r["num"])

    commit_valid = ook_pub | wrap_valid
    commit_idx = w(ook_pub, r["num"], r["fsk_num"])
    commit_p = w(ook_pub, cur_pulse, wrap_p)
    # in the spurious-gap case C stores gap = pulse_length (the short
    # pulse); in the PULSE fallthrough pulse_length was just consumed as
    # the pulse width and C stores 0
    commit_g = w(ook_pub, r["plen"], wrap_g)
    commit_g = w(p_ok & ~fsk_pub, zero, commit_g)
    commit_fsk = ~ook_pub & wrap_valid
    tag = w(commit_valid,
            1 + commit_fsk.to(torch.int32) * 2 + (r["gen"] << 2), zero)

    # one R-wide ring group (slots >= 1 are invalid-key padding), so the
    # appended row keeps the log chunk-group aligned
    def ring(v):
        out = torch.zeros((st.shape[0], R), dtype=torch.int32,
                          device=st.device)
        out[:, 0] = v
        return out

    pub = ook_pub | fsk_pub
    meta = torch.stack([
        w(pub, w(fsk_pub, zero + PKG_FSK, zero + PKG_OOK), zero),
        w(fsk_pub, fsk_final, ook_final),
        r["low_est"], r["high_est"],
        w(fsk_pub, r["f1"], r["ook_f1"]),
        w(fsk_pub, r["f2"], zero),
        r["pkg_start"], zero + N, r["gen"],
    ], dim=-1)
    frow = (_ring_keys(ring(tag), ring(commit_idx), gen0), ring(commit_p),
            ring(commit_g), meta[:, None, :])
    r["ook_state"] = w(in_pulse | eff_gap_start | (st == ST_GAP) | spur_gap,
                       zero + ST_IDLE, r["ook_state"])
    return r, frow


def _drain_block(params: DetectorParams, r, log_key, log_p, log_g, eop_log,
                 gen0):
    """End-of-block publish + carry rebuild.

    log_key/log_p/log_g: [C*R, G] record log -- row c*R+i holds ring slot i
    of channel c, column g is the chunk (temporal order). eop_log:
    [C, Et, META_FIELDS] EOP metadata in temporal order.

    The log is compacted into a flat [arena] record list: ring writes are
    front-compacted within each chunk's R-slot group, so every record's
    rank follows from two exclusive cumsums (records per group, records per
    channel), and a binary search over each channel's group bases finds the
    source slot of every arena position. Then keep-last dedup (FSK-rewind
    recommits), EOP -> slot assignment under ``pkg_cap``, carry prefill,
    the record scatters and the carry rebuild.
    """
    r = dict(r)
    dev = log_key.device
    cap = params.pkg_cap
    mp = params.max_pulses
    gshift = 1 << KEY_IDX_BITS
    R = params.ring
    CR, G = log_key.shape
    C = CR // R
    F = params.arena
    i32 = torch.int32

    # ---- record ranks from cumsums: within a group, valid slots occupy
    # positions 0..w-1 in temporal order; groups are temporal too
    valid = log_key < KEY_INVALID
    w = valid.view(C, R, G).sum(1, dtype=i32)                # [C, G]
    gbase = torch.cumsum(w, 1, dtype=i32) - w                # exclusive
    counts = gbase[:, -1] + w[:, -1]                         # [C]
    bases = torch.cumsum(counts, 0, dtype=i32) - counts      # exclusive
    total = bases[-1] + counts[-1]
    # arena overflow (>F records in one block, all channels) is counted and
    # surfaced by the api's warning
    r["n_ring_ovf"] = r["n_ring_ovf"].clone()
    r["n_ring_ovf"][0] += torch.clamp(total - F, min=0)

    # arena slot -> (channel, within-channel rank, group, slot in group)
    j = torch.arange(F, dtype=i32, device=dev)
    ok_j = j < torch.clamp(total, max=F)
    c_of = (torch.searchsorted(bases, j, right=True).to(i32) - 1).clamp(
        0, C - 1)
    q = j - bases[c_of.long()]
    gb_flat = gbase.reshape(-1)
    lo = torch.zeros_like(j)
    hi = torch.full_like(j, G - 1)
    for _ in range(max(1, (G - 1).bit_length())):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        le = gb_flat[(c_of * G + mid).long()] <= q
        lo = torch.where(le, mid, lo)
        hi = torch.where(le, hi, mid - 1)
    i_of = q - gb_flat[(c_of * G + lo).long()]
    src = ((c_of * R + i_of).to(torch.int64) * G + lo).clamp(0, CR * G - 1)
    a_key = torch.where(ok_j, log_key.reshape(-1)[src],
                        torch.full_like(j, KEY_INVALID))
    a_p = log_p.reshape(-1)[src]
    a_g = log_g.reshape(-1)[src]

    # keep-last dedup (FSK-rewind recommits recur within _DEDUP_WINDOW
    # intervening commits; a same-key match in another channel is excluded
    # by comparing c_of)
    keep = a_key < KEY_INVALID
    for d in range(1, _DEDUP_WINDOW + 1):
        nk = torch.cat([a_key[d:], torch.full((d,), -1, dtype=i32,
                                              device=dev)])
        nc = torch.cat([c_of[d:], torch.full((d,), -1, dtype=i32,
                                             device=dev)])
        keep = keep & ~((a_key == nk) & (c_of == nc))

    rec_fsk = torch.div(a_key, KEY_FSK_SHIFT, rounding_mode="floor")
    rem = a_key - rec_fsk * KEY_FSK_SHIFT
    rec_relg = torch.div(rem, gshift, rounding_mode="floor")
    rec_idx = rem - rec_relg * gshift

    # EOP -> output slot assignment (temporal order, capped at pkg_cap).
    # Each (channel, slot) receives at most one EOP, so the JAX engine's
    # per-slot select is a scatter of the assigned EOP rows.
    et_valid = eop_log[:, :, M_TYPE] != PKG_NONE
    eop_ord = torch.cumsum(et_valid.to(i32), 1, dtype=i32) - 1
    slot = r["out_n"][:, None] + eop_ord
    can = et_valid & (slot < cap)
    r["n_pkg_drop"] = r["n_pkg_drop"] + (et_valid & ~can).sum(1, dtype=i32)
    new_out_n = r["out_n"] + et_valid.sum(1, dtype=i32)

    ce, ee = torch.nonzero(can, as_tuple=True)
    se = slot[ce, ee].long()
    meta_rows = eop_log[ce, ee]                               # [K, 9]
    side = (meta_rows[:, M_TYPE] == PKG_FSK).to(i32)
    relg = torch.clamp(meta_rows[:, M_GEN] - gen0[ce], min=0)
    has_tab = torch.zeros((C, cap), dtype=torch.bool, device=dev)
    side_tab = torch.zeros((C, cap), dtype=i32, device=dev)
    relg_tab = torch.full((C, cap), -1, dtype=i32, device=dev)
    has_tab[ce, se] = True
    side_tab[ce, se] = side
    relg_tab[ce, se] = relg
    out_meta = r["out_meta"].clone()
    out_meta[ce, se] = meta_rows
    # prefill the slot with the cross-block carry when the package started
    # before this block (relgen == 0), else zeros
    use_carry = (relg == 0)[:, None]
    fb_p = r["carry_p"][ce, side.long()]
    fb_g = r["carry_g"][ce, side.long()]
    out_p = r["out_p"].clone()
    out_g = r["out_g"].clone()
    out_p[ce, se] = torch.where(use_carry, fb_p, torch.zeros_like(fb_p))
    out_g[ce, se] = torch.where(use_carry, fb_g, torch.zeros_like(fb_g))
    r["out_n"] = new_out_n

    # record -> slot mapping on the arena ([F, cap] compare)
    cl = c_of.long()
    match = (has_tab[cl] & (side_tab[cl] == rec_fsk[:, None])
             & (relg_tab[cl] == rec_relg[:, None]))           # [F, cap]
    rec_slot = torch.where(match.any(1), match.to(i32).argmax(1).to(i32),
                           torch.full_like(j, cap))
    rec_slot = torch.where(keep, rec_slot, torch.full_like(j, cap))

    # carry rebuild: the still-open package's records (gen after the scan)
    rel_last = torch.clamp(r["gen"] - gen0, min=0)
    keep_carry = (rel_last == 0)[:, None, None]
    carry_p = torch.where(keep_carry, r["carry_p"],
                          torch.zeros_like(r["carry_p"]))
    carry_g = torch.where(keep_carry, r["carry_g"],
                          torch.zeros_like(r["carry_g"]))
    is_open = keep & (rec_relg == rel_last[cl])
    carry_side = torch.where(is_open, rec_fsk, torch.full_like(j, 2))

    # deduped records have unique targets; out-of-range ones are dropped
    in_rng = (rec_idx >= 0) & (rec_idx < mp)
    pub = keep & (rec_slot < cap) & in_rng
    out_p[cl[pub], rec_slot[pub].long(), rec_idx[pub].long()] = a_p[pub]
    out_g[cl[pub], rec_slot[pub].long(), rec_idx[pub].long()] = a_g[pub]
    opn = keep & (carry_side < 2) & in_rng
    carry_p[cl[opn], carry_side[opn].long(), rec_idx[opn].long()] = a_p[opn]
    carry_g[cl[opn], carry_side[opn].long(), rec_idx[opn].long()] = a_g[opn]
    r.update(out_p=out_p, out_g=out_g, out_meta=out_meta, carry_p=carry_p,
             carry_g=carry_g)
    return r


def process_block(params: DetectorParams, state, iq, n_valid=None,
                  flush: bool = False, streams: bool = False):
    """Process one IQ block for all channels; returns (state, avg_db), and
    with ``streams`` (state, avg_db, am_fm).

    iq: uint8 [C, N, 2] (cu8) on the state's device. The pipeline is the
    equivalent of push_sdr_flow (ref src/r_flow.c:104-372): AM estimation
    -> AM low-pass -> FM discrimination + low-pass -> pulse detection ->
    package publish.

    N must be a multiple of params.chunk; ``n_valid`` (int) marks the real
    sample count -- padded tail samples are no-ops, so any padding value
    works and file tails match the reference exactly. Published packages
    are in state["out_*"]; callers fetch + reset via :func:`take_packages`.

    ``am_fm`` is channel 0's filtered am and fm streams over the valid
    samples, int16 ``[2, n_valid or N]`` on the host: the front end's own
    outputs (the kernel's on the card), which the ``-w`` am/fm dumpers
    write (ref src/r_flow.c:439-455). With FM off its fm row is the raw
    AM estimator truncated to int16.
    """
    C, N, _ = iq.shape
    if N % params.chunk:
        raise ValueError(f"block of {N} samples: must be a multiple of "
                         f"chunk={params.chunk}")
    if n_valid is not None:
        n_valid = int(n_valid)

    # segment very large blocks so record keys stay int32; state threads
    # through, flush only on the last segment
    if N > SEG:
        avgs = []
        parts = []
        off = 0
        while off < N:
            seg_n = min(SEG, N - off)
            seg_valid = None
            if n_valid is not None:
                seg_valid = min(max(n_valid - off, 0), seg_n)
            last = off + seg_n >= N
            state, avg_db, *part = process_block(
                params, state, iq[:, off:off + seg_n].contiguous(), seg_valid,
                flush=flush and last, streams=streams)
            avgs.append(avg_db)
            parts += part
            off += seg_n
        avg_db = torch.stack(avgs).mean(0)
        if streams:
            return state, avg_db, np.concatenate(parts, 1)
        return state, avg_db

    # per-call resets (ref src/pulse_detect.c:283 and :291)
    regs = dict(state)
    regs["high_est"] = torch.maximum(regs["high_est"], regs["min_high"])
    regs["eop_spur"] = torch.zeros_like(regs["eop_spur"])
    # age package-start positions: previous block's starts become negative
    regs["pkg_start"] = regs["pkg_start"] - (N if n_valid is None
                                             else n_valid)

    gen0 = regs["gen"].clone()
    regs, log_key, log_p, log_g, eop_log, avg_db, *am_fm = _block_scan(
        params, regs, iq, n_valid, gen0, streams=streams)

    if flush:
        regs, frow = _flush(params, regs, N if n_valid is None else n_valid,
                            gen0)
        # append the flush ring as one extra chunk-group column
        log_key = torch.cat([log_key, frow[0].reshape(-1, 1)], 1)
        log_p = torch.cat([log_p, frow[1].reshape(-1, 1)], 1)
        log_g = torch.cat([log_g, frow[2].reshape(-1, 1)], 1)
        eop_log = torch.cat([eop_log, frow[3]], 1)

    # skip the whole publish pass when the block produced no records and
    # no EOPs (the noise case); one device-to-host read per block
    has_work = bool((log_key < KEY_INVALID).any()
                    | (eop_log[:, :, M_TYPE] != PKG_NONE).any())
    if has_work:
        regs = _drain_block(params, regs, log_key, log_p, log_g, eop_log,
                            gen0)
    return (regs, avg_db, *am_fm)


def take_packages(state):
    """Host-side: pull published packages out of the state and reset slots.

    Returns (list of package dicts, new_state).
    """
    out_n = state["out_n"].cpu().numpy()
    cap = state["out_p"].shape[1]
    pkgs = []
    if out_n.any():
        out_p = state["out_p"].cpu().numpy()
        out_g = state["out_g"].cpu().numpy()
        out_meta = state["out_meta"].cpu().numpy()
        for c in range(out_n.shape[0]):
            n = min(int(out_n[c]), cap)
            for s in range(n):
                m = out_meta[c, s]
                num = int(m[M_NUM])
                pkgs.append({
                    "channel": c,
                    "type": int(m[M_TYPE]),
                    "num_pulses": num,
                    "pulse": out_p[c, s, :num].copy(),
                    "gap": out_g[c, s, :num].copy(),
                    "ook_low_estimate": int(m[M_LOW]),
                    "ook_high_estimate": int(m[M_HIGH]),
                    "fsk_f1_est": int(m[M_F1]),
                    "fsk_f2_est": int(m[M_F2]),
                    "start": int(m[M_START]),
                    "end": int(m[M_END]),
                })
    state = dict(state)
    state["out_n"] = torch.zeros_like(state["out_n"])
    return pkgs, state


def compact_packages(state, cap: int) -> dict:
    """Device-side package compaction: every published package of every
    channel gathered into dense ``[cap, ...]`` rows, in the order of
    :func:`take_packages` (``ops/compact.py``; one CUDA kernel for a state
    on the card).

    Returns dict(pulse[cap,P], gap[cap,P], meta[cap,F], channel[cap],
    count, rows) -- rows with channel == -1 are padding, ``count`` (a 0-dim
    tensor) may exceed ``cap``, and the first four are views of ``rows``.
    """
    return _compact.compact_packages(state["out_n"], state["out_p"],
                                     state["out_g"], state["out_meta"], cap)


def packages_from_compact(comp):
    """Host-side: a :func:`compact_packages` result -> the package dicts of
    :func:`take_packages`, and the count of valid slots. Only the first
    ``min(count, cap)`` rows, the non-padding ones, are read to the host,
    in one copy of the packed ``rows`` buffer."""
    count = int(comp["count"])
    n = min(count, comp["channel"].shape[0])
    P, F = comp["pulse"].shape[1], comp["meta"].shape[1]
    rows = comp["rows"][:n].cpu().numpy()
    pulse, gap = rows[:, :P], rows[:, P:2 * P]
    meta, channel = rows[:, 2 * P:2 * P + F], rows[:, 2 * P + F]
    pkgs = []
    for s in range(n):
        m = meta[s]
        num = int(m[M_NUM])
        pkgs.append({
            "channel": int(channel[s]),
            "type": int(m[M_TYPE]),
            "num_pulses": num,
            "pulse": pulse[s, :num].copy(),
            "gap": gap[s, :num].copy(),
            "ook_low_estimate": int(m[M_LOW]),
            "ook_high_estimate": int(m[M_HIGH]),
            "fsk_f1_est": int(m[M_F1]),
            "fsk_f2_est": int(m[M_F2]),
            "start": int(m[M_START]),
            "end": int(m[M_END]),
        })
    return pkgs, count

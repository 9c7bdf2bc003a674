"""Time-shard verification chain and candidate gather: the CUDA kernels'
wrappers and their plain versions.

The time-sharded engine step (``parallel/timeshard.py``) runs D time
segments of a block, each from a speculative seed over a halo and each with
three ``low_est`` hedge candidates, as lanes of one front-end and one
detector launch. Then:

- :func:`timeshard_chain` walks the segment boundaries (the JAX package's
  ``chain``, its parallel/timeshard.py:195-223): it verifies each
  predecessor's selected final registers against the next segment's start,
  selects the hedge candidate, computes each segment's package-generation
  offset, and gives the block-outgoing registers and re-based counters
  (:267-281);
- :func:`timeshard_gather` gathers each segment's selected candidate's
  record logs into the block's logs and re-bases their generations
  (:245-265).

Lane layout: ``start`` ``[NROW, D*C]`` holds segment ``d``'s start
registers for channel ``c`` at lane ``d*C + c``; ``fin`` ``[NROW, 3*D*C]``
the final registers of candidate ``k`` (``low_est`` offset ``k - 1``) at
lane ``(k*D + d)*C + c``; the detector's logs of the candidate lanes follow
the same lane order. Rows are :data:`TS_KEYS`: the detector's packed
registers, then the front end's carries.

Each wrapper launches ``csrc/timeshard.cu`` for a CUDA tensor and runs the
plain version (torch, written from the JAX lines) for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _cuda
from .detector import (KEY_IDX_BITS, KEY_INVALID, M_GEN, M_TYPE, PKG_NONE,
                       REG_KEYS, ST_IDLE)
from .frontend import STATE_KEYS

TS_KEYS = REG_KEYS + STATE_KEYS
NROW = len(TS_KEYS)

# rowinfo bits (csrc/timeshard.cu): the verification key's index + 1 in
# bits 0-7, a package-scoped key, a write-only counter
OPEN_BIT = 1 << 8
COUNTER_BIT = 1 << 9

_ROWS = {k: TS_KEYS.index(k)
         for k in ("low_est", "high_est", "ook_state", "min_high", "gen")}


def _key_rows(key: str) -> list:
    """The rows of a state key (the rewind history has four each)."""
    if key in ("hist_p", "hist_g"):
        return [TS_KEYS.index(f"{key}{i}") for i in range(4)]
    return [TS_KEYS.index(key)]


def verify_layout(vkeys_always, vkeys_open, counters):
    """The by-key order and the per-row info of the chain.

    The by-key order is JAX's: ``low_est`` (the hedge's reach), ``high_est``
    (the hedge's consistency), then every other key of ``vkeys_always +
    vkeys_open`` in that order. Returns (key names, rowinfo int32
    ``[NROW]``)."""
    names = ["low_est", "high_est"] + [
        k for k in tuple(vkeys_always) + tuple(vkeys_open)
        if k not in ("low_est", "high_est")]
    if len(names) > 31:
        raise ValueError("timeshard: at most 31 verified keys fit the mask")
    info = [0] * NROW
    for i, k in enumerate(names):
        for r in _key_rows(k):
            info[r] = (i + 1) | (OPEN_BIT if k in vkeys_open else 0)
    for k in counters:
        for r in _key_rows(k):
            info[r] |= COUNTER_BIT
    return names, torch.tensor(info, dtype=torch.int32)


def _check(t, shape, name, dev):
    if t.shape != shape or t.dtype != torch.int32 or t.device != dev:
        raise ValueError(f"timeshard: {name} must be int32 {list(shape)} on "
                         f"the input's device")
    return t.contiguous()


def _take3(x3, sel):
    """x3 [3, ..., C] per candidate, sel [C] -> [..., C] (JAX's
    ``_take_cand``, a select chain)."""
    return torch.where(sel == 0, x3[0], torch.where(sel == 1, x3[1], x3[2]))


def timeshard_chain_plain(start, fin, rowinfo, *, D, ratio):
    """Plain version of the chain kernel (JAX timeshard.py:189-243 and
    :267-281). Returns (sel int32 [D, C], delta int32 [D, C], out int32
    [NROW, C], by_key int32 [max(D-1, 0)] bit masks, bad int32 [1])."""
    nrow, L = start.shape
    C = L // D
    st = start.view(nrow, D, C)
    f3 = fin.view(nrow, 3, D, C).transpose(0, 1)             # [3, NROW, D, C]
    info = rowinfo.tolist()
    low, high, ook = _ROWS["low_est"], _ROWS["high_est"], _ROWS["ook_state"]
    mh, gen = _ROWS["min_high"], _ROWS["gen"]
    i32 = torch.int32
    dev = start.device
    prev = f3[1, :, 0]                                        # [NROW, C]
    gen0 = st[gen, 0]
    tgen = gen0 + (prev[gen] - st[gen, 0])
    sels = [torch.ones(C, dtype=i32, device=dev)]
    deltas = [torch.zeros(C, dtype=i32, device=dev)]
    finals = [prev]
    masks = []
    for d in range(1, D):
        s = st[:, d]
        dlow = prev[low] - s[low]
        sel = torch.clamp(dlow + 1, 0, 2)
        open_m = prev[ook] != ST_IDLE
        cand_high = torch.where(
            s[ook] == ST_IDLE,
            torch.maximum(ratio * (s[low] + dlow), s[mh]), s[high])
        mask = int(bool((dlow.abs() > 1).any())) \
            | int(bool((prev[high] != cand_high).any())) << 1
        for r, v in enumerate(info):
            k = (v & 0xff) - 1
            if k < 2:
                continue
            b = prev[r] != s[r]
            if v & OPEN_BIT:
                b = b & open_m
            mask |= int(bool(b.any())) << k
        masks.append(mask)
        deltas.append(tgen - s[gen])
        prev = _take3(f3[:, :, d], sel)
        tgen = tgen + (prev[gen] - s[gen])
        sels.append(sel)
        finals.append(prev)
    out = prev.clone()
    for r, v in enumerate(info):
        if v & COUNTER_BIT:
            acc = st[r, 0]
            for d in range(D):
                acc = acc + (finals[d][r] - st[r, d])
            out[r] = acc
    by_key = torch.tensor(masks, dtype=i32, device=dev)
    bad = torch.tensor([int(any(masks))], dtype=i32, device=dev)
    return (torch.stack(sels), torch.stack(deltas), out, by_key, bad)


def timeshard_chain_cuda(start, fin, rowinfo, *, D, ratio):
    """Launch ``csrc/timeshard.cu``'s chain; same contract as
    :func:`timeshard_chain_plain`."""
    dev = start.device
    if not start.is_cuda or start.dim() != 2 or start.shape[1] % D:
        raise ValueError("timeshard_chain: start must be CUDA int32 "
                         "[NROW, D*C]")
    nrow, L = start.shape
    C = L // D
    start = _check(start, (nrow, L), "start", dev)
    fin = _check(fin, (nrow, 3 * L), "fin", dev)
    rowinfo = _check(rowinfo, (nrow,), "rowinfo", dev)
    sel = torch.empty((D, C), dtype=torch.int32, device=dev)
    delta = torch.empty((D, C), dtype=torch.int32, device=dev)
    out = torch.empty((nrow, C), dtype=torch.int32, device=dev)
    flags = torch.zeros(D, dtype=torch.int32, device=dev)   # by_key, bad
    fn = _cuda.launcher("timeshard_chain")
    _cuda.LAUNCHES["timeshard_chain"] += 1
    err = fn(start.data_ptr(), fin.data_ptr(), rowinfo.data_ptr(), nrow, D,
             C, int(ratio), _ROWS["low_est"], _ROWS["high_est"],
             _ROWS["ook_state"], _ROWS["min_high"], _ROWS["gen"],
             sel.data_ptr(), delta.data_ptr(), out.data_ptr(),
             flags.data_ptr(), flags[D - 1:].data_ptr(),
             _cuda.stream_of(start))
    _cuda.check(err, "timeshard_chain")
    return sel, delta, out, flags[:D - 1], flags[D - 1:]


def timeshard_chain(start, fin, rowinfo, *, D, ratio):
    """Verify, select and re-base over the D segments of one block.

    ``start`` int32 ``[NROW, D*C]`` and ``fin`` ``[NROW, 3*D*C]`` in the
    module's lane layout; ``rowinfo`` from :func:`verify_layout`; ``ratio``
    the detector's OOK high/low ratio. Returns ``(sel, delta, out, by_key,
    bad)``: the selected candidate and the generation offset of each
    segment ``[D, C]``, the block-outgoing registers ``[NROW, C]``, per link
    the bit mask of keys that failed in any channel ``[D-1]`` (bit ``i``:
    key ``i`` of :func:`verify_layout`), and whether any failed ``[1]``.
    Launches the CUDA kernel for a CUDA tensor, and runs the plain version
    for a CPU tensor.
    """
    run = timeshard_chain_cuda if start.is_cuda else timeshard_chain_plain
    return run(start, fin, rowinfo, D=D, ratio=ratio)


def timeshard_gather_plain(key3, p3, g3, eop3, sel, delta, *, R):
    """Plain version of the gather kernel (JAX timeshard.py:245-265).
    Returns (log_key, log_p, log_g int32 [C*R, D*G], eop_log int32
    [C, D*G*E, 9])."""
    D, C = sel.shape
    G = key3.shape[1]
    GE = eop3.shape[1]
    dd = torch.arange(D, device=sel.device)[:, None]
    cc = torch.arange(C, device=sel.device)[None]
    lane = ((sel.long() * D + dd) * C + cc).reshape(-1)        # [D*C]

    def planes(x3):
        x = x3.view(3 * D * C, R, G)[lane].view(D, C, R, G)
        return x.permute(1, 2, 0, 3).reshape(C * R, D * G)

    key = planes(key3)
    drep = delta.t()[:, None, :, None].expand(C, R, D, G).reshape(C * R,
                                                                  D * G)
    key = torch.where(key < KEY_INVALID, key + drep * (1 << KEY_IDX_BITS),
                      key)
    eop = eop3[lane].view(D, C, GE, -1).permute(1, 0, 2, 3).reshape(
        C, D * GE, -1).clone()
    dg = delta.t()[:, :, None].expand(C, D, GE).reshape(C, D * GE)
    eop[:, :, M_GEN] += torch.where(eop[:, :, M_TYPE] != PKG_NONE, dg,
                                    torch.zeros_like(dg))
    return key, planes(p3), planes(g3), eop


def timeshard_gather_cuda(key3, p3, g3, eop3, sel, delta, *, R):
    """Launch ``csrc/timeshard.cu``'s gather; same contract as
    :func:`timeshard_gather_plain`."""
    dev = key3.device
    D, C = sel.shape
    if not key3.is_cuda or key3.dim() != 2 or key3.shape[0] != 3 * D * C * R:
        raise ValueError("timeshard_gather: key3 must be CUDA int32 "
                         "[3*D*C*R, G]")
    G = key3.shape[1]
    shape = (3 * D * C * R, G)
    key3 = _check(key3, shape, "key3", dev)
    p3 = _check(p3, shape, "p3", dev)
    g3 = _check(g3, shape, "g3", dev)
    if eop3.dim() != 3 or eop3.shape[0] != 3 * D * C:
        raise ValueError("timeshard_gather: eop3 must be int32 "
                         "[3*D*C, G*E, 9]")
    eop3 = _check(eop3, tuple(eop3.shape), "eop3", dev)
    sel = _check(sel, (D, C), "sel", dev)
    delta = _check(delta, (D, C), "delta", dev)
    GE, F = eop3.shape[1:]
    if GE % G:
        raise ValueError("timeshard_gather: eop3 rows must be G*E")
    key = torch.empty((C * R, D * G), dtype=torch.int32, device=dev)
    p = torch.empty_like(key)
    g = torch.empty_like(key)
    eop = torch.empty((C, D * GE, F), dtype=torch.int32, device=dev)
    fn = _cuda.launcher("timeshard_gather")
    _cuda.LAUNCHES["timeshard_gather"] += 1
    err = fn(key3.data_ptr(), p3.data_ptr(), g3.data_ptr(), eop3.data_ptr(),
             sel.data_ptr(), delta.data_ptr(), D, C, R, G, GE // G * F,
             key.data_ptr(), p.data_ptr(), g.data_ptr(), eop.data_ptr(),
             _cuda.stream_of(key3))
    _cuda.check(err, "timeshard_gather")
    return key, p, g, eop


def timeshard_gather(key3, p3, g3, eop3, sel, delta, *, R):
    """Each segment's selected candidate's logs, as the block's.

    ``key3``/``p3``/``g3`` int32 ``[3*D*C*R, G]`` and ``eop3`` ``[3*D*C,
    G*E, 9]``: the candidate lanes' logs; ``sel``/``delta`` ``[D, C]`` from
    :func:`timeshard_chain`. Returns ``(log_key, log_p, log_g)`` ``[C*R,
    D*G]`` and ``eop_log`` ``[C, D*G*E, 9]``, segment ``d`` at columns
    ``d*G..``: valid keys gain ``delta << KEY_IDX_BITS`` and valid EOPs'
    ``M_GEN`` gains ``delta``. Launches the CUDA kernel for a CUDA tensor,
    and runs the plain version for a CPU tensor.
    """
    run = timeshard_gather_cuda if key3.is_cuda else timeshard_gather_plain
    return run(key3, p3, g3, eop3, sel, delta, R=R)

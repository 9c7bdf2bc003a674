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
- the gather (:func:`timeshard_gather_plain`, :func:`timeshard_gather_cuda`)
  gathers each segment's selected candidate's record logs into the
  block's logs and re-bases their generations (:245-265);
- :func:`timeshard_chain_gather` is the step's pair: on the card both
  launches go before the host's one read of the chain's verdict, the
  gather waiting on the card for the chain and writing nothing behind a
  failed one.

Lane layout: ``start`` ``[NROW, D*C]`` holds segment ``d``'s start
registers for channel ``c`` at lane ``d*C + c``; ``fin`` ``[NROW, 3*D*C]``
the final registers of candidate ``k`` (``low_est`` offset ``k - 1``) at
lane ``(k*D + d)*C + c``; the detector's logs of the candidate lanes follow
the same lane order. Rows are :data:`TS_KEYS`: the detector's packed
registers, then the front end's carries.

Each wrapper launches ``csrc/timeshard.cu`` for a CUDA tensor and runs the
plain version (torch, written from the JAX lines) for a CPU tensor. The
chain's plain version steps in the kernel's three phases (every link's
compares for all three predecessor candidates, the walk, the outgoing
registers); the CPU tests hold it to the JAX package's chain and to a
link-by-link walk of the JAX lines.
"""

from __future__ import annotations

import torch

from . import _cuda
from .detector import (KEY_IDX_BITS, KEY_INVALID, M_GEN, M_TYPE,
                       META_FIELDS, PKG_NONE, REG_KEYS, ST_IDLE)
from .frontend import STATE_KEYS

TS_KEYS = REG_KEYS + STATE_KEYS
NROW = len(TS_KEYS)

# rowinfo bits (csrc/timeshard.cu): the verification key's index + 1 in
# bits 0-7, a package-scoped key, a write-only counter
OPEN_BIT = 1 << 8
COUNTER_BIT = 1 << 9
# the chain kernel's shared memory per channel per link: the mask, the
# generation increment and the next candidate for each of three
# predecessor candidates, then t_gen and the selection (csrc/timeshard.cu
# ChainSmem); a block may use 227 KB
CHAIN_BYTES_PER_LINK = 3 * 4 + 3 * 4 + 4 + 3 + 1
SMEM_MAX = 232448

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


def timeshard_chain_plain(start, fin, rowinfo, *, D, ratio):
    """Plain version of the chain kernel (JAX timeshard.py:189-243 and
    :267-281), in the kernel's three phases. Returns (sel int32 [D, C],
    delta int32 [D, C], out int32 [NROW, C], by_key int32 [max(D-1, 0)]
    bit masks, bad int32 [1]).

    Every quantity a link compares depends only on the predecessor's
    candidate ``k`` and the link ``d``, so phase 1 computes, for every
    link and all three ``k`` at once, the mask of failed keys, the
    candidate the link selects and that candidate's generation increment;
    phase 2 walks the links from ``sel_0 = 1``, taking each link's entry
    for the predecessor's selection; phase 3 gathers the outgoing
    registers and the re-based counters along the selected path."""
    nrow, L = start.shape
    C = L // D
    i32 = torch.int32
    dev = start.device
    st = start.view(nrow, D, C)
    f3 = fin.view(nrow, 3, D, C)                             # [NROW, 3, D, C]
    info = rowinfo.tolist()
    low, high, ook = _ROWS["low_est"], _ROWS["high_est"], _ROWS["ook_state"]
    mh, gen = _ROWS["min_high"], _ROWS["gen"]

    # phase 1: link d (1..D-1) against the predecessor's candidate k,
    # each [3, D-1, C]
    prev = f3[:, :, :D - 1]
    s = st[:, None, 1:]
    dlow = prev[low] - s[low]
    nxt = torch.clamp(dlow + 1, 0, 2).long()
    open_m = prev[ook] != ST_IDLE
    cand_high = torch.where(
        s[ook] == ST_IDLE,
        torch.maximum(ratio * (s[low] + dlow), s[mh]), s[high])
    mask = (dlow.abs() > 1).to(i32) | ((prev[high] != cand_high).to(i32) << 1)
    for r, v in enumerate(info):
        k = (v & 0xff) - 1
        if k < 2:
            continue
        b = prev[r] != s[r]
        if v & OPEN_BIT:
            b = b & open_m
        mask = mask | (b.to(i32) << k)
    inc = torch.gather(f3[gen, :, 1:], 0, nxt) - s[gen]

    # phase 2: the walk, one step per link over all channels; t_gen after
    # segment 0 is gen0 + (its final gen - its start gen), its final gen
    cc = torch.arange(C, device=dev)
    sel = torch.ones(C, dtype=torch.long, device=dev)
    tgen = f3[gen, 1, 0]
    sels, deltas, link_masks = [sel], [torch.zeros_like(tgen)], []
    for d in range(1, D):
        link_masks.append(mask[sel, d - 1, cc])
        deltas.append(tgen - st[gen, d])
        tgen = tgen + inc[sel, d - 1, cc]
        sel = nxt[sel, d - 1, cc]
        sels.append(sel)
    bit = torch.arange(31, device=dev)
    if link_masks:
        m = torch.stack(link_masks).long()                    # [D-1, C]
        by_key = (((m[:, :, None] >> bit) & 1).amax(1) << bit).sum(1)
    else:
        by_key = torch.zeros(0, dtype=torch.long, device=dev)
    by_key = by_key.to(i32)
    bad = (by_key != 0).any().to(i32).reshape(1)

    # phase 3: the outgoing registers along the selected path (counters:
    # the seed plus each segment's selected increment)
    sels = torch.stack(sels)                                  # [D, C]
    picked = torch.gather(f3, 1, sels[None, None].expand(nrow, 1, D, C))[:, 0]
    out = picked[:, D - 1].clone()
    for r, v in enumerate(info):
        if v & COUNTER_BIT:
            out[r] = (st[r, 0].long() + (picked[r].long() - st[r].long())
                      .sum(0)).to(i32)
    return sels.to(i32), torch.stack(deltas), out, by_key, bad


def chain_plan(D, C, nrow=NROW):
    """The chain kernel's launch: (channels per block, shared bytes per
    block, blocks). A block takes up to 32 channels, fewer where D is so
    large that their per-link tables would not fit the 227 KB of shared
    memory a block may use; raises where not even one channel fits."""
    per_channel = D * CHAIN_BYTES_PER_LINK
    g = min(32, C, (SMEM_MAX - 4 * nrow) // per_channel)
    if g < 1:
        raise ValueError(f"timeshard_chain: D={D} segments do not fit one "
                         f"block's shared memory")
    return g, 4 * nrow + g * per_channel, -(-C // g)


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
    G, smem, blocks = chain_plan(D, C, nrow)
    sel = torch.empty((D, C), dtype=torch.int32, device=dev)
    delta = torch.empty((D, C), dtype=torch.int32, device=dev)
    out = torch.empty((nrow, C), dtype=torch.int32, device=dev)
    # by_key, bad: one block writes them, several OR into zeros
    flags = (torch.zeros if blocks > 1 else torch.empty)(
        D, dtype=torch.int32, device=dev)
    fn = _cuda.launcher("timeshard_chain")
    _cuda.LAUNCHES["timeshard_chain"] += 1
    err = fn(start.data_ptr(), fin.data_ptr(), rowinfo.data_ptr(), nrow, D,
             C, G, smem, int(ratio), _ROWS["low_est"], _ROWS["high_est"],
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
    """Each segment's selected candidate's logs, as the block's: the plain
    version of the gather kernel (JAX timeshard.py:245-265).

    ``key3``/``p3``/``g3`` int32 ``[3*D*C*R, G]`` and ``eop3`` ``[3*D*C,
    G*E, 9]``: the candidate lanes' logs; ``sel``/``delta`` ``[D, C]`` from
    :func:`timeshard_chain`. Returns ``(log_key, log_p, log_g)`` ``[C*R,
    D*G]`` and ``eop_log`` ``[C, D*G*E, 9]``, segment ``d`` at columns
    ``d*G..``: valid keys gain ``delta << KEY_IDX_BITS`` and valid EOPs'
    ``M_GEN`` gains ``delta``."""
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


def timeshard_gather_cuda(key3, p3, g3, eop3, sel, delta, *, R,
                          skip_if_bad=None, out=None, pdl=True):
    """Launch ``csrc/timeshard.cu``'s gather; same contract as
    :func:`timeshard_gather_plain`. ``skip_if_bad``: the chain's ``bad``
    flag int32 ``[1]``; where given and set, the launch writes nothing.
    ``out``: the four output tensors to write into (else new ones). With
    ``pdl`` the launch may start while the kernel before it on the stream
    runs (the chain, which releases it early) and reads ``sel``, ``delta``
    and ``bad`` only once that kernel is done; without it, it is a plain
    launch that starts after that kernel has ended."""
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
    if eop3.dim() != 3 or eop3.shape[0] != 3 * D * C \
            or eop3.shape[2] != META_FIELDS:
        raise ValueError("timeshard_gather: eop3 must be int32 "
                         "[3*D*C, G*E, 9]")
    eop3 = _check(eop3, tuple(eop3.shape), "eop3", dev)
    sel = _check(sel, (D, C), "sel", dev)
    delta = _check(delta, (D, C), "delta", dev)
    GE = eop3.shape[1]
    if GE % G:
        raise ValueError("timeshard_gather: eop3 rows must be G*E")
    if max(key3.numel(), eop3.numel()) >= 1 << 31:
        raise ValueError("timeshard_gather: the kernel's offsets are 32-bit")
    if skip_if_bad is not None:
        skip_if_bad = _check(skip_if_bad, (1,), "skip_if_bad", dev)
    shapes = [(C * R, D * G)] * 3 + [(C, D * GE, META_FIELDS)]
    if out is None:
        out = tuple(torch.empty(sh, dtype=torch.int32, device=dev)
                    for sh in shapes)
    elif any(t.shape != sh or t.dtype != torch.int32 or t.device != dev
             or not t.is_contiguous() for t, sh in zip(out, shapes)):
        raise ValueError("timeshard_gather: out must be four contiguous "
                         "int32 tensors of the outputs' shapes on the "
                         "input's device")
    fn = _cuda.launcher("timeshard_gather")
    _cuda.LAUNCHES["timeshard_gather"] += 1
    err = fn(key3.data_ptr(), p3.data_ptr(), g3.data_ptr(), eop3.data_ptr(),
             sel.data_ptr(), delta.data_ptr(),
             None if skip_if_bad is None else skip_if_bad.data_ptr(),
             int(skip_if_bad is not None), int(pdl), D, C, R, G, GE,
             *(t.data_ptr() for t in out), _cuda.stream_of(key3))
    _cuda.check(err, "timeshard_gather")
    return out


def timeshard_chain_gather(start, fin, rowinfo, key3, p3, g3, eop3, *, D,
                           ratio, R, debug=False):
    """The verified step's chain, then its gather, and the one read of the
    chain's verdict.

    Returns ``(chain, ok, logs)``: ``chain`` is :func:`timeshard_chain`'s
    ``(sel, delta, out, by_key, bad)``, ``ok`` whether every link
    verified, ``logs`` the gather's four tensors, or None
    where the block failed and ``debug`` is off. On the card the gather is
    launched right behind the chain, before the host reads ``bad``, and
    writes nothing where the chain failed (under ``debug`` it gathers
    whatever the chain selected, as JAX does); so there is no host round
    trip between the two launches, and a failed block costs one gather
    launch that returns early. On the CPU the plain gather runs after the
    read, only where the block verified or under ``debug``.
    """
    chain = timeshard_chain(start, fin, rowinfo, D=D, ratio=ratio)
    sel, delta, bad = chain[0], chain[1], chain[4]
    logs = None
    if start.is_cuda:
        logs = timeshard_gather_cuda(key3, p3, g3, eop3, sel, delta, R=R,
                                     skip_if_bad=None if debug else bad)
    ok = not bad.item()
    if not (ok or debug):
        return chain, ok, None
    if logs is None:
        logs = timeshard_gather_plain(key3, p3, g3, eop3, sel, delta, R=R)
    else:
        _cuda.LAUNCHES["timeshard_gather_copied"] += 1
    return chain, ok, logs

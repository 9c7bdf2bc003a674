"""The port's time sharding (rtl_433_tpu_torch.parallel.timeshard) against
the JAX package's on the scenarios of tests/test_timeshard.py.

The port runs on a mesh of D entries of the CPU device (its segments as
lanes of one plain front-end and detector call each); the JAX package on
the first D of the 8 virtual CPU devices of tests/conftest.py. For every
block, both steps (``debug=True``) must give the same ``ok``, the same
per-link failure flags by key, and, where the speculation verified, every
outgoing state key equal (``avg_db`` within 1e-4 dB: XLA's CPU float32
log10 is not correctly rounded). The port's TimeShardEngine must give the
JAX package's sequential packages (every field, the pulse and gap lists)
and its fallbacks. The plain chain and gather are held to the JAX
package's own ``chain``/``chain_step``/``_take_cand`` (rebuilt from the
code objects of ``timeshard_process_block``) on seeded random register sets
with planted mismatches of every key class; the plain chain, which steps in
the kernel's three phases, also to a link-by-link numpy walk of the JAX
lines (which proves the decomposition); and the per-lane-origin front end
and detector to one plain call per segment.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JMesh

from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu.parallel import timeshard as jts
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.dsp.convert import (params_from_jax, state_from_numpy,
                                           state_to_numpy)
from rtl_433_tpu_torch.ops import detector as det
from rtl_433_tpu_torch.ops import frontend as fe
from rtl_433_tpu_torch.ops import timeshard as ots
from rtl_433_tpu_torch.parallel import timeshard as pts
from rtl_433_tpu_torch.parallel.sharding import Mesh

from synth import synth_ook, synth_fsk, fsk_pcm_bits
from torch_timeshard_cases import random_chain, random_logs
from test_timeshard import (PWM_SIG, FSK_SIG, _dense_sig, _shard_local_sig,
                            assert_pkgs_equal)

CPU = torch.device("cpu")


def _long_package_sig():
    """tests/test_timeshard.py::test_fallback_is_bit_identical's signal:
    one OOK package of ~80 ms, far longer than a 2-chunk halo."""
    return synth_ook([(400, 400)] * 200 + [(0, 30_000)], rate=250_000,
                     lead_in_us=20_000, tail_us=60_000, seed=5)


@functools.lru_cache(maxsize=None)
def _jax_step(jp, D, halo_chunks, flush):
    mesh = JMesh(np.asarray(jax.devices()[:D]), ("sp",))
    return jts.timeshard_process_block(jp, mesh, halo_chunks=halo_chunks,
                                       flush=flush, debug=True)


@functools.lru_cache(maxsize=None)
def _jax_seq(jp):
    return jax.jit(functools.partial(je.process_block, jp),
                   static_argnames=("flush",))


def _mesh(D):
    return Mesh([CPU] * D, ("sp",), (D,))


def _pad(iq, D):
    n = iq.shape[0]
    pad = (-n) % (128 * max(8, D))
    return np.pad(iq, ((0, pad), (0, 0)), constant_values=128)[None], n


def _both_steps(jp, state, blk, n_valid, D, halo_chunks=10, flush=True):
    """One block through both steps from the same numpy state; checks ok,
    the failure flags and (where verified) the whole outgoing state.
    Returns (ok, jax state, port state) as numpy dicts."""
    js, javg, jok, jdbg = _jax_step(jp, D, halo_chunks, flush)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(blk),
        jnp.int32(n_valid))
    fn = pts.timeshard_process_block(params_from_jax(jp), _mesh(D),
                                     halo_chunks=halo_chunks, flush=flush,
                                     debug=True)
    ts, tavg, tok, tdbg = fn(state_from_numpy(state, CPU),
                             torch.from_numpy(np.ascontiguousarray(blk)),
                             n_valid)
    assert tok == bool(jok)
    assert np.array_equal(tdbg.numpy(), np.asarray(jdbg)), (tdbg, jdbg)
    js = {k: np.asarray(v) for k, v in js.items()}
    ts = state_to_numpy(ts)
    if tok:
        assert sorted(js) == sorted(ts)
        for k in js:
            assert np.array_equal(js[k], ts[k]), k
        assert np.allclose(np.asarray(javg), tavg.numpy(), atol=1e-4)
    return tok, js, ts


def _assert_live_state_equal(got, want, skip=()):
    """Every state key but ``skip`` equal, except the package-scoped
    registers while no package is open: they are dead (rewritten at the
    next package start) and a verified segment may hold other dead values
    than the sequential scan, in both packages."""
    idle = want["ook_state"] == 0
    for k in want:
        if k in skip or (k in pts._VERIFY_OPEN and idle.all()):
            continue
        assert np.array_equal(got[k], want[k]), k


def _port_engine(params, D, blocks, halo_chunks=10):
    """The port's TimeShardEngine over (block, n_valid, flush) triples;
    returns (packages per block, fallbacks, verified, states)."""
    eng = pts.TimeShardEngine(params, channels=1, mesh=_mesh(D),
                              halo_chunks=halo_chunks)
    pkgs, states = [], []
    for blk, nv, flush in blocks:
        eng.push(blk, n_valid=nv, flush=flush)
        states.append(state_to_numpy(eng.state))
        pkgs.append(eng.take_packages())
    return pkgs, eng.fallbacks, eng.verified, states


def _jax_sequential(jp, blocks):
    """The JAX sequential engine over the same blocks: packages per block."""
    state = je.detector_init(jp, 1)
    out = []
    for blk, nv, flush in blocks:
        state, _ = _jax_seq(jp)(state, jnp.asarray(blk), jnp.int32(nv),
                                flush=flush)
        got, state = je.take_packages(state)
        out.append(got)
    return out


def _check_scenario(iq, jp, D, halo_chunks=10):
    """One padded flush block: both steps, then the port's engine against
    the JAX sequential packages. Returns (ok, port packages)."""
    blk, n = _pad(iq, D)
    state = {k: np.asarray(v) for k, v in je.detector_init(jp, 1).items()}
    ok, _, _ = _both_steps(jp, state, blk, n, D, halo_chunks)
    blocks = [(blk, n, True)]
    pkgs, fallbacks, verified, _ = _port_engine(params_from_jax(jp), D,
                                                blocks, halo_chunks)
    assert (fallbacks, verified) == (int(not ok), int(ok))
    want = _jax_sequential(jp, blocks)
    assert want[0], "no packages detected"
    assert_pkgs_equal(pkgs[0], want[0])
    for x, y in zip(pkgs[0], want[0]):
        assert x["channel"] == y["channel"] and x["start"] == y["start"]
    return ok, pkgs[0]


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_pwm_matches_jax(D):
    ok, _ = _check_scenario(PWM_SIG(), je.DetectorParams(), D)
    if D == 1:
        assert ok


@pytest.mark.parametrize("D", [4, 8])
def test_classic_fsk_matches_jax(D):
    _, pkgs = _check_scenario(FSK_SIG(), je.DetectorParams(fsk_minmax=False),
                              D)
    assert any(p["type"] == 2 for p in pkgs), "no FSK package"


def test_shard_local_packages_verify():
    """Packages confined to single segments with quiet halos: the fast path
    verifies (in both packages) and every segment publishes its own
    package, so the generation rebase lines the record keys up."""
    ok, pkgs = _check_scenario(_shard_local_sig(), je.DetectorParams(), 8)
    assert ok, "speculation unexpectedly failed on shard-local packages"
    assert len(pkgs) >= 6


def test_straddling_package_falls_back():
    """A package longer than a 2-chunk halo across a segment boundary fails
    verification in both packages; the engine replays the block and gives
    the sequential packages, as JAX's TimeShardEngine does."""
    jp = je.DetectorParams()
    iq = _long_package_sig()
    ok, pkgs = _check_scenario(iq, jp, 8, halo_chunks=2)
    assert not ok
    assert max(p["num_pulses"] for p in pkgs) >= 100
    eng = jts.TimeShardEngine(jp, channels=1, halo_chunks=2)
    blk, n = _pad(iq, 8)
    eng.push(blk, n_valid=n, flush=True)
    assert eng.fallbacks == 1
    assert_pkgs_equal(pkgs, eng.take_packages())


def test_fallback_leaves_the_pre_block_state_untouched():
    """The speculative step writes into no state tensor: after a failed
    speculation the pre-block state equals its copy, so the replay starts
    from the true state."""
    params = te.DetectorParams()
    blk, n = _pad(_long_package_sig(), 8)
    eng = pts.TimeShardEngine(params, channels=1, mesh=_mesh(8),
                              halo_chunks=2)
    before = {k: v.clone() for k, v in eng.state.items()}
    prev = eng.state
    step = eng._flush_step
    seen = {}

    def spy(state, iq, n_valid):
        out = step(state, iq, n_valid)
        seen["ok"] = out[2]
        seen["same"] = all(torch.equal(state[k], before[k]) for k in before)
        return out

    eng._flush_step = spy
    eng.push(blk, n_valid=n, flush=True)
    assert seen == {"ok": False, "same": True}
    assert all(torch.equal(prev[k], before[k]) for k in before)
    assert eng.fallbacks == 1


# cut 0: tests/test_timeshard.py's 3-block split; cut 9000 (of the quiet
# tail): the flush block's valid samples end two segments before its end
@pytest.mark.parametrize("cut", [0, 9000])
def test_streaming_blocks_match_jax_and_sequential(cut):
    """Three blocks, the last a partial flush block: each block's step
    equals JAX's, and the engine's state after every block equals the
    port's sequential engine's (the FM discriminator carry of the partial
    block included)."""
    jp = je.DetectorParams()
    params = params_from_jax(jp)
    D = 8
    full = _dense_sig(seed=23)
    n = full.shape[0]
    blk_len = ((n // 3) // (128 * 8) + 1) * (128 * 8)
    iq = full[:n - cut]
    n -= cut
    blocks = []
    for off in range(0, n, blk_len):
        end = min(off + blk_len, n)
        b = np.pad(iq[off:end], ((0, blk_len - (end - off)), (0, 0)),
                   constant_values=128)[None]
        blocks.append((b, end - off, end >= n))
    assert len(blocks) == 3
    if cut:
        assert blocks[-1][1] < (D - 2) * blk_len // D

    state = {k: np.asarray(v) for k, v in je.detector_init(jp, 1).items()}
    seq = te.detector_init(params, 1, CPU)
    oks = []
    for blk, nv, flush in blocks:
        ok, js, ts = _both_steps(jp, state, blk, nv, D, flush=flush)
        oks.append(ok)
        # continue from the true state, as the engine does after a replay
        seq, _ = te.process_block(params, seq, torch.from_numpy(blk), nv,
                                  flush=flush)
        state = state_to_numpy(seq)
        if ok:
            _assert_live_state_equal(ts, state)
    pkgs, fallbacks, verified, states = _port_engine(params, D, blocks)
    assert (fallbacks, verified) == (oks.count(False), oks.count(True))
    want = _jax_sequential(jp, blocks)
    assert [len(p) for p in pkgs] == [len(w) for w in want]
    for p, w in zip(pkgs, want):
        assert_pkgs_equal(p, w)
    # the engine's slots were harvested after every block, the sequential
    # state's were not
    _assert_live_state_equal(states[-1], state,
                             skip=("out_p", "out_g", "out_meta", "out_n"))


# 7S - 100: the valid samples end in segment 6 of 8, inside segment 7's
# halo; 6S - 800: they end in segment 5, and segment 7's halo holds none,
# so its halo-end registers are the seed and the link fails in both
@pytest.mark.parametrize("nv,verifies", [(7 * 16384 - 100, True),
                                         (6 * 16384 - 800, False)])
def test_partial_block_keeps_the_sequential_fm_carry(nv, verifies):
    """A flush block whose valid samples end before its last segment: both
    steps agree on ``ok``; where it verified, the port's outgoing state, the
    FM discriminator carry included, equals the port's sequential
    engine's, and so does the engine's after a fallback."""
    jp = je.DetectorParams()
    params = params_from_jax(jp)
    S, D = 16384, 8
    blk = np.pad(_shard_local_sig()[:nv], ((0, D * S - nv), (0, 0)),
                 constant_values=128)[None]
    state = {k: np.asarray(v) for k, v in je.detector_init(jp, 1).items()}
    ok, js, ts = _both_steps(jp, state, blk, nv, D)
    assert ok == verifies
    seq, _ = te.process_block(params, te.detector_init(params, 1, CPU),
                              torch.from_numpy(blk), nv, flush=True)
    seq = state_to_numpy(seq)
    assert int(seq["out_n"][0]) >= 5
    _, fallbacks, _, states = _port_engine(params, D, [(blk, nv, True)])
    assert fallbacks == int(not verifies)
    assert seq["ook_state"][0] == 0
    _assert_live_state_equal(states[0], seq)
    if ok:
        _assert_live_state_equal(ts, seq)


# ---- the plain chain and gather against the JAX package's own code

def _jax_nested(name, closure):
    """A nested function of jts.timeshard_process_block (``_take_cand``,
    or ``chain``/``chain_step`` inside ``local``), rebuilt from its code
    object over the JAX module's globals with the given free variables."""
    def find(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                if c.co_name == name:
                    return c
                got = find(c)
                if got is not None:
                    return got
        return None
    code = find(jts.timeshard_process_block.__code__)
    cells = tuple(types.CellType(closure[v]) for v in code.co_freevars)
    return types.FunctionType(code, vars(jts), name, None, cells)


def _jax_chain(start, fin, D, C, jp):
    """The JAX package's chain over the same registers: lines :189-243 of
    parallel/timeshard.py, with its own chain/chain_step/_take_cand."""
    vk_always, vk_open = jts._verify_keys(jp)
    vk = vk_always + vk_open
    take = _jax_nested("_take_cand", {})
    chain = _jax_nested("chain", {"_take_cand": take, "params": jp,
                                  "vk": vk, "vkeys_open": vk_open})
    chain_step = _jax_nested("chain_step", {"chain": chain})
    rows = {k: i for i, k in enumerate(ots.TS_KEYS)}

    def key(arr, k, lanes):        # [NROW, lanes*C] -> [lanes, C(, 4)]
        if k in ("hist_p", "hist_g"):
            x = np.stack([arr[rows[f"{k}{i}"]] for i in range(4)], -1)
            return x.reshape(lanes, C, 4)
        return arr[rows[k]].reshape(lanes, C)

    g_start = {k: jnp.asarray(key(start, k, D)) for k in vk}
    g_fin = {k: jnp.asarray(np.swapaxes(key(fin, k, 3 * D).reshape(
        (3, D) + key(fin, k, 3 * D).shape[1:]), 0, 1))
        for k in vk + ("gen",)}                               # [D, 3, C..]
    g_sgen = jnp.asarray(key(start, "gen", D))
    gen0 = g_sgen[0]
    prev0 = {k: g_fin[k][0, 1] for k in vk + ("gen",)}
    tg0 = gen0 + (g_fin["gen"][0, 1] - g_sgen[0])
    xs = ({k: v[1:] for k, v in g_start.items()},
          {k: v[1:] for k, v in g_fin.items()}, g_sgen[1:])
    (_, _, any_bad), (sels, deltas, by_keys) = lax.scan(
        chain_step, (prev0, tg0, jnp.bool_(False)), xs)
    sels = np.concatenate([np.ones((1, C), np.int32), np.asarray(sels)])
    deltas = np.concatenate([np.zeros((1, C), np.int32), np.asarray(deltas)])
    return sels, deltas, np.asarray(by_keys), bool(any_bad)


@pytest.mark.parametrize("seed,D,C", [(1, 8, 5), (2, 4, 33), (3, 2, 1),
                                      (4, 1, 3)])
def test_plain_chain_matches_the_jax_chain(seed, D, C):
    jp = je.DetectorParams()
    start, fin = random_chain(seed, D, C)
    sels, deltas, by_keys, bad = _jax_chain(start, fin, D, C, jp)
    names, rowinfo = ots.verify_layout(*pts._verify_keys(te.DetectorParams()),
                                       pts._COUNTER_KEYS)
    sel, delta, out, masks, tbad = ots.timeshard_chain(
        torch.from_numpy(start), torch.from_numpy(fin), rowinfo, D=D,
        ratio=jp.ook_high_low_ratio)
    assert np.array_equal(sel.numpy(), sels)
    assert np.array_equal(delta.numpy(), deltas)
    bits = (masks.numpy()[:, None] >> np.arange(len(names))) & 1
    assert np.array_equal(bits.astype(bool), by_keys)
    assert bool(tbad[0]) == bad
    if D > 2:
        # every class of key was planted and caught somewhere
        assert by_keys.any(0).sum() >= 8 and bad
    # outgoing registers: the last segment's selected final; counters the
    # seed plus each segment's selected increment (:267-281)
    rows = {k: i for i, k in enumerate(ots.TS_KEYS)}
    f3 = fin.reshape(-1, 3, D, C)
    s3 = start.reshape(-1, D, C)
    last = f3[:, sels[-1], D - 1, np.arange(C)]
    for k, r in rows.items():
        if k in pts._COUNTER_KEYS:
            want = s3[r, 0] + sum(f3[r, sels[d], d, np.arange(C)] - s3[r, d]
                                  for d in range(D))
        else:
            want = last[r]
        assert np.array_equal(out[r].numpy(), want), k


def _straight_walk(start, fin, rowinfo, D, ratio):
    """The chain as the JAX lines walk it (parallel/timeshard.py:194-243,
    then :267-281), link by link in numpy int32: verify the predecessor's
    selected final against the next start, select the hedge candidate,
    advance t_gen; then the last segment's selected final and the
    re-based counters."""
    rows = {k: i for i, k in enumerate(ots.TS_KEYS)}
    low, high, ook = rows["low_est"], rows["high_est"], rows["ook_state"]
    mh, gen = rows["min_high"], rows["gen"]
    nrow = start.shape[0]
    C = start.shape[1] // D
    st = start.reshape(nrow, D, C)
    f3 = fin.reshape(nrow, 3, D, C)
    info = rowinfo.tolist()
    cc = np.arange(C)
    with np.errstate(over="ignore"):
        prev = f3[:, 1, 0]
        tgen = st[gen, 0] + (prev[gen] - st[gen, 0])
        sels, deltas = [np.ones(C, np.int32)], [np.zeros(C, np.int32)]
        masks = []
        for d in range(1, D):
            s = st[:, d]
            dlow = prev[low] - s[low]
            sel = np.clip(dlow + 1, 0, 2)
            open_m = prev[ook] != det.ST_IDLE
            cand_high = np.where(s[ook] == det.ST_IDLE,
                                 np.maximum(np.int32(ratio) * (s[low] + dlow),
                                            s[mh]), s[high])
            mask = int((np.abs(dlow) > 1).any()) | \
                int((prev[high] != cand_high).any()) << 1
            for r, v in enumerate(info):
                k = (v & 0xff) - 1
                if k < 2:
                    continue
                b = prev[r] != s[r]
                if v & ots.OPEN_BIT:
                    b = b & open_m
                mask |= int(b.any()) << k
            masks.append(mask)
            deltas.append(tgen - s[gen])
            prev = f3[:, sel, d, cc]
            tgen = tgen + (prev[gen] - s[gen])
            sels.append(sel.astype(np.int32))
        out = prev.copy()
        for r, v in enumerate(info):
            if v & ots.COUNTER_BIT:
                acc = st[r, 0].copy()
                for d in range(D):
                    acc = acc + (f3[r, sels[d], d, cc] - st[r, d])
                out[r] = acc
    return (np.stack(sels), np.stack(deltas), out,
            np.asarray(masks, np.int32), np.asarray([int(any(masks))],
                                                    np.int32))


@pytest.mark.parametrize("seed,D,C", [(5, 1, 3), (6, 2, 300), (7, 8, 5),
                                      (8, 32, 1), (9, 32, 40), (10, 64, 7)])
def test_phase_order_chain_equals_the_straight_walk(seed, D, C):
    """timeshard_chain_plain computes every link's compares for all three
    predecessor candidates at once, then walks the selections, then
    gathers the outgoing registers (the kernel's three phases); the
    result must equal the JAX lines' walk link by link."""
    start, fin = random_chain(seed, D, C)
    names, rowinfo = ots.verify_layout(*pts._verify_keys(te.DetectorParams()),
                                       pts._COUNTER_KEYS)
    ratio = te.DetectorParams().ook_high_low_ratio
    want = _straight_walk(start, fin, rowinfo, D, ratio)
    got = ots.timeshard_chain_plain(torch.from_numpy(start),
                                    torch.from_numpy(fin), rowinfo, D=D,
                                    ratio=ratio)
    for g, w, k in zip(got, want, ("sel", "delta", "out", "by_key", "bad")):
        assert g.dtype == torch.int32, k
        assert np.array_equal(g.numpy(), w), k
    if D >= 32 and C > 1:
        # a mismatch of every class was planted and caught: low_est,
        # high_est, an always-compared key and an open-compared key
        hit = {names[i] for i in range(len(names))
               if (want[3] >> i & 1).any()}
        assert {"low_est", "high_est"} <= hit
        assert hit & set(pts._VERIFY_ALWAYS) - {"low_est", "high_est"}
        assert hit & set(pts._VERIFY_OPEN)
        assert want[4][0] == 1


@pytest.mark.parametrize("D,C,want", [(1, 3, (3, 1)), (32, 1, (1, 1)),
                                      (8, 4096, (32, 128)), (64, 33, (32, 2)),
                                      (2000, 5, (3, 2))])
def test_chain_plan(D, C, want):
    """Up to 32 channels per block; fewer where D's per-link tables would
    pass the 227 KB a block may use; the shared bytes within it."""
    g, smem, blocks = ots.chain_plan(D, C)
    assert (g, blocks) == want
    assert smem == 4 * ots.NROW + g * D * ots.CHAIN_BYTES_PER_LINK
    assert smem <= ots.SMEM_MAX
    with pytest.raises(ValueError):
        ots.chain_plan(8000, 1)

@pytest.mark.parametrize("D,C,R,G,E", [(8, 3, 8, 4, 2), (2, 1, 2, 16, 1),
                                       (1, 2, 4, 2, 3)])
def test_plain_gather_matches_the_jax_lines(D, C, R, G, E):
    """timeshard_gather_plain against JAX's select and rebase (:245-265) per
    segment, concatenated along the segment axis as its out_specs do."""
    key3, p3, g3, eop3, sel, delta = random_logs(D * 100 + C, D, C, R, G,
                                                 E)
    L3 = 3 * D * C
    take = _jax_nested("_take_cand", {})
    gshift = 1 << det.KEY_IDX_BITS
    outs = []
    for d in range(D):
        idx = (np.arange(3)[:, None] * D + d) * C + np.arange(C)  # [3, C]
        sel_d = jnp.asarray(sel[d])

        def pick(x3):
            x = jnp.asarray(x3.reshape(L3, R, G)[idx])          # [3, C, R, G]
            return take(x, sel_d).reshape(C * R, G)
        ky, py, gy = pick(key3), pick(p3), pick(g3)
        ey = take(jnp.asarray(eop3[idx]), sel_d)
        kvalid = ky < det.KEY_INVALID
        deltaR = jnp.repeat(jnp.asarray(delta[d]), R)
        ky = jnp.where(kvalid, ky + deltaR[:, None] * gshift, ky)
        evalid = ey[:, :, det.M_TYPE] != det.PKG_NONE
        ey = ey.at[:, :, det.M_GEN].add(
            jnp.where(evalid, jnp.asarray(delta[d])[:, None], 0))
        outs.append([np.asarray(v) for v in (ky, py, gy, ey)])
    want = [np.concatenate([o[i] for o in outs], 1) for i in range(4)]
    got = ots.timeshard_gather_plain(*(torch.from_numpy(a) for a in
                                       (key3, p3, g3, eop3, sel, delta)),
                                     R=R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


# ---- the order of the CPU step: chain, the verdict, then the plain gather
# only where the block verified or under debug

def _counting_plain_gather(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    plain = ots.timeshard_gather_plain
    monkeypatch.setattr(ots, "timeshard_gather_plain", spy)
    return calls


@pytest.mark.parametrize("seed,D,debug", [(1, 1, False), (2, 8, False),
                                          (3, 8, True)])
def test_chain_gather_pair_on_the_cpu(seed, D, debug, monkeypatch):
    """timeshard_chain_gather on CPU tensors: the chain's five outputs, the
    verdict read from ``bad``, and the plain gather's logs where the block
    verified (D=1: no link) or under debug; a failed block without debug
    gives no logs and never calls the gather."""
    C, R, G, E = 3, 4, 8, 2
    start, fin = random_chain(seed, D, C)
    _, rowinfo = ots.verify_layout(*pts._verify_keys(te.DetectorParams()),
                                   pts._COUNTER_KEYS)
    ratio = te.DetectorParams().ook_high_low_ratio
    key3, p3, g3, eop3, _, _ = (torch.from_numpy(a) for a in
                                random_logs(seed, D, C, R, G, E))
    args = (torch.from_numpy(start), torch.from_numpy(fin), rowinfo)
    calls = _counting_plain_gather(monkeypatch)
    chain, ok, logs = ots.timeshard_chain_gather(
        *args, key3, p3, g3, eop3, D=D, ratio=ratio, R=R, debug=debug)
    want = ots.timeshard_chain_plain(*args, D=D, ratio=ratio)
    for g, w in zip(chain, want):
        assert torch.equal(g, w)
    assert ok == (D == 1) == (int(want[4][0]) == 0)
    if ok or debug:
        assert len(calls) == 1
        for g, w in zip(logs, ots.timeshard_gather_plain(
                key3, p3, g3, eop3, want[0], want[1], R=R)):
            assert torch.equal(g, w)
    else:
        assert logs is None and not calls


def test_failed_block_under_debug_gathers_as_jax(monkeypatch):
    """A package longer than a 2-chunk halo across a segment boundary: the
    block fails in both packages. Under debug the CPU step still gathers
    (once, after the verdict) and drains, and its whole outgoing state
    equals JAX's debug step; without debug it never gathers and returns
    the incoming state."""
    jp = je.DetectorParams()
    blk, n = _pad(_long_package_sig(), 8)
    state = {k: np.asarray(v) for k, v in je.detector_init(jp, 1).items()}
    js, javg, jok, _ = _jax_step(jp, 8, 2, True)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(blk),
        jnp.int32(n))
    assert not bool(jok)
    x = torch.from_numpy(np.ascontiguousarray(blk))
    calls = _counting_plain_gather(monkeypatch)
    for debug in (False, True):
        fn = pts.timeshard_process_block(params_from_jax(jp), _mesh(8),
                                         halo_chunks=2, flush=True,
                                         debug=debug)
        st = state_from_numpy(state, CPU)
        out = fn(st, x, n)
        assert out[2] is False
        assert len(calls) == int(debug)
        assert (out[0] is st) == (not debug)
    ts = state_to_numpy(out[0])
    assert sorted(ts) == sorted(js)
    for k in js:
        assert np.array_equal(ts[k], np.asarray(js[k])), k
    assert any(not np.array_equal(ts[k], state[k]) for k in state)
    assert np.allclose(np.asarray(javg), out[1].numpy(), atol=1e-4)


# ---- per-lane origins: one launch for many regions == one call per region

def test_lane_origin_frontend_and_detector_equal_per_segment_calls():
    """The segment-batched plain front end and detector (lanes at their
    own origins, n_valid in the block frame inside a segment) equal one
    plain call per segment with a scalar t0, column for column."""
    rng = np.random.default_rng(7)
    D, C, S = 4, 2, 512
    params = te.DetectorParams(fsk_minmax=False, chunk=128)
    blk = np.full((C, D * S, 2), 128, np.uint8)
    for c in range(C):
        sig = synth_fsk(fsk_pcm_bits("1100101011110000" * 8, bit_us=60),
                        rate=250_000, lead_in_us=400, tail_us=600,
                        seed=c + 1)[:D * S]
        blk[c, :sig.shape[0]] = sig
    nv = 3 * S - 77
    iq = torch.from_numpy(blk).view(C, D, S, 2).transpose(0, 1).reshape(
        D * C, S, 2).contiguous()
    t0 = (torch.arange(D, dtype=torch.int32)[:, None] * S).expand(
        D, C).reshape(-1).contiguous()
    st = torch.from_numpy(rng.integers(-200, 200, (6, D * C)).astype(
        np.int32))
    alp1, blp = fe._coeffs(250_000, True, 0.0, False)
    kw = dict(use_mag_est=False, enable_fm=True, alp1=alp1, blp=blp)
    got = fe.frontend_plain(iq, st, n_valid=nv, lane_t0=t0, **kw)
    state = te.detector_init(params, D * C, CPU)
    regs = det.pack_regs(state)
    regs[det.REG_KEYS.index("lead_in")] = 2000
    gen0 = torch.from_numpy(rng.integers(0, 3, D * C).astype(np.int32))
    dgot = det.detector_scan_plain(got[0], got[1], regs, gen0, params=params,
                                   n_valid=nv, lane_t0=t0)
    R, G = params.ring, S // params.chunk
    for d in range(D):
        cols = torch.arange(d * C, (d + 1) * C)
        want = fe.frontend_plain(iq[cols], st[:, cols],
                                 n_valid=min(max(nv - d * S, 0), S), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g[..., cols], w)
        dwant = det.detector_scan_plain(want[0], want[1], regs[:, cols],
                                        gen0[cols], params=params,
                                        n_valid=nv, t0=d * S)
        rows = (cols[:, None] * R + torch.arange(R)).reshape(-1)
        assert torch.equal(dgot[0][:, cols], dwant[0])
        for i in (1, 2, 3):
            assert torch.equal(dgot[i][rows], dwant[i])
        assert torch.equal(dgot[4][cols], dwant[4])
        assert torch.equal(dgot[5][cols], dwant[5])
    # the batch holds records: the comparison is not of empty logs
    assert int((dgot[1] < det.KEY_INVALID).sum()) > 0


def test_unmasked_step_is_the_full_block_step():
    """``masked=False`` builds ``fn(state, iq)``: the step of a block with
    every sample valid."""
    params = te.DetectorParams()
    blk, _ = _pad(PWM_SIG()[:4 * 4096], 4)
    state = te.detector_init(params, 1, CPU)
    x = torch.from_numpy(np.ascontiguousarray(blk))
    got = pts.timeshard_process_block(params, _mesh(4), masked=False)(state,
                                                                       x)
    want = pts.timeshard_process_block(params, _mesh(4))(state, x,
                                                         x.shape[1])
    assert got[2] == want[2]
    assert torch.equal(got[1], want[1])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k


def test_distinct_devices_are_refused():
    mesh = Mesh([CPU, torch.device("meta")], ("sp",), (2,))
    with pytest.raises(NotImplementedError, match="item 13"):
        pts.timeshard_process_block(te.DetectorParams(), mesh)
    with pytest.raises(NotImplementedError, match="item 13"):
        pts.TimeShardEngine(te.DetectorParams(), mesh=mesh)


def test_no_gpu_no_default_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pts.TimeShardEngine(te.DetectorParams())


def test_every_state_key_is_classified(monkeypatch):
    """The port's verify keys are the JAX package's (its ring keys are
    skipped there and absent here); an unclassified key raises."""
    jp = je.DetectorParams()
    assert pts._verify_keys(te.DetectorParams()) == jts._verify_keys(jp)
    bad = dict(te.detector_init(te.DetectorParams(), 1, CPU), extra=None)
    monkeypatch.setattr(pts, "detector_init", lambda *a, **k: bad)
    with pytest.raises(ValueError, match="unclassified"):
        pts._verify_keys(te.DetectorParams())

"""The port's device-slicing dispatch against the JAX package's, on the
CPU.

``decoders/device_dispatch.py`` is the JAX module with its declared
differences (an AST comparison holds the rest to its twin): the bank runs
on an explicit ``torch.device``, host reads of kernel outputs go through
``.cpu()``, lazy records' bytes come through the batched gather (one
launch for every family of a materialization pass), and
``_content_dup`` returns the first equal event e' <= e, where the JAX
code's reversed mask always returns e itself (a JAX-side fault: its
dedup never merges; the events do not change, the grouping only saves
decode calls). Then, on the same inputs:

- ``_content_dup`` against a NumPy statement of its contract, with planted
  duplicate events (and against JAX's where no event repeats);
- ``_gather_records`` against JAX's;
- ``DeviceBank.batch_slice``: summaries and every record's bytes equal
  JAX's; ``group_of`` merges JAX's groups only where records are equal;
- ``Registry.prewarm_trains``: the memo is filled, the decode cache
  holds JAX's keys and decodes (the port reads the records in at most
  three gather calls a prewarm: each side's MIC-gated representatives
  before the per-train plans, then every kept record of the drain, the
  decode-cache keys included, where JAX reads each key's record alone;
  two trains whose MIC representatives share their content are read in
  one call, with the memos of a prewarm without that pass), and the
  fuzz dispatch's events and
  stats equal the JAX device path's and the port's own host path's
  (Security+ on a frozen clock);
- the CLI's ``-Y deviceslice`` and ``TPU433_DEVICE_SLICE=1``
  (fixtures of every slicer family: tests/test_torch_device_fixtures.py);
- ``ShardedEngine`` with device slicing on a 4-device CPU mesh: the JAX
  engine's events, in order.
"""

import ast
import os

import numpy as np
import pytest
import torch

import rtl_433_tpu.decoders.device_dispatch as jdd
import rtl_433_tpu.decoders.garage as jgarage
from rtl_433_tpu.decoders import Registry as JaxRegistry
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
import rtl_433_tpu_torch.decoders.base as tbase
import rtl_433_tpu_torch.decoders.device_dispatch as tdd
import rtl_433_tpu_torch.decoders.garage as tgarage
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse.data import PulseData

from torch_slice_cases import dup_edge_planes, dup_planes, mixed_trains

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 250_000


class _Frozen:
    @staticmethod
    def monotonic():
        return 0.0


@pytest.fixture
def frozen_clock(monkeypatch):
    """Security+ pairs its halves within 0.8 s of time.monotonic(): one
    fixed clock for both packages, so pairing does not depend on speed."""
    monkeypatch.setattr(jgarage, "time", _Frozen)
    monkeypatch.setattr(tgarage, "time", _Frozen)


# ---------------------------------------------------------------------------
# the module against its twin
# ---------------------------------------------------------------------------

# top-level names the port defines differently (the two kernels, their
# plain versions and the batched gather's helpers), and class members that
# differ: ``_materialize`` gathers every family of a pass in one launch,
# ``prefetch_many`` reads a drain's MIC representatives; the port's bank always
# has the host slicer library (a failed build raises), so it has no
# Python slicing path (``_python_rows``) and no branch for a missing
# library in ``_get_ovf_bank``, ``_rest_cols`` and ``batch_slice``
MODULE_DIFFERENCES = {"_gather_jit", "_gather_records", "_content_dup",
                      "_planes", "_content_dup_plain",
                      "_gather_records_plain", "_GF_COLS", "_gather_groups",
                      "_gather_plan", "_gather_many_plain", "_gather_many"}
MEMBER_DIFFERENCES = {("LazyRecords", "__getitem__"),
                      ("LazyRecords", "_materialize"),
                      ("LazyRecords", "prefetch_many"),
                      ("DeviceBank", "__init__"),
                      ("DeviceBank", "batch_slice"),
                      ("DeviceBank", "_get_ovf_bank"),
                      ("DeviceBank", "_rest_cols"),
                      ("DeviceBank", "_python_rows")}


def _stripped(node):
    node = ast.parse(ast.unparse(node))
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            n.body = body[1:] or [ast.Pass()]
    return ast.dump(node, include_attributes=False)


def _members(pkg):
    path = os.path.join(REPO, pkg, "decoders", "device_dispatch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(n, ast.ClassDef):
            for m in n.body:
                if isinstance(m, ast.FunctionDef):
                    out[(n.name, m.name)] = m
            continue
        if isinstance(n, ast.Expr):
            continue            # the module docstring
        names = [n.name] if hasattr(n, "name") else \
            [t.id for t in getattr(n, "targets", []) if hasattr(t, "id")]
        for name in names:
            out[name] = n
    return out


def test_module_matches_jax_twin():
    j, t = _members("rtl_433_tpu"), _members("rtl_433_tpu_torch")
    skip = MODULE_DIFFERENCES | MEMBER_DIFFERENCES
    shared = sorted((k for k in j if k not in skip), key=str)
    assert shared and set(shared) <= set(t)
    for k in shared:
        assert _stripped(j[k]) == _stripped(t[k]), f"{k} differs from JAX"
    # nothing else is new in the port
    assert {k for k in t if k not in j} <= skip


# ---------------------------------------------------------------------------
# content dedup and record gather
# ---------------------------------------------------------------------------

def _dup_contract(p):
    """dup[b, j, e]: the first e' <= e whose row count, and bit counts,
    syncs and bytes of the rows below it, equal e's."""
    nb, nr, bpr, sy = (p[k] for k in ("bytes", "num_rows", "bits_per_row",
                                      "syncs"))
    B, J, E, R, _W = nb.shape
    out = np.zeros((B, J, E), np.int32)
    for b in range(B):
        for j in range(J):
            for e in range(E):
                rows = min(max(nr[b, j, e], 0), R)
                out[b, j, e] = next(
                    e2 for e2 in range(e + 1)
                    if nr[b, j, e2] == nr[b, j, e]
                    and np.array_equal(bpr[b, j, e2, :rows],
                                       bpr[b, j, e, :rows])
                    and np.array_equal(sy[b, j, e2, :rows],
                                       sy[b, j, e, :rows])
                    and np.array_equal(nb[b, j, e2, :rows],
                                       nb[b, j, e, :rows]))
    return out


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_content_dup_finds_the_first_equal_earlier_event(seed):
    p = dup_planes(seed)
    want = _dup_contract(p)
    assert (want != np.arange(p["bytes"].shape[2])).sum() >= 3
    got = tdd._content_dup(_torch(p))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the JAX mask keeps e' >= e, so JAX returns e for every event
    jax_dup = np.asarray(jdd._content_dup(p))
    assert np.array_equal(jax_dup, np.broadcast_to(
        np.arange(p["bytes"].shape[2]), jax_dup.shape))


def test_content_dup_equals_jax_where_no_event_repeats():
    p = dup_planes(4, plant=False)
    got = tdd._content_dup(_torch(p)).numpy()
    assert np.array_equal(got, np.asarray(jdd._content_dup(p)))


# the shapes the kernel's compares must handle: the bank's caps (rows of
# 20 bytes, events of 320 and 480, 16-byte aligned), rows of 7 and 13
# bytes (R * W = 35, 65: byte tails, unaligned bases), 20-byte rows with
# R * W = 100 (4-byte aligned bases), one event per lane, and 8 lanes of 4
# events filling a warp
DUP_SHAPES = [(4, 16, 20), (8, 24, 20), (6, 5, 7), (8, 5, 13), (8, 5, 20),
              (1, 3, 7), (4, 2, 13)]


@pytest.mark.parametrize("E,R,W", DUP_SHAPES, ids=str)
def test_content_dup_edges_follow_the_contract(E, R, W):
    """Counts of -1 and R + 1 (compared raw, rows clamped), an all-zero
    lane, repeats whose scratch rows differ, near repeats that differ in
    one value of the live prefix: the plain version against the NumPy
    statement of the contract."""
    p = dup_edge_planes(E + R + W, E=E, R=R, W=W)
    want = _dup_contract(p)
    got = tdd._content_dup(_torch(p)).numpy()
    assert np.array_equal(got, want)
    assert (want[0, 0] == 0).all()
    if E > 1:
        assert (want != np.arange(E)).sum() >= 3
    # the near repeats and the negative counts are there
    assert (p["num_rows"] == -1).any() and (p["num_rows"] == R + 1).any()


@pytest.mark.parametrize("E,R,W", DUP_SHAPES, ids=str)
def test_content_dup_edges_equal_jax_where_no_event_repeats(E, R, W):
    p = dup_edge_planes(E * R * W, E=E, R=R, W=W, plant=False)
    got = tdd._content_dup(_torch(p)).numpy()
    assert np.array_equal(got, _dup_contract(p))
    assert np.array_equal(got, np.asarray(jdd._content_dup(p)))


@pytest.mark.parametrize("E", [32, 33, 64])
def test_content_dup_plain_takes_any_events_per_lane(E):
    """The kernel holds a lane's events in one warp, so on the card more
    than 32 raise (tests/test_torch_cuda.py); the plain version, for CPU
    planes, takes any E."""
    p = dup_edge_planes(E, B=2, J=3, E=E, R=2, W=3)
    want = _dup_contract(p)
    assert np.array_equal(tdd._content_dup(_torch(p)).numpy(), want)
    assert (want != np.arange(E)).any()


def test_gather_records_matches_jax():
    p = dup_planes(5)
    rng = np.random.default_rng(5)
    P = 16
    idx = [rng.integers(0, n, P).astype(np.int32)
           for n in p["bytes"].shape[:3]]
    want = jdd._gather_records(p["bytes"], p["syncs"], *idx)
    before = dict(_cuda.LAUNCHES)
    got = tdd._gather_records(torch.from_numpy(p["bytes"]),
                              torch.from_numpy(p["syncs"]), *idx)
    assert _cuda.LAUNCHES == before
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert np.array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="out of range"):
        tdd._gather_records(torch.from_numpy(p["bytes"]),
                            torch.from_numpy(p["syncs"]), idx[0], idx[1],
                            idx[2] + 100)


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

def _active(reg_cls, fsk):
    reg = reg_cls()
    reg.register_all()
    return [d for d in reg.active if d.is_fsk == fsk]


def _repeat(p, g, k):
    """A train sent ``k`` times, each copy ended by a reset gap: its
    events repeat within every lane that decodes it."""
    return list(p) * k, (list(g[:-1]) + [max(g[-1], 20000)]) * k


@pytest.mark.parametrize("fsk", [False, True])
def test_batch_slice_matches_jax(fsk):
    tdevs, jdevs = _active(Registry, fsk), _active(JaxRegistry, fsk)
    assert [d.symbol for d in tdevs] == [d.symbol for d in jdevs]
    trains = mixed_trains(tdevs, 21, n=10)
    trains += [_repeat(*trains[i], 3) for i in range(3)]
    trains = [(np.asarray(p, np.int32), np.asarray(g, np.int32))
              for p, g in trains]
    jres = jdd.DeviceBank(jdevs, RATE).batch_slice(trains)
    tres = tdd.DeviceBank(tdevs, RATE, "cpu").batch_slice(trains)
    assert len(tres) == len(jres) == len(trains)
    merged = 0
    for (ts, tr, tg), (js, jr, jg) in zip(tres, jres):
        assert np.array_equal(ts, js)
        k = len(ts)
        tr.materialize_many(range(k))
        jr.materialize_many(range(k))
        blobs = [tr[i] for i in range(k)]
        assert blobs == [jr[i] for i in range(k)]
        # the port's groups are unions of JAX's, of equal records
        for i in range(k):
            g = int(tg[i])
            assert int(tg[int(jg[i])]) == g
            assert ts[g, 0] == ts[i, 0] and blobs[g] == blobs[i]
            merged += g != int(jg[i])
    assert merged > 0


def test_lazy_record_reads_one_record_through_the_gather():
    devs = _active(Registry, False)
    trains = [(np.asarray(p, np.int32), np.asarray(g, np.int32))
              for p, g in mixed_trains(devs, 8, n=4)]
    bank = tdd.DeviceBank(devs, RATE, torch.device("cpu"))
    summary, records, _g = bank.batch_slice(trains)[0]
    lazy = [i for i in range(len(summary)) if records._kind[i] >= 0]
    assert lazy
    one = records[lazy[0]]
    again = tdd.DeviceBank(devs, RATE, "cpu").batch_slice(trains)[0][1]
    again.materialize_many([lazy[0]])
    assert one == again[lazy[0]]


def test_device_bank_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdd.DeviceBank(_active(Registry, False), RATE, "cuda")


# ---------------------------------------------------------------------------
# the registry: prewarm and dispatch
# ---------------------------------------------------------------------------

def _fuzz_trains(n, seed=7):
    from test_device_dispatch import _fuzz_trains
    return _fuzz_trains(np.random.default_rng(seed), n)


def _registry(cls, device_slice):
    reg = cls()
    reg.register_all()
    reg.device_slice = device_slice
    if device_slice and cls is Registry:
        reg.slice_device = "cpu"
    return reg


def _dispatch_all(reg, trains, prewarm):
    """Every train through the registry: (events, stats)."""
    if prewarm:
        assert reg.prewarm_trains(trains, RATE) > 0
    out = []
    for fsk, p, g in trains:
        pd = PulseData(sample_rate=RATE)
        pd.pulse, pd.gap = list(p), list(g)
        got = []
        reg._run(pd, want_fsk=fsk, event_cb=lambda dev, ev: got.append(
            (dev.num, dev.symbol, repr(list(ev.fields)))))
        out.append(got)
    stats = {d.symbol: (d.decode_events, d.decode_ok,
                        dict(sorted(d.decode_fails.items())))
             for d in reg.active}
    return out, stats


def test_prewarm_fills_the_memo_cache():
    trains = _fuzz_trains(6, seed=11)
    reg = _registry(Registry, True)
    assert reg.prewarm_trains(trains, RATE) == len(
        {(bool(f), tuple(p), tuple(g)) for f, p, g in trains})
    for fsk, p, g in trains:
        assert (bool(fsk), RATE, np.asarray(p, np.int32).tobytes(),
                np.asarray(g, np.int32).tobytes()) in reg._train_cache
    # a second prewarm of the same drain builds nothing
    assert reg.prewarm_trains(trains, RATE) == 0
    # without device slicing, prewarm is a no-op
    assert _registry(Registry, False).prewarm_trains(trains, RATE) == 0


def _cache_view(reg):
    """The decode cache as comparable values: per key, the events' fields
    or the decode code."""
    return {k: [repr(list(e.fields)) for e in v] if isinstance(v, list)
            else v for k, v in reg._dec_cache.items()}


def _gather_passes(monkeypatch):
    """Record every batched gather call as (pass, groups): the pass is
    ``mic`` (LazyRecords.prefetch_many), ``gate`` (a MIC gate's
    materialize_many), ``freeze`` (freeze_many) or ``single`` (one lazy
    record read alone)."""
    ctx, calls = [], []
    real_gather = tdd._gather_many
    L = tdd.LazyRecords

    def gather(groups):
        calls.append((ctx[-1] if ctx else "single", list(groups)))
        return real_gather(groups)

    def within(name, fn):
        def run(*a, **k):
            ctx.append(name)
            try:
                return fn(*a, **k)
            finally:
                ctx.pop()
        return run

    monkeypatch.setattr(tdd, "_gather_many", gather)
    monkeypatch.setattr(L, "materialize_many",
                        within("gate", L.materialize_many))
    monkeypatch.setattr(L, "prefetch_many",
                        staticmethod(within("mic", L.prefetch_many)))
    monkeypatch.setattr(L, "freeze_many",
                        staticmethod(within("freeze", L.freeze_many)))
    return calls


@pytest.fixture(scope="module")
def fuzz_prewarm():
    """One port prewarm of a 24-train fuzz drain with every gather call
    recorded (``_gather_passes``), which the two tests below read:
    (trains, registry, memos built, gather calls)."""
    trains = _fuzz_trains(24, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        calls = _gather_passes(mp)
        reg = _registry(Registry, True)
        built = reg.prewarm_trains(trains, RATE)
    return trains, reg, built, calls


def test_prewarm_decodes_the_same_candidates_as_jax(fuzz_prewarm):
    """The port reads the declarative candidates' cache keys after the
    drain-wide freeze, where JAX reads each before it: the same keys and
    the same decodes."""
    trains, t, built, _calls = fuzz_prewarm
    j = _registry(JaxRegistry, True)
    assert built == j.prewarm_trains(trains, RATE)
    assert t._dec_cache and _cache_view(t) == _cache_view(j)


def test_prewarm_reads_records_in_batched_gathers(fuzz_prewarm):
    """No record of a drain is read alone: a prewarm makes at most three
    gather calls, each one launch for every family it touches: the MIC
    gates' representatives of each side (one call per side, before the
    per-train plans) and the drain-wide freeze; the gates' own batches
    find their records ready."""
    trains, reg, built, calls = fuzz_prewarm
    assert {bool(f) for f, _p, _g in trains} == {False, True}
    assert built > 0
    assert reg._dec_cache
    passes = [c[0] for c in calls]
    assert set(passes) == {"mic", "freeze"}, passes
    assert passes.count("mic") <= 2 and passes.count("freeze") == 1
    assert len(calls) <= 3
    # one call gathers several families, of several trains
    fam_calls = [c for c in calls if len(c[1]) > 1]
    assert fam_calls
    assert any(len({int(b) for g in groups for b in g[2]}) > 1
               for _p, groups in calls)


def _mic_train(reg, trains):
    """The first train whose device-sliced plan has MIC-gated
    representatives."""
    for fsk, p, g in trains:
        bank = reg._get_device_bank(bool(fsk), RATE)
        meta = reg._bank_meta(bank)
        summary, _rec, group_of = bank.batch_slice(
            [(np.asarray(p, np.int32), np.asarray(g, np.int32))])[0]
        if len(summary) and tbase._mic_representatives(
                bank.devices, meta, summary, group_of):
            return fsk, p, g
    raise AssertionError("no train with MIC-gated representatives")


def test_prewarm_gathers_shared_mic_representatives_in_one_call(
        monkeypatch, frozen_clock):
    """Two trains of one drain whose MIC-gated records have the same
    content (a train, and the same train sent twice): their
    representatives come in one gather call with records of both trains,
    and the memos, decode cache, events and stats equal those of a
    prewarm in which each train's gates read their own records (no
    prefetch)."""
    probe = _registry(Registry, True)
    fsk, p, g = _mic_train(probe, _fuzz_trains(8, seed=5))
    p2, g2 = _repeat(p, g, 2)
    drain = [(fsk, p, g), (fsk, p2, g2)]
    calls = _gather_passes(monkeypatch)
    reg = _registry(Registry, True)
    assert reg.prewarm_trains(drain, RATE) == 2
    mic = [groups for kind, groups in calls if kind == "mic"]
    assert len(mic) == 1
    assert {int(b) for grp in mic[0] for b in grp[2]} == {0, 1}
    assert [kind for kind, _g in calls].count("freeze") == 1

    monkeypatch.setattr(tdd.LazyRecords, "prefetch_many",
                        staticmethod(lambda items: None))
    alone = _registry(Registry, True)
    assert alone.prewarm_trains(drain, RATE) == 2
    assert [m["priorities"] for m in reg._train_cache.values()] == \
        [m["priorities"] for m in alone._train_cache.values()]
    assert _cache_view(reg) == _cache_view(alone)
    assert _dispatch_all(reg, drain, prewarm=False) == \
        _dispatch_all(alone, drain, prewarm=False)


def test_fuzz_dispatch_matches_jax_and_host(frozen_clock):
    trains = _fuzz_trains(40)
    dev_ev, dev_stats = _dispatch_all(_registry(Registry, True), trains,
                                      prewarm=True)
    host_ev, host_stats = _dispatch_all(_registry(Registry, False), trains,
                                        prewarm=False)
    jax_ev, jax_stats = _dispatch_all(_registry(JaxRegistry, True), trains,
                                      prewarm=True)
    assert sum(map(len, dev_ev)) > 0
    for i, (d, h, j) in enumerate(zip(dev_ev, host_ev, jax_ev)):
        assert d == h, f"train {i}: device {d[:2]} != host {h[:2]}"
        assert d == j, f"train {i}: port {d[:2]} != JAX {j[:2]}"
    assert dev_stats == host_stats == jax_stats


# ---------------------------------------------------------------------------
# end to end: fixtures, the CLI, ShardedEngine
# ---------------------------------------------------------------------------

def test_cli_deviceslice_and_environment(capsys, monkeypatch):
    from rtl_433_tpu_torch import cli
    nexus = os.path.join(REPO, "tests", "fixtures", "nexus",
                         "g001_433.92M_250k.cu8")
    outs = []
    for extra in ([], ["-Y", "deviceslice"]):
        assert cli.main(["-R", "19", "-r", nexus, "-F", "json", "--device",
                         "cpu", *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()
    monkeypatch.setenv("TPU433_DEVICE_SLICE", "1")
    rx = RtlTpu(device="cpu")
    assert rx.registry.device_slice
    assert rx.registry.slice_device == torch.device("cpu")


def test_sharded_engine_device_slice_matches_jax():
    """tests/test_device_dispatch.py's ShardedEngine case on both
    packages: 4 channels on a 4-device CPU mesh, device slicing on."""
    from rtl_433_tpu.parallel.sharding import ShardedEngine as JaxEngine
    from rtl_433_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from rtl_433_tpu_torch.dsp.engine import DetectorParams
    from rtl_433_tpu_torch.parallel.sharding import (ShardedEngine,
                                                     make_mesh)
    from test_sharding import _nexus_iq
    from test_sharding import _params as jax_params

    channels, n = 4, 98304
    iq = np.zeros((channels, n, 2), np.uint8) + 128
    for c in range(0, channels, 2):
        iq[c] = _nexus_iq(n, seed=c)
    runs = {}
    for mode in (False, True):
        reg = _registry(Registry, mode)
        eng = ShardedEngine(DetectorParams(sample_rate=250_000, pkg_cap=4),
                            channels, make_mesh(devices=["cpu"] * 4),
                            registry=reg)
        eng.push(iq, flush=True)
        runs[mode] = [(c, event_to_json(ev)) for c, ev in
                      eng.drain_events()]
        if mode:
            assert reg._train_cache
            assert reg.slice_device == torch.device("cpu")
    jreg = _registry(JaxRegistry, True)
    jeng = JaxEngine(jax_params(), channels, jax_make_mesh(4),
                     registry=jreg)
    jeng.push(iq, flush=True)
    want = [(c, jax_event_to_json(ev)) for c, ev in jeng.drain_events()]
    assert runs[True] == runs[False] == want
    assert any("Nexus" in e for _, e in want)

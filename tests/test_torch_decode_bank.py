"""The port's declarative decode bank on torch against the JAX package's
``xp=jnp`` backend, on the CPU.

``ops/decode_bank.py::run_torch`` is the JAX ``run(xp=jnp)`` path: on a
CPU tensor its plain version (torch), on a CUDA tensor the kernel
``csrc/decl_bank.cu`` (held to the plain version in
tests/test_torch_cuda.py and chip_smoke.py). Here:

- the tables the bank carries to a device (``bank_tables``) are the JAX
  bank's arrays, and the kernel's spec rows encode them; its sparse
  entry lists (``sparse_tables``) rebuild the dense weights exactly;
- the kernel's sparse evaluation, emulated in plain torch
  (``run_torch_sparse_plain``: frame words, a frame bit per entry, a
  XOR or sum per chunk), equals JAX's ``run(xp=jnp)`` on the fuzz batch
  (with rows whose frame starts before bit 0), the oracle candidates,
  the empty batch and rows of 500 bits;
- the plain bank equals JAX's ``run(xp=jnp)`` bit for bit, code and raws,
  on seeded batches (tests/torch_decl_cases.py) over every spec that reach
  every stage: a matched preamble, invert, Manchester with its stop pair,
  both check kinds passing and failing, stale stored bits read below
  ``n_store`` (which change results), rows of every length;
- ``DeclRunner.decode_many(device="cpu")`` gives the JAX runner's
  ``decode_many(xp=jnp)`` result on the vectors of
  tests/test_declarative.py, FALLBACK where JAX falls back;
- device slicing on the CPU decodes its drain's declarative batch with
  ``run_torch`` (a declared difference: JAX's prewarm runs it on NumPy)
  and gives the JAX device path's events, stats and decode cache;
- ``device="cuda"`` is refused where there is no GPU.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rtl_433_tpu.decoders.declarative as jdecl
import rtl_433_tpu.decoders.garage as jgarage
import rtl_433_tpu.ops.decode_bank as jdbk
from rtl_433_tpu.bits.bitbuffer import BitBuffer as JBitBuffer
from rtl_433_tpu.decoders import Registry as JaxRegistry
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
import rtl_433_tpu_torch.decoders.declarative as tdecl
import rtl_433_tpu_torch.decoders.garage as tgarage
import rtl_433_tpu_torch.ops.decode_bank as tdbk
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.bits.bitbuffer import BitBuffer as TBitBuffer
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.dsp.engine import PKG_FSK
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse.data import PulseData

from test_declarative import SYM_VECTORS
from torch_decl_cases import fuzz_batch, oracle_candidates
from torch_fixture_cases import cases as fixture_cases
from torch_slice_cases import mixed_trains

RATE = 250_000


@pytest.fixture(scope="module")
def banks():
    return tdecl.get_runner().bank, jdecl.get_runner().bank


def _jax_run(bank, bits, n, sid, ns):
    c, r = jdbk.run(bank, jnp.asarray(bits), jnp.asarray(n),
                    jnp.asarray(sid), xp=jnp,
                    n_store=None if ns is None else jnp.asarray(ns))
    return np.asarray(c), np.asarray(r)


def _port_run(bank, bits, n, sid, ns):
    c, r = tdbk.run_torch(bank, *(torch.from_numpy(a) for a in (bits, n,
                                                                  sid)),
                          None if ns is None else torch.from_numpy(ns))
    assert c.dtype == r.dtype == torch.int32
    return c.numpy(), r.numpy().view(np.uint32)


def test_bank_tables_carry_the_jax_weights(banks):
    tb, jb = banks
    tabs = tdbk.bank_tables(tb, "cpu")
    assert tdbk.bank_tables(tb, torch.device("cpu")) is tabs
    for k in ("n_specs", "in_bits", "frame_bits", "pat_len", "n_checks",
              "n_raws"):
        assert getattr(tb, k) == getattr(jb, k), k
    assert (tb.n_specs, tb.in_bits, tb.frame_bits, tb.pat_len, tb.n_checks,
            tb.n_raws) == (77, 512, 376, 32, 2, 11)
    for k, v in vars(jb).items():
        if not isinstance(v, np.ndarray):
            continue
        got = tabs[k].numpy()
        if v.dtype == np.uint32:
            got = got.view(np.uint32)
        elif k in ("ck_mod", "ck_tca"):   # the JAX path casts to int32
            v = v.astype(np.int32)
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    # the kernel's spec rows
    sp = tabs["spec"].numpy()
    C, PW = jb.n_checks, (jb.pat_len + 31) // 32
    assert sp.shape == (77, tdbk.SP_CHECKS + tdbk.CK_FIELDS * C + 2 * PW)
    for col, arr in ((tdbk.SP_MIN, jb.min_bits), (tdbk.SP_MAX, jb.max_bits),
                     (tdbk.SP_PLEN, jb.plen), (tdbk.SP_ALIGN, jb.align_off),
                     (tdbk.SP_NEED, jb.need_bits), (tdbk.SP_TF, jb.transform),
                     (tdbk.SP_MC_MIN, jb.mc_min),
                     (tdbk.SP_PRE_START, jb.pre_start)):
        assert np.array_equal(sp[:, col], arr)
    assert np.array_equal(sp[:, tdbk.SP_EL:tdbk.SP_EL + 4], jb.exact_lens)
    assert np.array_equal(sp[:, tdbk.SP_LA_OFF:tdbk.SP_LA_OFF + 2], jb.la_off)
    for c in range(C):
        o = tdbk.SP_CHECKS + tdbk.CK_FIELDS * c
        assert np.array_equal(sp[:, o], jb.ck_kind[:, c])
        assert np.array_equal(sp[:, o + 1], jb.ck_neq[:, c])
        assert np.array_equal(sp[:, o + 2].view(np.uint32), jb.ck_tc[:, c])
        assert np.array_equal(sp[:, o + 3:o + 5],
                              np.stack([jb.ck_mod[:, c], jb.ck_tca[:, c]], 1))
    words = sp[:, -2 * PW:].view(np.uint32)
    bit = lambda w, j: (w[:, j // 32] >> np.uint32(31 - j % 32)) & 1
    for j in range(jb.pat_len):
        care = (jb.pmask[:, j] != 0) & (j < jb.plen)
        assert np.array_equal(bit(words[:, PW:], j), care)
        assert np.array_equal(bit(words[:, :PW], j), jb.pat[:, j] & care)
    live = jb.raw_w.any(2)
    for s in range(77):
        assert not live[s, sp[s, tdbk.SP_NRAW]:].any()
        assert sp[s, tdbk.SP_NRAW] == 0 or live[s, sp[s, tdbk.SP_NRAW] - 1]


def test_sparse_tables_rebuild_the_dense_weights(banks):
    """The kernel's sparse entry lists (``sparse_tables``) rebuild the JAX
    bank's dense ``ck_gf2``, ``ck_add`` and ``raw_w`` exactly: every
    non-zero weight once, in the chunk of its slot or row, kinds as the
    slot's; every chunk whole, a field row one chunk, the widest check
    four."""
    tb, jb = banks
    tabs = tdbk.bank_tables(tb, "cpu")
    ent, cdir, start = (tabs[k].numpy() for k in ("entries", "chunk_dir",
                                                  "chunk_start"))
    assert np.array_equal(ent, tdbk.sparse_tables(tb)[0])
    S, C, R, FB = jb.n_specs, jb.n_checks, jb.n_raws, jb.frame_bits
    assert ent.shape == (tdbk.CHUNK * len(cdir), 2)
    assert start[0] == 0 and start[-1] == len(cdir) and len(start) == S + 1
    gf2 = np.zeros((S, C, FB), np.uint32)
    add = np.zeros((S, C, FB), np.int32)
    raw = np.zeros((S, R, FB), np.uint32)
    chunks = {}
    for s in range(S):
        for ch in range(start[s], start[s + 1]):
            kind, target = cdir[ch] & 0xFF, cdir[ch] >> 8
            chunks[s, kind, target] = chunks.get((s, kind, target), 0) + 1
            e = ent[tdbk.CHUNK * ch:tdbk.CHUNK * (ch + 1)]
            j, w = e[:, 0], e[:, 1]
            assert ((j >= 0) & (j < FB)).all()
            assert (j[w == 0] == 0).all()               # (0, 0) padding
            j, w = j[w != 0], w[w != 0]
            assert len(np.unique(j)) == len(j)
            if kind == tdbk.CH_GF2:
                assert jb.ck_kind[s, target] == tdbk.CK_GF2
                assert not gf2[s, target, j].any()
                gf2[s, target, j] = w.view(np.uint32)
            elif kind == tdbk.CH_ADD:
                assert jb.ck_kind[s, target] == tdbk.CK_ADD
                assert not add[s, target, j].any()
                add[s, target, j] = w
            else:
                assert kind == tdbk.CH_RAW and target < R
                assert not raw[s, target, j].any()
                raw[s, target, j] = w.view(np.uint32)
    live = jb.ck_kind != tdbk.CK_OFF
    want_gf2 = np.where((jb.ck_kind == tdbk.CK_GF2)[..., None], jb.ck_gf2, 0)
    want_add = np.where((jb.ck_kind == tdbk.CK_ADD)[..., None], jb.ck_add, 0)
    assert np.array_equal(gf2, want_gf2) and np.array_equal(add, want_add)
    assert np.array_equal(raw, jb.raw_w)
    assert not jb.ck_gf2[~live].any() and not jb.ck_add[~live].any()
    per_row = max(n for (s, k, t), n in chunks.items() if k == tdbk.CH_RAW)
    per_check = max(n for (s, k, t), n in chunks.items()
                    if k != tdbk.CH_RAW)
    assert per_row == 1 and per_check == 4
    nz = [int((ent[tdbk.CHUNK * start[s]:tdbk.CHUNK * start[s + 1], 1]
               != 0).sum()) for s in range(S)]
    assert max(nz) == 216 and sum(nz) == int(
        (want_gf2 != 0).sum() + (want_add != 0).sum() + (raw != 0).sum())


def _sparse_run(bank, bits, n, sid, ns):
    c, r = tdbk.run_torch_sparse_plain(
        bank, *(torch.from_numpy(a) for a in (bits, n, sid)),
        None if ns is None else torch.from_numpy(ns))
    assert c.dtype == r.dtype == torch.int32
    return c.numpy(), r.numpy().view(np.uint32)


@pytest.mark.parametrize("stale", [True, False])
def test_sparse_emulation_matches_jax_jnp_on_the_fuzz_batch(banks, oracle,
                                                             stale):
    """The kernel's evaluation emulated in plain torch (frame words, a
    frame bit per entry from its word, one XOR or sum per chunk) equals
    JAX's ``run(xp=jnp)`` on the fuzz batch: stale stored bits, invert,
    Manchester, negative frame offsets, the 216-entry spec, every spec."""
    tb, jb = banks
    bits, n, sid, ns = fuzz_batch(6, 2048, oracle)
    # rows at a length whose alignment moves the frame before bit 0
    neg = [(s, int(ln)) for s in range(tb.n_specs)
           for ln, o in zip(tb.la_len[s], tb.la_off[s])
           if ln > 0 and o + tb.align_off[s] < 0 and tb.plen[s] == 0]
    assert neg
    rng = np.random.default_rng(6)
    k = 64
    s_neg, n_neg = (np.resize(np.asarray(c, np.int32), k)
                    for c in zip(*neg))
    b_neg = rng.integers(0, 2, (k, tb.in_bits)).astype(np.uint8)
    ns_neg = rng.integers(n_neg, tb.in_bits + 1).astype(np.int32)
    bits, n, sid, ns = (np.concatenate(a) for a in (
        (bits, b_neg), (n, n_neg), (sid, s_neg), (ns, ns_neg)))
    if not stale:
        bits = (bits * (np.arange(tb.in_bits)[None, :] < n[:, None])) \
            .astype(np.uint8)
        ns = None
    jc, jr = _jax_run(jb, bits, n, sid, ns)
    tc, tr = _sparse_run(tb, bits, n, sid, ns)
    assert np.array_equal(tc, jc) and np.array_equal(tr, jr)
    # the cases the kernel's word masks must get right are present
    tabs = tdbk.bank_tables(tb, "cpu")
    off = tdbk._stages(tb, tabs, torch.from_numpy(bits),
                       torch.from_numpy(n).long(),
                       torch.from_numpy(sid).long())[3].numpy()
    widest = np.argmax(np.diff(tabs["chunk_start"].numpy()))
    assert (off < 0).sum() >= k
    for m in (tb.transform[sid] == tdbk.TF_INVERT,
              tb.transform[sid] == tdbk.TF_MANCHESTER, sid == widest):
        assert m.any() and (tc[m] == 0).any()
    assert len(np.unique(sid)) == 77


def test_sparse_emulation_matches_jax_jnp_on_the_oracle(banks, oracle):
    """The oracle vectors' candidates, as the runner builds them, and the
    empty batch."""
    tb, jb = banks
    bits, n, sid, ns = oracle
    jc, jr = _jax_run(jb, bits, n, sid, ns)
    tc, tr = _sparse_run(tb, bits, n, sid, ns)
    assert np.array_equal(tc, jc) and np.array_equal(tr, jr)
    assert (tc == 0).sum() > 50
    e = np.zeros(0, np.int32)
    c, r = _sparse_run(tb, np.zeros((0, tb.in_bits), np.uint8), e, e, e)
    assert c.shape == (0,) and r.shape == (0, tb.n_raws)


def test_sparse_emulation_reads_rows_of_any_width(banks, oracle):
    """Rows of 500 stored bits (not a multiple of 32) with n and n_store
    past them (reads clamp to the last stored bit, as the JAX path's
    gather does), and spec ids out of range (ABORT_LENGTH, zero raws)."""
    tb, _jb = banks
    bits, n, sid, ns = fuzz_batch(4, 512, oracle)
    rng = np.random.default_rng(4)
    n = np.where(rng.random(512) < 0.2, rng.integers(500, 560, 512),
                 np.minimum(n, 500)).astype(np.int32)
    ns = np.maximum(ns, n).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (bits[:, :500], n, sid, ns)]
    want = tdbk.run_torch_plain(tb, *args[:3], args[3])
    got = tdbk.run_torch_sparse_plain(tb, *args[:3], args[3])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (n > 500).sum() > 50
    bad = torch.tensor([-1, 77, 3], dtype=torch.int32)
    c, r = tdbk.run_torch_sparse_plain(tb, args[0][:3], args[1][:3], bad,
                                       args[3][:3])
    assert c[:2].tolist() == [tdbk.DECODE_ABORT_LENGTH] * 2
    assert not r[:2].any()


@pytest.fixture(scope="module")
def oracle():
    return oracle_candidates()


def test_plain_bank_matches_jax_jnp_with_stale_bits(banks, oracle):
    """Rows stored past their length: extraction reads the stale bits
    below n_store, and they change results."""
    tb, jb = banks
    bits, n, sid, ns = fuzz_batch(1, 2048, oracle)
    assert (ns > n).sum() > 1000 and len(np.unique(sid)) == 77
    assert n.min() == 0 and n.max() == tb.in_bits
    jc, jr = _jax_run(jb, bits, n, sid, ns)
    tc, tr = _port_run(tb, bits, n, sid, ns)
    assert np.array_equal(tc, jc) and np.array_equal(tr, jr)

    # every stage is reached
    tf, kinds = tb.transform[sid], tb.ck_kind[sid]
    count = lambda m, c: int(((tc == c) & m).sum())
    for m in (tf == tdbk.TF_INVERT, (kinds == tdbk.CK_GF2).any(1),
              (kinds == tdbk.CK_ADD).any(1), tb.plen[sid] > 0):
        assert count(m, 0) and count(m, tdbk.DECODE_FAIL_MIC)
    mc = tf == tdbk.TF_MANCHESTER
    assert count(mc, 0) and count(mc, tdbk.DECODE_ABORT_EARLY)
    for code in (tdbk.DECODE_ABORT_LENGTH, tdbk.DECODE_ABORT_EARLY):
        assert count(tb.plen[sid] > 0, code)
    found, _pos = tdbk.preamble_plain(
        tb, tdbk.bank_tables(tb, "cpu"), torch.from_numpy(bits),
        torch.from_numpy(n).long(), torch.from_numpy(sid).long())
    has_pat = tb.plen[sid] > 0
    assert 0 < int(found.numpy()[has_pat].sum()) < int(has_pat.sum())

    # the same rows zeroed at their length: other results
    cut = bits * (np.arange(tb.in_bits)[None, :] < n[:, None])
    cc, cr = _port_run(tb, cut, n, sid, n)
    assert (cr != tr).any(1).sum() > 100


def test_plain_bank_matches_jax_jnp_without_n_store(banks, oracle):
    """``n_store`` defaults to ``n_bits`` (canonically zero-padded rows)."""
    tb, jb = banks
    bits, n, sid, _ns = fuzz_batch(2, 1024, oracle)
    bits = bits * (np.arange(tb.in_bits)[None, :] < n[:, None])
    bits = bits.astype(np.uint8)
    jc, jr = _jax_run(jb, bits, n, sid, None)
    tc, tr = _port_run(tb, bits, n, sid, None)
    assert np.array_equal(tc, jc) and np.array_equal(tr, jr)
    assert (tc == 0).sum() > 50
    # and the NumPy backend agrees
    nc, nr = tdbk.run(tb, bits, n, sid)
    assert np.array_equal(nc, tc) and np.array_equal(nr, tr)


def test_empty_batch(banks):
    tb, _jb = banks
    e = np.zeros(0, np.int32)
    c, r = _port_run(tb, np.zeros((0, tb.in_bits), np.uint8), e, e, e)
    assert c.shape == (0,) and r.shape == (0, tb.n_raws)


def _result(ret, fallback, to_json):
    if ret is fallback:
        return "FALLBACK"
    if isinstance(ret, list):
        return [to_json(e) for e in ret]
    return ret


def test_decode_many_on_the_cpu_matches_jax_jnp():
    """The vectors of tests/test_declarative.py, one batch through JAX's
    ``decode_many(xp=jnp)`` and the port's ``decode_many(device="cpu")``
    and host backend: the same events, codes and FALLBACKs."""
    syms = sorted(SYM_VECTORS)
    jitems = [(s, JBitBuffer.parse(c)) for s in syms
              for c in SYM_VECTORS[s][1]]
    titems = [(s, TBitBuffer.parse(c)) for s in syms
              for c in SYM_VECTORS[s][1]]
    want = [_result(r, jdecl.FALLBACK, jax_event_to_json)
            for r in jdecl.get_runner().decode_many(jitems, xp=jnp)]
    runner = tdecl.get_runner()
    got = [_result(r, tdecl.FALLBACK, event_to_json)
           for r in runner.decode_many(titems, device="cpu")]
    host = [_result(r, tdecl.FALLBACK, event_to_json)
            for r in runner.decode_many(titems)]
    assert got == want == host
    assert sum(isinstance(r, list) and bool(r) for r in got) > 70
    fb = {s for (s, _b), r in zip(titems, got) if r == "FALLBACK"}
    assert "fineoffset_WH0530" in fb


class _Frozen:
    @staticmethod
    def monotonic():
        return 0.0


def _registry(cls, device_slice):
    reg = cls()
    reg.register_all()
    reg.device_slice = device_slice
    if device_slice and cls is Registry:
        reg.slice_device = "cpu"
    return reg


def _drain(reg, trains):
    """One prewarmed drain: events per train, stats, decode cache."""
    reg.prewarm_trains(trains, RATE)
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
    cache = {k: [repr(list(e.fields)) for e in v] if isinstance(v, list)
             else v for k, v in reg._dec_cache.items()}
    return out, stats, cache


def _captured_trains(name):
    """(want_fsk, pulse, gap) of the packages the port's detector
    publishes for a 250k capture, on the CPU."""
    cu8 = next(c for n, _nums, c in fixture_cases() if n == name)
    rx = RtlTpu(report_time="off", device="cpu")
    got = []

    def grab(self, pkg, block_len):
        got.append((pkg["type"] == PKG_FSK, pkg["pulse"].tolist(),
                    pkg["gap"].tolist()))
        return 0

    rx._handle_package = grab.__get__(rx)
    rx.decode_file(cu8)
    return got


def test_device_slicing_runs_the_drain_batch_on_the_torch_bank(monkeypatch):
    """One drain: the packages of captures of six declarative decoders
    (OOK and FSK) and the slice-case streams of every family."""
    monkeypatch.setattr(jgarage, "time", _Frozen)
    monkeypatch.setattr(tgarage, "time", _Frozen)
    devs = [d for d in Registry().slots if d is not None and d.decode_fn]
    trains = [t for name in ("nexus", "lacrosse_tx35", "prologue", "waveman",
                             "rubicson", "chuango")
              for t in _captured_trains(name)]
    trains += [(i % 3 == 2, p, g)
               for i, (p, g) in enumerate(mixed_trains(devs, 8, n=18))]
    calls = []
    real = tdbk.run_torch

    def spy(bank, bits, *a, **k):
        calls.append((bits.device.type, bits.shape[0]))
        return real(bank, bits, *a, **k)

    monkeypatch.setattr(tdbk, "run_torch", spy)
    got = _drain(_registry(Registry, True), trains)
    assert len(calls) == 1 and calls[0][0] == "cpu" and calls[0][1] > 0
    want = _drain(_registry(JaxRegistry, True), trains)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert sum(map(len, got[0])) > 0
    assert any(isinstance(v, list) and v for v in got[2].values())


def test_cuda_refused_without_gpu(banks):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for machines without")
    items = [("infactory", TBitBuffer.parse("{40}0f80665761"))]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdecl.get_runner().decode_many(items, device="cuda")
    tb, _jb = banks
    b = np.zeros((2, tb.in_bits), np.uint8)
    z = np.zeros(2, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdbk.run_on("cuda", tb, b, z, z, z)
    with pytest.raises(ValueError, match="int32"):
        tdbk.run_torch(tb, torch.from_numpy(b), torch.zeros(2),
                       torch.from_numpy(z))
    launches = dict(_cuda.LAUNCHES)
    tdbk.run_torch(tb, torch.from_numpy(b), torch.from_numpy(z),
                   torch.from_numpy(z))
    assert _cuda.LAUNCHES == launches

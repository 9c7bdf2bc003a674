"""The port's default decode dispatch against the JAX package's.

``Registry._run`` takes ``_run_fast`` in both packages: one call of the
host slicer library slices a package against every timing spec, gates
(decoders/gates.py, decoders/mic_gates.py), deduplicates and caches the
decode calls, and runs the declarative decoders as one batch
(decoders/declarative.py over ops/decode_bank.py). Here, on the CPU:

- the port's ``SlicerBank`` gives the JAX bank's summary and record bytes,
  on the synthetic packages of tests/test_native_slicers.py and on packages
  of real captures at 250k and 1024k, against the OOK and the FSK side of
  the default registration;
- the port's ``_run_fast`` gives the JAX ``_run_fast``'s events, in order,
  its return counts and every device's counters; and the port's
  ``_run_host``'s events and success counters;
- ``GATES``, ``MANUAL_GATES`` and ``MIC_GATES`` equal the JAX tables;
- ``DeclRunner.decode_many`` gives the JAX runner's result, item for item
  (``FALLBACK`` counts as a result), on every oracle vector of every
  declarative symbol and its mutations, one symbol at a time and all in one
  batch; the lowered banks hold equal tables;
- ``decode_bank.run`` equals the JAX ``run(xp=np)`` on a seeded batch;
- a slicer library that does not build raises from ``_run``, with the
  compiler's output, and the host path is not taken.
"""

import functools
import json
import os

import numpy as np
import pytest

import rtl_433_tpu.decoders as jdec
import rtl_433_tpu.decoders.declarative as jdecl
import rtl_433_tpu.decoders.gates as jgates
import rtl_433_tpu.decoders.mic_gates as jmic
import rtl_433_tpu.ops.decode_bank as jdbk
from rtl_433_tpu.bits.bitbuffer import BitBuffer as JBitBuffer
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu.pulse import native_slicers as jns
from rtl_433_tpu.pulse.data import PulseData as JPulseData

import rtl_433_tpu_torch.decoders as tdec
import rtl_433_tpu_torch.decoders.declarative as tdecl
import rtl_433_tpu_torch.decoders.gates as tgates
import rtl_433_tpu_torch.decoders.mic_gates as tmic
import rtl_433_tpu_torch.ops.decode_bank as tdbk
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.bits.bitbuffer import BitBuffer as TBitBuffer
from rtl_433_tpu_torch.ops import _native
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse import native_slicers as tns
from rtl_433_tpu_torch.pulse.data import PulseData as TPulseData
from test_decoder_oracle import VECTORS
from torch_fixture_cases import cases

pytestmark = pytest.mark.skipif(not jns.available(),
                                reason="the JAX package's native slicer "
                                       "library is unavailable")

# real captures: (fixture, what it exercises)
REAL = ["nexus",           # 250k OOK PPM
        "lacrosse_tx35",   # 250k FSK PCM
        "oregon_scientific",  # 250k OOK Manchester
        "ert_scm",         # 1024k OOK Manchester
        "tpms_toyota",     # 1024k FSK
        "lacrosse_tx29"]   # 1024k FSK


def _synthetic(seed=0):
    """tests/test_native_slicers.py's ``_packages``: (pulse, gap, rate)."""
    rng = np.random.default_rng(seed)
    pkgs = []
    # PPM-ish repeated burst with per-segment resets
    P, G = [], []
    for rep in range(6):
        for _ in range(36):
            P.append(125)
            G.append(250 if rng.integers(2) == 0 else 500)
        G[-1] = 1200
    pkgs.append((P, G, 250_000))
    # PWM-ish
    P = [int(rng.choice([120, 350])) for _ in range(60)]
    G = [150] * 60
    G[-1] = 30000
    pkgs.append((P, G, 250_000))
    # FSK PCM uniform
    pkgs.append(([52] * 80, [52] * 79 + [60000], 1_024_000))
    # random garbage (small, keeps the host oracle fast)
    for _ in range(4):
        n = int(rng.integers(5, 60))
        pkgs.append((rng.integers(5, 3000, n).tolist(),
                     rng.integers(5, 6000, n).tolist(), 250_000))
    # degenerate
    pkgs.append(([10], [10], 250_000))
    return pkgs


@functools.lru_cache(maxsize=None)
def _real(name):
    """The packages the port's detector publishes for a capture, under the
    default registration, as (pulse, gap, rate)."""
    cu8 = next(c for n, _nums, c in cases() if n == name)
    rx = RtlTpu(report_time="off", device="cpu")
    got = []

    def grab(self, pkg, block_len):
        got.append((pkg["pulse"].tolist(), pkg["gap"].tolist(),
                    self.sample_rate))
        return 0

    rx._handle_package = grab.__get__(rx)
    rx.decode_file(cu8)
    assert got, f"{name}: no packages"
    return got


def _package_ids():
    ids = [f"synthetic{i}" for i in range(len(_synthetic()))]
    return ids + [f"{n}" for n in REAL]


def _packages_of(pid, seed=0):
    if pid.startswith("synthetic"):
        return [_synthetic(seed)[int(pid[9:])]]
    return _real(pid)


def _registries():
    j, t = jdec.Registry(), tdec.Registry()
    j.register_all()
    t.register_all()
    return j, t


@pytest.mark.parametrize("pid", _package_ids())
def test_slicer_bank_matches_jax(pid):
    """Summary rows and the bytes of every record, both sides."""
    j, t = _registries()
    for P, G, rate in _packages_of(pid):
        p = np.asarray(P, np.int32)
        g = np.asarray(G, np.int32)
        for want_fsk in (False, True):
            jb = jns.SlicerBank([d for d in j.active
                                 if d.is_fsk == want_fsk], rate)
            tb = tns.SlicerBank([d for d in t.active
                                 if d.is_fsk == want_fsk], rate)
            assert np.array_equal(tb.specs, jb.specs)
            js, _ = jb.slice(p, g)
            ts, _ = tb.slice(p, g)
            assert np.array_equal(ts, js)
            for row in ts:
                off = int(row[1])
                assert tb.record_bytes(off) == jb.record_bytes(off)
                tbits = tns.materialize_bytes(tb.record_bytes(off))
                jbits = jns.materialize_bytes(jb.record_bytes(off))
                assert tbits.num_rows == jbits.num_rows
                assert np.array_equal(tbits.bb, jbits.bb)
                assert list(tbits.bits_per_row) == list(jbits.bits_per_row)


def _counters(reg):
    return [(d.num, d.decode_events, d.decode_ok, d.decode_messages,
             dict(d.decode_fails)) for d in reg.active]


def _dispatch(reg, run, pd_cls, to_json, packages):
    out = []
    for P, G, rate in packages:
        pd = pd_cls(pulse=P, gap=G, sample_rate=rate)
        for want_fsk in (False, True):
            evs = []
            n = getattr(reg, run)(pd, want_fsk,
                                  lambda d, e: evs.append((d.num, to_json(e))))
            out.append((n, evs))
    return out


@pytest.mark.parametrize("pid", _package_ids())
def test_run_fast_matches_jax_run_fast(pid):
    """Events, order, return counts and every device's counters; each
    package is dispatched twice, so the second pass replays the train memo
    and the decode cache."""
    j, t = _registries()
    pk = _packages_of(pid, seed=3) * 2
    want = _dispatch(j, "_run_fast", JPulseData, jax_event_to_json, pk)
    got = _dispatch(t, "_run_fast", TPulseData, event_to_json, pk)
    assert got == want
    assert _counters(t) == _counters(j)


@pytest.mark.parametrize("pid", _package_ids())
def test_run_fast_matches_run_host(pid):
    """The port's two paths: events, order, decode_ok, decode_messages."""
    _j, fast = _registries()
    host = tdec.Registry()
    host.register_all()
    pk = _packages_of(pid, seed=3)
    got = _dispatch(fast, "_run_fast", TPulseData, event_to_json, pk)
    want = _dispatch(host, "_run_host", TPulseData, event_to_json, pk)
    assert got == want
    ok = [(d.num, d.decode_ok, d.decode_messages) for d in fast.active]
    assert ok == [(d.num, d.decode_ok, d.decode_messages)
                  for d in host.active]


def test_real_captures_decode_on_the_fast_path():
    """At least the expected devices decode their own captures' packages
    (a guard that the real packages above are not all empty)."""
    _j, t = _registries()
    names = set()
    for name in ("nexus", "lacrosse_tx35", "tpms_toyota"):
        for P, G, rate in _real(name):
            pd = TPulseData(pulse=P, gap=G, sample_rate=rate)
            for want_fsk in (False, True):
                t._run_fast(pd, want_fsk, lambda d, e: names.add(d.symbol))
    assert len(names) >= 3, names


def test_gate_tables_equal_jax():
    assert tgates.GATES == jgates.GATES
    assert tgates.MANUAL_GATES == jgates.MANUAL_GATES
    assert tmic.MIC_GATES == jmic.MIC_GATES


def test_decl_tables_equal_jax():
    """The same symbols in the same order, and equal lowered weight
    tables in the process-wide runners."""
    assert list(tdecl.DECL) == list(jdecl.DECL)
    tb, jb = tdecl.get_runner().bank, jdecl.get_runner().bank
    assert vars(tb).keys() == vars(jb).keys()
    for k, v in vars(jb).items():
        w = vars(tb)[k]
        if isinstance(v, np.ndarray):
            assert w.dtype == v.dtype and np.array_equal(w, v), k
        else:
            assert w == v, k


def _sym_codes():
    reg = jdec.Registry()
    by_num = {}
    for num, code, _min in VECTORS:
        if isinstance(num, int):
            by_num.setdefault(num, []).append(code)
    return {d.symbol: by_num[d.num] for d in reg.slots
            if d is not None and d.symbol in jdecl.DECL and d.num in by_num}


SYM_CODES = _sym_codes()


def _cases(codes, bb_cls):
    """Each vector, 200 seeded bit-flip mutations of it and four
    truncations of its first row (tests/test_declarative.py's set)."""
    rng = np.random.default_rng(1234)
    out = []
    for code in codes:
        out.append(bb_cls.parse(code))
        for _ in range(200):
            m = bb_cls.parse(code)
            k = int(rng.integers(1, 4))
            for _ in range(k):
                r = int(rng.integers(0, max(m.num_rows, 1)))
                n = int(m.bits_per_row[r])
                if n == 0:
                    continue
                j = int(rng.integers(0, n))
                m.bb[r + j // (m.bb.shape[1] * 8),
                     (j // 8) % m.bb.shape[1]] ^= 0x80 >> (j & 7)
            out.append(m)
        for cut in (1, 2, 5, 17):
            m = bb_cls.parse(code)
            if m.num_rows and m.bits_per_row[0] > cut:
                m.bits_per_row[0] -= cut
                out.append(m)
    return out


def _result(ret, fallback, to_json):
    if ret is fallback:
        return "FALLBACK"
    if isinstance(ret, list):
        return [to_json(e) for e in ret]
    return ret


@pytest.mark.parametrize("symbol", sorted(SYM_CODES))
def test_decl_runner_matches_jax(symbol):
    codes = SYM_CODES[symbol]
    jr = jdecl.DeclRunner([jdecl.DECL[symbol]])
    tr = tdecl.DeclRunner([tdecl.DECL[symbol]])
    jc, tc = _cases(codes, JBitBuffer), _cases(codes, TBitBuffer)
    want = [_result(r, jdecl.FALLBACK, jax_event_to_json)
            for r in jr.decode_many([(symbol, b) for b in jc])]
    got = [_result(r, tdecl.FALLBACK, event_to_json)
           for r in tr.decode_many([(symbol, b) for b in tc])]
    assert got == want
    # the vectors themselves decode (or fall back) alike one by one too
    for code in codes:
        w = jr.decode_many([(symbol, JBitBuffer.parse(code))])[0]
        g = tr.decode_many([(symbol, TBitBuffer.parse(code))])[0]
        assert _result(g, tdecl.FALLBACK, event_to_json) == \
            _result(w, jdecl.FALLBACK, jax_event_to_json)


def test_full_runner_batch_matches_jax():
    """Every symbol's vectors and first mutations in one decode_many call
    of the process-wide runners."""
    jitems, titems = [], []
    for symbol, codes in sorted(SYM_CODES.items()):
        jc, tc = _cases(codes, JBitBuffer), _cases(codes, TBitBuffer)
        jitems += [(symbol, b) for b in jc[:12]]
        titems += [(symbol, b) for b in tc[:12]]
    want = [_result(r, jdecl.FALLBACK, jax_event_to_json)
            for r in jdecl.get_runner().decode_many(jitems)]
    got = [_result(r, tdecl.FALLBACK, event_to_json)
           for r in tdecl.get_runner().decode_many(titems)]
    assert got == want
    assert any(isinstance(r, list) for r in got)


def test_decode_bank_run_matches_jax():
    tbank = tdecl.get_runner().bank
    jbank = jdecl.get_runner().bank
    rng = np.random.default_rng(7)
    B = 256
    bits = rng.integers(0, 2, (B, tbank.in_bits)).astype(np.uint8)
    n = rng.integers(8, tbank.in_bits + 1, B).astype(np.int32)
    ns = np.minimum(n + rng.integers(0, 64, B), tbank.in_bits).astype(
        np.int32)
    for b in range(B):
        bits[b, ns[b]:] = 0
    sid = rng.integers(0, tbank.n_specs, B).astype(np.int32)
    for n_store in (None, ns):
        tc, tr = tdbk.run(tbank, bits, n, sid, n_store=n_store)
        jc, jr = jdbk.run(jbank, bits, n, sid, xp=np, n_store=n_store)
        assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
        assert tr.dtype == jr.dtype and np.array_equal(tr, jr)
    assert (tc == 0).any() or (tc != tc[0]).any()


def test_failed_slicer_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: ``_run`` raises with the compiler's
    output and never runs the host path."""
    bad = tmp_path / "slicers.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_native, "SOURCE", str(bad))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tns, "_lib", None)
    reg = tdec.Registry()
    reg.register_all()
    monkeypatch.setattr(reg, "_run_host", lambda *a: pytest.fail("host"))
    pd = TPulseData(pulse=[125] * 40, gap=[250] * 39 + [5000],
                    sample_rate=250_000)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed") as err:
        reg.run_ook_demods(pd, lambda d, e: None)
    assert "error" in str(err.value)
    assert not os.listdir(tmp_path / "_build")


def test_stats_report_counts_frames(tmp_path):
    """One fixture, -R 19: frames and the device's row; flush resets."""
    cu8 = next(c for n, _nums, c in cases() if n == "nexus")
    rx = RtlTpu(register_all=False, report_time="off", device="cpu")
    rx.registry.register(19)
    evs = rx.decode_file(cu8)
    rep = json.loads(event_to_json(rx.stats_report(1)))
    assert rep["enabled"] == 1
    assert rep["frames"]["count"] >= 1
    assert rep["frames"]["events"] >= 1
    (row,) = rep["stats"]
    assert row["device"] == 19 and row["ok"] >= 1
    assert row["messages"] == len(evs)
    rx.flush_report_data()
    rep = json.loads(event_to_json(rx.stats_report(1)))
    assert rep["frames"] == {"count": 0, "squelched": 0, "events": 0}
    assert rep["stats"] == []

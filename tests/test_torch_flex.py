"""The port's conf files (``-c``) and flex decoders (``-X``) against the
JAX package's.

Every ``conf/*.conf`` parses to the same argv in both packages. Every flex
spec of those files builds a device with equal timings, fields and
parameters in both, and rows made from a numpy seed to fit the spec's own
constraints (bit counts, rows, repeats, a planted preamble or match) give
equal ``decode_test_string`` JSON. Pulse trains synthesized from each
spec's timings (tests/modulate.py) give equal events through the port's
default path (``_run_fast``), its per-decoder host path (``_run_host``),
its device slicing (plain versions on the CPU) and the JAX package's
default path. The port's ``DecodePool`` takes flex specs, where the JAX
pool's worker imports a ``flex_device`` that ``decoders/flex.py`` does not
define.
"""

import glob
import json
import os

import numpy as np
import pytest

from rtl_433_tpu import confparse as jconf
from rtl_433_tpu.api import RtlTpu as JaxRtlTpu
from rtl_433_tpu.decoders import Registry as JaxRegistry
from rtl_433_tpu.decoders import flex as jflex
from rtl_433_tpu.output.data_model import event_to_json as jax_event_to_json
from rtl_433_tpu.pulse.data import PulseData as JaxPulseData
from rtl_433_tpu_torch import confparse as tconf
from rtl_433_tpu_torch.api import RtlTpu
from rtl_433_tpu_torch.bits.bitbuffer import BitBuffer
from rtl_433_tpu_torch.decoders import Registry
from rtl_433_tpu_torch.decoders import flex as tflex
from rtl_433_tpu_torch.decoders.pool import DecodePool
from rtl_433_tpu_torch.output.data_model import event_to_json
from rtl_433_tpu_torch.pulse.data import PulseData
from modulate import modulate

SEED = 20261018
RATE = 250_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "*.conf")))


def _specs():
    out = []
    for path in CONFS:
        argv = tconf.parse_conf_file(path)
        out += [(os.path.basename(path), k, argv[i + 1])
                for k, i in enumerate(j for j, a in enumerate(argv)
                                      if a == "-X")]
    return out


SPECS = _specs()
SPEC_IDS = [f"{name}-{k}" for name, k, _ in SPECS]
# tests/test_e2e.py::test_flex_y_parity's spec and code
E2E_SPEC = ("n=test,m=OOK_PWM,s=100,l=200,r=300,bits>=4,"
            "get=@0:{4}:first,get=@4:{4}:second:[10:ten 11:eleven]")
E2E_CODE = "{16}ab42"


@pytest.mark.parametrize("path", CONFS, ids=[os.path.basename(p)
                                             for p in CONFS])
def test_conf_file_parses_as_in_jax(path):
    assert tconf.parse_conf_file(path) == jconf.parse_conf_file(path)


def test_conf_brace_blocks_and_keywords_as_in_jax():
    """tests/test_io_extras.py's brace-block texts, the keyword table, the
    default search paths and the unknown-keyword error."""
    texts = ["""
decoder {
    name=X,
    m=OOK_PWM,
    get=@0:{8}:id,
    bits=13,
}
frequency 433.92M
""", "decoder n=Y,m=OOK_PPM,get=seq:@56:{8}\n",
             "frequency 433.92M  # trailing\nsample_rate 250k\n"
             "protocol 19\noutput json\nreport_meta stats\n"]
    for text in texts:
        assert tconf.parse_conf_text(text) == jconf.parse_conf_text(text)
        assert tconf.parse_conf_entries(text) == \
            jconf.parse_conf_entries(text)
    assert tconf.parse_conf_text(texts[0])[:2] == [
        "-X", jconf.parse_conf_text(texts[0])[1]]
    assert tconf.CONF_KEYWORDS == jconf.CONF_KEYWORDS
    assert tconf.DEFAULT_CONF_PATHS == jconf.DEFAULT_CONF_PATHS
    for mod in (tconf, jconf):
        with pytest.raises(ValueError, match="unknown conf keyword"):
            mod.parse_conf_text("bogus_keyword 1")


def test_every_conf_spec_is_counted():
    assert len(SPECS) >= 60


_DEV_FIELDS = ("num", "symbol", "name", "modulation", "short_width",
               "long_width", "sync_width", "gap_limit", "reset_limit",
               "tolerance", "priority", "fields", "is_fsk")


def _params(mod, spec):
    kw, params = mod.parse_spec(spec)
    d = dict(vars(params))
    d["getters"] = [vars(g) for g in params.getters]
    return kw, d


def _rows(spec, rng, n_codes=8):
    """``n_codes`` test codes that fit the spec: each is one or more
    "{n}hex" rows with a bit count inside the spec's bounds, repeated as
    its repeats ask, with its preamble or match planted in half of them."""
    _kw, params = tflex.parse_spec(spec)
    # long enough for every getter, where the bounds allow
    need = max((g.bit_offset + g.bit_count for g in params.getters),
               default=1)
    lo = max(params.min_bits, min(need, params.max_bits or need), 1)
    hi = params.max_bits or lo + 24
    pattern = params.preamble or params.match
    codes = []
    for k in range(n_codes):
        n = int(rng.integers(lo, max(hi, lo) + 1))
        bits = rng.integers(0, 2, n)
        if pattern and k % 2 == 0:
            pat, plen = pattern
            pbits = [(pat[i >> 3] >> (7 - (i & 7))) & 1 for i in range(plen)]
            at = int(rng.integers(0, max(n - plen, 0) + 1))
            bits = np.concatenate([bits[:at], pbits, bits[at:]])[
                :max(n, at + plen)]
            n = len(bits)
        padded = np.concatenate([bits, np.zeros(-n % 4, int)])
        hexs = "".join(f"{int(''.join(map(str, padded[i:i + 4])), 2):x}"
                       for i in range(0, len(padded), 4)) or "0"
        row = f"{{{n}}}{hexs}"
        reps = max(params.min_repeats, params.min_rows, 1) + int(
            rng.integers(0, 2))
        if params.max_rows:
            reps = min(reps, params.max_rows)
        codes.append(" ".join([row] * reps))
    return codes


def _decode_strings(cls, to_json, spec, codes, **kw):
    """Each code's events as JSON, or the name of the error it raised."""
    rx = cls(register_all=False, **kw)
    rx.registry.add_device((tflex if cls is RtlTpu else jflex)
                           .flex_create_device(spec))
    out = []
    for c in codes:
        try:
            out.append([to_json(e) for e in rx.decode_test_string(c)])
        except IndexError as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("conf,k,spec", SPECS, ids=SPEC_IDS)
def test_flex_spec_builds_and_decodes_as_in_jax(conf, k, spec):
    t, j = tflex.flex_create_device(spec), jflex.flex_create_device(spec)
    for f in _DEV_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert _params(tflex, spec) == _params(jflex, spec)
    codes = _rows(spec, np.random.default_rng([SEED, len(spec), k]))
    got = _decode_strings(RtlTpu, event_to_json, spec, codes, device="cpu")
    want = _decode_strings(JaxRtlTpu, jax_event_to_json, spec, codes)
    assert got == want


def test_e2e_spec_decodes_as_in_jax():
    got = _decode_strings(RtlTpu, event_to_json, E2E_SPEC, [E2E_CODE],
                          device="cpu")
    want = _decode_strings(JaxRtlTpu, jax_event_to_json, E2E_SPEC,
                           [E2E_CODE])
    assert got == want and len(got[0]) == 1
    ev = json.loads(got[0][0])
    assert ev["model"] == "test" and ev["rows"][0]["second"] == "eleven"


def test_flex_spec_errors_as_in_jax():
    for bad in ("m=OOK_PWM,s=1", "n=x,s=1", "n=x,m=NOPE", "n=x,m=OOK_PWM,zz=1",
                "n=x,m=OOK_PWM,get=@0:{8}"):
        for mod in (tflex, jflex):
            with pytest.raises(ValueError):
                mod.flex_create_device(bad)


def _train(spec, k):
    """A pulse train (samples at RATE) that the spec's own slicer reads
    back into seeded rows fitting the spec, or None where the modulation's
    rows cannot be expressed in its timings."""
    dev = tflex.flex_create_device(spec)
    rng = np.random.default_rng([SEED, k])
    # a spec with no gap window and no sync cannot separate rows: its rows
    # go one at a time
    tries = [c for code in _rows(spec, rng, n_codes=4)
             for c in (code, code.split()[0])]
    for code in tries:
        train = modulate(BitBuffer.parse(code), dev)
        if train:
            break
    else:
        return None
    pulse = [max(1, int(round(p * RATE / 1e6))) for p, _g in train]
    gap = [max(1, int(round(g * RATE / 1e6))) for _p, g in train]
    return dev.is_fsk, pulse, gap


def _pd(cls, pulse, gap, fsk):
    pd = cls(pulse=list(pulse), gap=list(gap), sample_rate=RATE,
             ook_low_estimate=40, ook_high_estimate=4000)
    if fsk:
        pd.fsk_f1_est, pd.fsk_f2_est = 8000, -8000
    return pd


def _run(reg, pd, fsk, to_json):
    """The package's events as JSON, or the name of the error raised (a
    getter past a short row's end raises in both packages)."""
    out = []
    cb = lambda dev, ev: out.append(to_json(ev))
    try:
        (reg.run_fsk_demods if fsk else reg.run_ook_demods)(pd, cb)
    except IndexError as e:
        return type(e).__name__
    return out


@pytest.mark.parametrize("conf,k,spec", SPECS, ids=SPEC_IDS)
def test_flex_trains_decode_on_every_path_as_in_jax(conf, k, spec):
    """The port's fast path, host path and device slicing (plain versions)
    against the JAX package's default path, on a train from the spec's
    own timings."""
    got = _train(spec, k)
    if got is None:
        pytest.skip(f"{spec.split(',')[1]}: rows not expressible")
    fsk, pulse, gap = got
    jreg = JaxRegistry()
    jreg.add_device(jflex.flex_create_device(spec))
    want = _run(jreg, _pd(JaxPulseData, pulse, gap, fsk), fsk,
                jax_event_to_json)
    paths = {}
    for path in ("fast", "host", "device_slice"):
        reg = Registry()
        reg.add_device(tflex.flex_create_device(spec))
        if path == "host":
            reg._use_native = lambda: False
        if path == "device_slice":
            reg.device_slice, reg.slice_device = True, "cpu"
            reg.prewarm_trains([(fsk, np.array(pulse, np.int32),
                                 np.array(gap, np.int32))], RATE)
            assert reg._train_cache
        calls = {"_run_fast": 0, "_run_host": 0}
        for name in calls:
            real = getattr(reg, name)

            def counted(*a, real=real, name=name):
                calls[name] += 1
                return real(*a)
            setattr(reg, name, counted)
        paths[path] = _run(reg, _pd(PulseData, pulse, gap, fsk), fsk,
                           event_to_json)
        took = "_run_host" if path == "host" else "_run_fast"
        assert calls[took] == 1 and sum(calls.values()) == 1, (path, calls)
    assert paths == {p: want for p in paths}


def test_most_conf_trains_decode():
    """The synthesized trains are real inputs: most specs' trains give
    events, and every modulation of the conf files is synthesized."""
    got, mods = 0, set()
    for conf, k, spec in SPECS:
        tr = _train(spec, k)
        if tr is None:
            continue
        mods.add(tflex.flex_create_device(spec).modulation)
        reg = Registry()
        reg.add_device(tflex.flex_create_device(spec))
        got += bool(_run(reg, _pd(PulseData, tr[1], tr[2], tr[0]), tr[0],
                         event_to_json))
    assert got >= 3 * len(SPECS) // 4, got
    assert mods == {tflex.flex_create_device(s).modulation
                    for _c, _k, s in SPECS}


def _nexus_pd(cls, id_, temp):
    from synth import ppm_pulses
    v = ((id_ << 28) | (1 << 27) | (1 << 24) | ((temp & 0xFFF) << 12)
         | (0xF << 8) | 45)
    # a reset gap past r=5000 us, so that no empty row ends the package
    train = ppm_pulses(format(v, "036b"), pulse_us=500, gap_zero_us=1000,
                       gap_one_us=2000, reset_us=6000, repeats=4)
    pd = cls(sample_rate=RATE, ook_low_estimate=10, ook_high_estimate=8000)
    pd.pulse = [p // 4 for p, _g in train]
    pd.gap = [g // 4 for _p, g in train]
    return pd


NEXUS_FLEX = ("n=nexus_flex,m=OOK_PPM,s=1000,l=2000,g=3000,r=5000,bits=36,"
              "get=@0:{8}:id,get=@12:{12}:temp")


@pytest.mark.parametrize("n_workers", [1, 2])
def test_pool_takes_flex_specs(n_workers):
    """The port's DecodePool with a flex spec: the same events in the same
    order as its inline registry (protocols first, then the flex device,
    the worker's order), attached to the parent's flex device."""
    reg = Registry()
    reg.register(19)
    reg.add_device(tflex.flex_create_device(NEXUS_FLEX))
    jobs = [(ch, _nexus_pd(PulseData, 0x20 + ch, 150 + 9 * i))
            for i, ch in enumerate([2, 0, 1, 2])]
    inline = []
    for ch, pd in jobs:
        reg.run_ook_demods(
            pd, lambda dev, ev, c=ch: inline.append((c, dev.symbol,
                                                     event_to_json(ev))))
    with DecodePool(reg, n_workers=n_workers, register_nums=[(19, None)],
                    flex_specs=[NEXUS_FLEX]) as pool:
        for ch, pd in jobs:
            pool.submit(ch, False, pd)
        res = pool.drain()
    got = [(c, dev.symbol, event_to_json(ev)) for c, dev, ev in res]
    assert got == inline
    assert {s for _c, s, _e in got} == {"flex_nexus_flex"}
    assert all(dev is reg.active[1] for _c, dev, _e in res)


def test_jax_pool_names_a_missing_flex_device():
    """The JAX pool's worker imports ``flex_device`` (its pool.py:56), which
    its flex module does not define, so any flex spec kills the worker;
    the port's worker calls ``flex_create_device``."""
    assert not hasattr(jflex, "flex_device")
    assert hasattr(jflex, "flex_create_device")
    with pytest.raises(ImportError):
        exec("from rtl_433_tpu.decoders.flex import flex_device", {})
    import inspect
    from rtl_433_tpu.decoders import pool as jpool
    from rtl_433_tpu_torch.decoders import pool as tpool
    assert "flex_device(spec)" in inspect.getsource(jpool._worker_main)
    assert "flex_create_device(spec)" in inspect.getsource(
        tpool._worker_main)

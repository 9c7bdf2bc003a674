"""Package compaction: the port's plain version against the JAX engine's.

``rtl_433_tpu_torch.ops.compact.compact_packages_plain`` and
``dsp.engine.packages_from_compact`` against ``rtl_433_tpu.dsp.engine``'s
``compact_packages`` and ``packages_from_compact`` on seeded states from
C=1 to C=64: ``out_n`` beyond the slot count, totals under and over
``cap``, meta values above 2^24 and negative (package starts of earlier
blocks). All five outputs and every package dict must be equal. Pulse and
gap widths stay below 2^24 there, where the JAX engine's f32 one-hot
product is exact; at 2^24 and above only the port stays exact (ROADMAP
Queue 3). The CUDA kernel is held to the plain version in
tests/test_torch_cuda.py and chip_smoke.py; here the wrapper's layout of
the kernel's one buffer (``buffer_ints``, ``views_of``) is held to the
plain version's outputs.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.ops.compact import (MAX_TILES, ONE_CTA, _width,
                                           buffer_ints, compact_packages,
                                           compact_packages_plain, views_of)

from synth import fsk_pcm_bits, pwm_pulses, synth_fsk, synth_ook
from torch_parity import pad_block

KEYS = ("pulse", "gap", "meta", "channel", "count")


def _state(C, S, P, seed, n_hi):
    """Random published slots; ``out_n`` over 0..n_hi (n_hi > S overflows
    the slots), meta over the whole int32 range with M_NUM <= P."""
    rng = np.random.default_rng(seed)
    meta = rng.integers(-(1 << 31), (1 << 31) - 1, (C, S, 9),
                        dtype=np.int64).astype(np.int32)
    meta[..., je.M_NUM] = rng.integers(0, P + 1, (C, S))
    return {
        "out_n": rng.integers(0, n_hi + 1, C).astype(np.int32),
        "out_p": rng.integers(0, 1 << 24, (C, S, P)).astype(np.int32),
        "out_g": rng.integers(0, 1 << 24, (C, S, P)).astype(np.int32),
        "out_meta": meta,
    }


def _both(st, cap):
    j = je.compact_packages({k: jnp.asarray(v) for k, v in st.items()}, cap)
    t = compact_packages_plain(*(torch.from_numpy(st[k]) for k in
                                 ("out_n", "out_p", "out_g", "out_meta")),
                               cap)
    return j, t


def _same_packages(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


# (C, S, P, cap, seed, largest out_n): one channel, out_n beyond S, totals
# under and over cap, the engine's widths (S=8, P=1200)
STATES = [(1, 4, 32, 4, 1, 9), (1, 8, 1200, 2, 2, 12), (8, 4, 64, 64, 3, 6),
          (17, 8, 40, 16, 4, 12), (33, 8, 12, 7, 5, 10),
          (64, 8, 100, 300, 6, 12)]


@pytest.mark.parametrize("C,S,P,cap,seed,n_hi", STATES)
def test_plain_matches_jax(C, S, P, cap, seed, n_hi):
    st = _state(C, S, P, seed, n_hi)
    j, t = _both(st, cap)
    assert sorted(t) == sorted(KEYS + ("rows",))
    for k in KEYS:
        assert t[k].dtype == torch.int32, k
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k
    assert (np.abs(st["out_meta"]) >= 1 << 24).any()
    jp, jc = je.packages_from_compact(j)
    tp, tc = te.packages_from_compact(t)
    assert jc == tc == int(np.minimum(st["out_n"], S).sum())
    _same_packages(jp, tp)


def test_totals_on_both_sides_of_cap():
    """The seeded states above cover a total under cap and one over."""
    totals = [(int(np.minimum(_state(C, S, P, s, n)["out_n"], S).sum()), cap)
              for C, S, P, cap, s, n in STATES]
    assert any(t < cap for t, cap in totals)
    assert any(t > cap for t, cap in totals)


def test_widths_from_2_24_up_stay_exact():
    """A pulse of 2^24 + 1 samples (a carrier of 67 s at 250 kS/s) comes
    out exact; the JAX engine's f32 product rounds it."""
    st = _state(3, 4, 16, 7, 4)
    st["out_n"][:] = 4
    st["out_p"][1, 2, 5] = (1 << 24) + 1
    st["out_g"][2, 0, 0] = (1 << 30) + 3
    j, t = _both(st, 12)
    assert int(t["pulse"][6, 5]) == (1 << 24) + 1
    assert int(t["gap"][8, 0]) == (1 << 30) + 3
    assert int(np.asarray(j["pulse"])[6, 5]) != (1 << 24) + 1


def test_engine_state_compacts_to_take_packages():
    """A real block: every package that take_packages reads, in its order,
    from the compact rows, and equal to the JAX engine's compaction of the
    same block."""
    sig = np.concatenate([
        synth_ook(pwm_pulses("110010101001", short_us=264, long_us=744,
                             gap_short_us=744, gap_long_us=264,
                             reset_us=12000, repeats=3),
                  rate=250_000, lead_in_us=20_000, tail_us=60_000),
        synth_fsk(fsk_pcm_bits("1100101011110000" * 4, bit_us=100),
                  rate=250_000, lead_in_us=16_000, tail_us=60_000, seed=7)])
    iq, n = pad_block(np.stack([sig, sig[::-1].copy(), sig]))
    params = te.DetectorParams(pkg_cap=4)
    st = te.detector_init(params, 3, "cpu")
    st, _ = te.process_block(params, st, torch.from_numpy(iq), n, flush=True)
    want, _ = te.take_packages(st)
    assert len(want) >= 4
    comp = te.compact_packages(st, 64)
    got, count = te.packages_from_compact(comp)
    assert count == len(want)
    _same_packages(want, got)
    jcomp = je.compact_packages({k: jnp.asarray(v.numpy())
                                 for k, v in st.items()}, 64)
    for k in KEYS:
        assert np.array_equal(np.asarray(jcomp[k]), comp[k].numpy()), k


def test_cpu_tensors_take_the_plain_version():
    st = {k: torch.from_numpy(v) for k, v in _state(4, 8, 16, 9, 9).items()}
    before = dict(_cuda.LAUNCHES)
    got = compact_packages(st["out_n"], st["out_p"], st["out_g"],
                           st["out_meta"], 5)
    want = compact_packages_plain(st["out_n"], st["out_p"], st["out_g"],
                                  st["out_meta"], 5)
    assert _cuda.LAUNCHES == before
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_rows_hold_the_four_outputs():
    """pulse, gap, meta and channel are views of one buffer, ``rows``, that
    the host reads in one copy: each row is pulse, gap, meta, the channel,
    then zeros to a 16-byte stride."""
    st = {k: torch.from_numpy(v) for k, v in _state(5, 8, 10, 11, 9).items()}
    t = compact_packages_plain(st["out_n"], st["out_p"], st["out_g"],
                               st["out_meta"], 30)
    rows = t["rows"]
    assert rows.shape == (30, 32) and rows.dtype == torch.int32
    for k in ("pulse", "gap", "meta", "channel"):
        assert t[k].data_ptr() >= rows.data_ptr()
        assert t[k].untyped_storage().data_ptr() == \
            rows.untyped_storage().data_ptr(), k
    assert torch.equal(rows[:, 29], t["channel"])
    assert not rows[:, 30:].any()
    n = int(t["count"])
    assert 0 < n < 30 and (t["channel"][n:] == -1).all()


@pytest.mark.parametrize("bad", ["cap", "dtype", "shape"])
def test_bad_inputs_raise(bad):
    st = {k: torch.from_numpy(v) for k, v in _state(2, 4, 8, 1, 4).items()}
    cap = 0 if bad == "cap" else 3
    if bad == "dtype":
        st["out_p"] = st["out_p"].to(torch.int64)
    if bad == "shape":
        st["out_meta"] = st["out_meta"][:1]
    with pytest.raises(ValueError):
        compact_packages(st["out_n"], st["out_p"], st["out_g"],
                         st["out_meta"], cap)


def _kernel_buffer(st, cap):
    """The plain version's outputs, written into one buffer as the kernel
    lays it out (``buffer_ints``: rows, the count, then any scratch, here
    filled with junk), and the plain version's dict."""
    ins = [torch.from_numpy(st[k]) for k in ("out_n", "out_p", "out_g",
                                             "out_meta")]
    want = compact_packages_plain(*ins, cap)
    C, _, P = ins[1].shape
    F = ins[3].shape[2]
    buf = torch.full((buffer_ints(C, P, F, cap),), 7, dtype=torch.int32)
    n = want["rows"].numel()
    buf[:n] = want["rows"].reshape(-1)
    buf[n] = want["count"]
    return buf, want, P, F


@pytest.mark.parametrize("C,S,P,cap,seed,n_hi",
                         STATES + [(ONE_CTA + 3, 1, 4, 9, 8, 2)])
def test_kernel_buffer_views_match_plain(C, S, P, cap, seed, n_hi):
    """The wrapper's views of the kernel's one buffer give the plain
    version's six outputs: the same keys, values, shapes and strides, all
    views of the buffer, rows its first cap * W ints and the count the
    next one; past ONE_CTA channels the buffer also holds the tile sums'
    scratch."""
    buf, want, P, F = _kernel_buffer(_state(C, S, P, seed, n_hi), cap)
    W = _width(P, F)
    assert buf.numel() == cap * W + 1 + (MAX_TILES if C > ONE_CTA else 0)
    got = views_of(buf, cap, P, F)
    assert list(got) == list(want) and len(got) == 6
    for k in got:
        assert got[k].dtype == torch.int32, k
        assert got[k].shape == want[k].shape, k
        assert got[k].stride() == want[k].stride(), k
        assert torch.equal(got[k], want[k]), k
        assert got[k].untyped_storage().data_ptr() == buf.data_ptr(), k
    assert got["rows"].data_ptr() == buf.data_ptr()
    assert got["count"].data_ptr() == buf.data_ptr() + 4 * cap * W
    tp, tc = te.packages_from_compact(got)
    wp, wc = te.packages_from_compact(want)
    assert tc == wc
    _same_packages(tp, wp)


def test_kernel_constants_match_the_source():
    """ONE_CTA and MAX_TILES are the kernel's kOneCta and kMaxTiles, which
    size the scratch the wrapper leaves."""
    with open(os.path.join(_cuda.CSRC, "compact.cu")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kOneCta"]) == ONE_CTA
    assert int(consts["kMaxTiles"]) == MAX_TILES

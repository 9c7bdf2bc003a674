"""The port's device-slicing scans (ops/slice.py) against the JAX
package's, on the CPU.

For each of the nine families, the same trains (made from a seed with
numpy, tests/torch_slice_cases.py) and the same specs go through the JAX
``slice_<family>`` and the port's plain version: the bound columns are
equal, and so is every output plane (bytes, bits_per_row, syncs,
num_rows, n_events, ovf) on every lane, flagged lanes included, at the
caps DeviceBank uses and at caps small enough to flag most lanes. The
parity contract (ops/slice.py) needs only ``ovf`` and ``n_events`` on
flagged lanes; the plain version holds all planes there too, and so
does the kernel on the card (tests/test_torch_cuda.py). Unflagged lanes
also equal the port's host slicers (pulse/slicers.py), as in the JAX
package's tests/test_device_slice.py. PCM trains with widths on a bit
period's half raise the float-boundary flag on the same lanes in both.
"""

import numpy as np
import pytest
import torch

import rtl_433_tpu.ops.slice as jslice
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.ops import slice as tslice
from rtl_433_tpu_torch.pulse import slicers
from rtl_433_tpu_torch.pulse.data import PulseData

from torch_slice_cases import (BANK_CAPS, RATE, SMALL_CAPS, family_devices,
                               family_trains, pack)

FAMS = list(tslice.FAMILIES)
HOST = {"ppm": slicers.slicer_ppm, "pwm": slicers.slicer_pwm,
        "pcm": slicers.slicer_pcm, "mc": slicers.slicer_manchester_zerobit,
        "dmc": slicers.slicer_dmc, "piwm_dc": slicers.slicer_piwm_dc,
        "nrzs": slicers.slicer_nrzs, "rzi": slicers.slicer_rzi,
        "osv1": slicers.slicer_osv1}


def _run_both(fam, caps, seed=5, n=24):
    devs = family_devices(fam)
    trains = family_trains(fam, devs, seed, n=n)
    pulse, gap, npl = pack(trains)
    jb = getattr(jslice, f"{fam}_bounds")(devs, RATE)
    want = getattr(jslice, f"slice_{fam}")(pulse, gap, npl, jb,
                                           jslice.SliceCaps(*caps))
    want = {k: np.asarray(v) for k, v in want.items()}
    tb = getattr(tslice, f"{fam}_bounds")(devs, RATE)
    got = getattr(tslice, f"slice_{fam}")(
        torch.from_numpy(pulse), torch.from_numpy(gap),
        torch.from_numpy(npl), tb, caps)
    return devs, trains, want, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("fam", FAMS)
def test_bounds_match_jax(fam):
    """Every spec of the family in the registry, at 250k and 1024k."""
    devs = family_devices(fam, k=1000)
    assert devs
    for rate in (250_000, 1_024_000):
        want = getattr(jslice, f"{fam}_bounds")(devs, rate)
        got = getattr(tslice, f"{fam}_bounds")(devs, rate)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (fam, k)


@pytest.mark.parametrize("caps", ["bank", "small"])
@pytest.mark.parametrize("fam", FAMS)
def test_plain_matches_jax(fam, caps):
    caps = BANK_CAPS[fam] if caps == "bank" else SMALL_CAPS
    _devs, _trains, want, got = _run_both(fam, caps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), (fam, caps, k)
    flagged = int(want["ovf"].sum())
    if caps == SMALL_CAPS:
        assert flagged > want["ovf"].size // 3, flagged
    else:
        assert (want["n_events"][~want["ovf"]] > 0).sum() >= 5


@pytest.mark.parametrize("fam", FAMS)
def test_unflagged_lanes_match_host_slicers(fam):
    # roomy caps (as tests/test_device_slice.py gives the run-emitting
    # families), and more trains for the one-spec families
    n = 24 if len(family_devices(fam)) > 1 else 64
    devs, trains, _want, out = _run_both(fam, tslice.SliceCaps(16, 24, 40),
                                         seed=9, n=n)
    checked = events = 0
    for b, (p, g) in enumerate(trains):
        pd = PulseData(sample_rate=RATE)
        pd.pulse, pd.gap = list(p), list(g)
        for s, dev in enumerate(devs):
            if out["ovf"][b, s]:
                continue
            want = HOST[fam](pd, dev)
            assert int(out["n_events"][b, s]) == len(want), (b, dev.symbol)
            for e, bb in enumerate(want):
                nr = bb.num_rows
                assert int(out["num_rows"][b, s, e]) == nr
                for r in range(nr):
                    wb = int(bb.bits_per_row[r])
                    assert int(out["bits_per_row"][b, s, e, r]) == wb
                    assert int(out["syncs"][b, s, e, r]) == \
                        int(bb.syncs_before_row[r])
                    nby = (wb + 7) // 8
                    assert out["bytes"][b, s, e, r, :nby].tolist() == \
                        bb.bb[r][:nby].tolist()
                events += 1
            checked += 1
    assert checked >= 18 and events >= 10, (checked, events)


def test_pcm_boundary_trains_raise_the_float_flag():
    """Trains at k + 1/2 bit periods (every fourth PCM train) flag lanes
    for the float boundary alone, on the same lanes as JAX."""
    caps = tslice.SliceCaps(16, 64, 64)
    devs, trains, want, got = _run_both("pcm", caps, seed=11, n=32)
    assert np.array_equal(got["ovf"], want["ovf"])
    boundary = np.arange(len(trains)) % 4 == 3
    # no train comes near these caps: every flag is a float-boundary flag
    assert got["ovf"][boundary].sum() > 0


@pytest.mark.parametrize("fam", ["ppm", "pcm", "dmc", "osv1"])
def test_padding_past_the_longest_train_changes_nothing(fam):
    devs = family_devices(fam)
    trains = family_trains(fam, devs, 13, n=8)
    bounds = getattr(tslice, f"{fam}_bounds")(devs, RATE)
    outs = []
    for n_min in (1, 200):
        pulse, gap, npl = pack(trains, n_min=n_min)
        pulse[:, npl.max():] = 7      # padding is never read
        outs.append(getattr(tslice, f"slice_{fam}")(
            torch.from_numpy(pulse), torch.from_numpy(gap),
            torch.from_numpy(npl), bounds, BANK_CAPS[fam]))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_empty_trains_and_cpu_wrappers_launch_nothing():
    before = dict(_cuda.LAUNCHES)
    devs = family_devices("pwm")
    bounds = tslice.pwm_bounds(devs, RATE)
    z = torch.zeros((3, 4), dtype=torch.int32)
    out = tslice.slice_pwm(z, z, torch.zeros(3, dtype=torch.int32), bounds)
    assert out["bytes"].shape == (3, len(devs), 4, 16, 20)
    assert not out["ovf"].any() and not out["n_events"].any()
    assert _cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="int32"):
        tslice.slice_pwm(z.to(torch.int64), z, torch.zeros(3), bounds)


def test_bound_table_layout():
    """The kernel's table: the family's columns from 0, ok last, float
    columns as their bits."""
    devs = family_devices("pcm")
    bounds = tslice.pcm_bounds(devs, RATE)
    tab = tslice.bound_table("pcm", bounds)
    names = tslice.FAMILIES["pcm"][1]
    assert tab.shape == (len(devs), tslice.NCOLS)
    assert np.array_equal(tab[:, -1], bounds["ok"].astype(np.int32))
    f0s = names.index("f0s")
    assert np.array_equal(tab[:, f0s].view(np.float32), bounds["f0s"])
    assert np.array_equal(tab[:, 0], bounds["short"])
    ids = sorted(v[0] for v in tslice.FAMILIES.values())
    assert ids == list(range(9))
    assert all(len(v[1]) <= tslice.NCOLS and v[1][-1] == "ok"
               for v in tslice.FAMILIES.values())


@pytest.mark.parametrize("fam", FAMS)
def test_table_columns_invert_bound_table(fam):
    """A packed table (as the bank keeps it on the card) gives back the
    bound columns, every dtype included."""
    devs = family_devices(fam, k=1000)
    bounds = getattr(tslice, f"{fam}_bounds")(devs, RATE)
    back = tslice.table_columns(
        fam, torch.from_numpy(tslice.bound_table(fam, bounds)))
    assert sorted(back) == sorted(bounds)
    for k in bounds:
        assert back[k].dtype == bounds[k].dtype, k
        assert np.array_equal(back[k], bounds[k]), k


# ---- the kernel's launch plan (computed here, passed to csrc/slice.cu)

_CAPS_IN_USE = sorted(set(BANK_CAPS.values()) | {
    SMALL_CAPS, tslice.SliceCaps(16, 24, 40), tslice.SliceCaps(16, 64, 64)})


@pytest.mark.parametrize("N", [64, 2048, 8192])
@pytest.mark.parametrize("caps", _CAPS_IN_USE, ids=str)
def test_launch_plan_fits_every_cap_set_in_use(caps, N):
    """The bank's caps, the tests' caps, the drain's longest bucket (2048
    pulses) and the long-train case (8192): blocks of 64 lanes, or 32
    where S <= 32 or 64 would not fit, inside the 227 KB a block may use;
    each lane's stage an odd multiple of 16 bytes that holds its staged
    events' rows (padded to words) and counts."""
    E, R, BY = caps
    for B in (1, 64, 256, 4096):
        for S in (1, 29, 32, 33, 125, 1000):
            lanes, every, sb, smem = tslice.launch_plan(B, S, N, caps)
            assert lanes in (32, 64) and lanes % 32 == 0
            if S <= 32:
                assert lanes == 32
            es = E if every else 1
            assert sb == tslice.stage_bytes(caps, es) and sb % 32 == 16
            assert sb >= es * (R * (-(-BY // 4) * 4) + 8 * R + 4)
            assert smem == -(-8 * N // 16) * 16 + min(S, lanes) * sb
            assert smem <= tslice.SMEM_MAX


@pytest.mark.parametrize("B,S,caps,every", [
    (256, 125, (4, 16, 40), False),   # the drain's large PCM call
    (64, 29, (4, 16, 40), True),      # its small one
    (64, 26, (8, 24, 20), True),
    (256, 12, (8, 24, 20), True),
    (4096, 125, (4, 16, 20), False),
    (24, 12, (16, 64, 64), False)])   # 16 events of 64 x 64: too large
def test_launch_plan_stages_every_event_where_the_grid_fits_at_once(
        B, S, caps, every):
    """Every event staged exactly where the blocks (one train x up to 64
    specs each) then fit on the card's 132 SMs at once, by shared memory;
    else one event, the denser plan."""
    caps = tslice.SliceCaps(*caps)
    lanes, got, sb, smem = tslice.launch_plan(B, S, 64, caps)
    assert got == every
    blocks = B * -(-S // lanes)
    if every:
        assert blocks <= 132 * (tslice.SMEM_SM // (smem + 1024))
    else:
        for ln in (32, 64):
            sm = -(-8 * 64 // 16) * 16 + min(S, ln) * tslice.stage_bytes(
                caps, caps.events)
            assert sm > tslice.SMEM_MAX or B * -(-S // ln) > \
                132 * (tslice.SMEM_SM // (sm + 1024))


@pytest.mark.parametrize("caps,N", [((4, 64, 1024), 64), ((4, 16, 40), 30000)])
def test_launch_plan_raises_where_32_lanes_do_not_fit(caps, N):
    with pytest.raises(ValueError, match="shared memory"):
        tslice.launch_plan(8, 100, N, tslice.SliceCaps(*caps))

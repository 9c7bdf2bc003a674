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

from torch_slice_cases import (BANK_CAPS, DMC_SYMS, PIWM_DC_SYMS, RATE,
                               SMALL_CAPS, cap_trains, dmc_edges,
                               family_devices, family_trains, length_trains,
                               mc_edge_devs, mc_edges, nrzs_cap_trains,
                               nrzs_edge_bounds, nrzs_edges, osv1_edges, pack,
                               pcm_cap_trains, pcm_edge_bounds, pcm_edges,
                               piwm_dc_edges, ppm_cap_trains,
                               ppm_edge_bounds, ppm_edges, pulse_cap_trains,
                               pulse_edge_bounds, pwm_edge_dev, pwm_edges,
                               rzi_edges, symbol_cap_trains,
                               symbol_edge_bounds)

FAMS = list(tslice.FAMILIES)
HOST = {"ppm": slicers.slicer_ppm, "pwm": slicers.slicer_pwm,
        "pcm": slicers.slicer_pcm, "mc": slicers.slicer_manchester_zerobit,
        "dmc": slicers.slicer_dmc, "piwm_dc": slicers.slicer_piwm_dc,
        "nrzs": slicers.slicer_nrzs, "rzi": slicers.slicer_rzi,
        "osv1": slicers.slicer_osv1}


def _run_both(fam, caps, seed=5, n=24, trains=None, devs=None, bounds=None):
    """JAX's scan and the port's wrapper on the same trains; the bound
    columns from ``devs`` (each package's own ``<fam>_bounds``), or
    ``bounds`` given to both."""
    devs = devs or family_devices(fam)
    trains = trains or family_trains(fam, devs, seed, n=n)
    pulse, gap, npl = pack(trains)
    jb = bounds or getattr(jslice, f"{fam}_bounds")(devs, RATE)
    want = getattr(jslice, f"slice_{fam}")(pulse, gap, npl, jb,
                                           jslice.SliceCaps(*caps))
    want = {k: np.asarray(v) for k, v in want.items()}
    tb = bounds or getattr(tslice, f"{fam}_bounds")(devs, RATE)
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


def _same(want, got, what):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), (what, k)


# ---- the phase form of PPM, MC and PWM (csrc/slice.cu's groups) on
# planted trains; the planted spec is lane 0 of every train

@pytest.mark.parametrize("caps", ["bank", "small"])
def test_ppm_edge_trains_match_jax(caps):
    """Syncs before any bit and at bir 0 after a new row, a row break at
    row 0 with no bits (it touches the event), flush candidates on an
    untouched event, a flush on the last pulse, gaps on every window edge
    and at the reset limit, gaps that are a bit or a sync and a flush
    candidate at once (zero_u, sync_u > reset), every cap passed, and all
    of them in one train; on the planted specs (lanes 0-2) and the
    registry's."""
    caps = BANK_CAPS["ppm"] if caps == "bank" else SMALL_CAPS
    trains = ppm_edges() + ppm_cap_trains(caps)
    _d, _t, want, got = _run_both("ppm", caps, trains=trains,
                                  bounds=ppm_edge_bounds())
    _same(want, got, "ppm edges")
    E, R, BY = caps
    # two syncs on row 0 before any bit, two on row 1 after the bits
    assert want["syncs"][0, 0, 0, :2].tolist() == [2, 2]
    assert want["num_rows"][0, 0, 0] == 2
    # a row break alone touches: event 0 flushes two empty rows
    assert want["num_rows"][1, 0, 0] == 2
    assert want["bits_per_row"][1, 0, 0, :2].tolist() == [0, 0]
    # the untouched candidates do not flush; the sync between two of them
    # stays on event 0, and the one before the last, untouched, candidate
    # lands on event 1, which never flushes
    assert want["n_events"][2, 0] == 1
    assert want["syncs"][2, 0, :2, 0].tolist() == [1, 1]
    # the last pulse flushes after a bit, a row break and a sync after bits
    assert want["n_events"][3:6, 0].tolist() == [1, 1, 1]
    assert want["num_rows"][4:6, 0, 0].tolist() == [2, 2]
    assert want["n_events"][6, 0] == 0
    # a 0 at or over the reset limit emits, then flushes (spec 1)
    assert want["n_events"][8, 1] == 6
    assert want["ovf"][-3:, 0].all()
    assert want["n_events"][-3, 0] > E
    assert want["num_rows"][-2, 0].max() > R
    assert want["bits_per_row"][-1, 0].max() > 8 * BY


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_ppm_edge_trains_match_jax_over_tile_borders(caps):
    """The edge trains from every offset of a tile of 32 gaps (each train
    behind 0 to 31 gaps of a flushed event), so that each case also falls
    on a tile's first and last thread."""
    caps = BANK_CAPS["ppm"] if caps == "bank" else SMALL_CAPS
    z, over = (50, 100), (50, 500)
    trains = []
    for k, (p, g) in enumerate(ppm_edges()[:-1] * 4):
        lead = k % 32
        trains.append(([z[0]] * lead + [over[0]] + p,
                       [z[1]] * lead + [over[1]] + g))
    _d, _t, want, got = _run_both("ppm", caps, trains=trains,
                                  bounds=ppm_edge_bounds())
    _same(want, got, "ppm edges over tile borders")
    assert (want["n_events"][:, 0] >= 1).all()


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_pwm_edge_trains_match_jax(caps):
    """A flush candidate with nothing touched since the previous one,
    syncs at bir 0, break candidates at bir3 0, spurious pulses between
    bits, and all of them in one train over two tiles."""
    caps = BANK_CAPS["pwm"] if caps == "bank" else SMALL_CAPS
    dev = pwm_edge_dev()
    _d, _t, want, got = _run_both("pwm", caps, trains=pwm_edges(dev),
                                  devs=[dev] + family_devices("pwm"))
    _same(want, got, "pwm edges")
    # the untouched candidate did not flush; the syncs at bir 0 stacked
    assert want["n_events"][0, 0] == 2
    assert want["syncs"][1, 0].max() == 2
    assert want["n_events"][4, 0] == 6


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_mc_edge_trains_match_jax(caps):
    """Every pulse out, ending on a flush at the last pulse; a tsl chain
    across a whole train with no reset that needs no state (with and
    without a tolerance); one pulse; widths that are not tame."""
    caps = BANK_CAPS["mc"] if caps == "bank" else SMALL_CAPS
    dev, dev0 = mc_edge_devs()
    b = tslice.mc_bounds([dev, dev0], RATE)
    trains = mc_edges(dev, dev0)
    for (p, g), s in ((trains[1], 0), (trains[2], 1)):
        sh, tol = int(b["short"][s]), int(b["tol"][s])
        assert all((sh - tol <= w or not b["has_tol"][s]) and 2 * w <= 3 * sh
                   for w in p + g[:-1])
    _d, _t, want, got = _run_both("mc", caps, trains=trains,
                                  devs=[dev, dev0] + family_devices("mc"))
    _same(want, got, "mc edges")
    assert (want["n_events"][:, 0] >= 1).all()
    # the chains emit mid-bit 1s and 0s along the whole train
    assert want["bits_per_row"][1, 0, 0, 0] >= min(100, 8 * caps.row_bytes)
    assert want["bits_per_row"][2, 1, 0, 0] >= min(40, 8 * caps.row_bytes)


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_dmc_edge_trains_match_jax(caps):
    """In_short runs of 31, 32, 33 and 64 symbols across tile borders (the
    pending parity carried in), a pending symbol at exactly d_short ==
    tol, a pending mistimed reset falling through to a 0 and to a flush,
    breaks after one bit and after many, flush candidates with nothing
    since the previous one; on the planted spec (lane 0) and the
    registry's."""
    caps = BANK_CAPS["dmc"] if caps == "bank" else SMALL_CAPS
    _d, _t, want, got = _run_both("dmc", caps, trains=dmc_edges(),
                                  bounds=symbol_edge_bounds("dmc"))
    _same(want, got, "dmc edges")
    # a run of odd length leaves a 1 pending: the mistimed L after it
    # breaks the row; an even run lets L be a 0 (one row either way, and
    # a second from the M after the next 1)
    for i, n in enumerate(n for n in (31, 32, 33, 64) for _o in range(3)):
        assert want["num_rows"][i, 0, 0] == (3 if n % 2 else 2), (i, n)
    if caps == BANK_CAPS["dmc"]:
        # X consumed where pending, nothing where not: 1 1 0 1 0 0
        assert want["bits_per_row"][12, 0, 0, 0] == 6
        assert want["bytes"][12, 0, 0, 0, 0] == 0b11010000
        # F0 pending falls through to a 0, RF pending to a flush
        assert want["n_events"][13, 0] == 2
        assert want["bytes"][13, 0, 0, 0, 0] == 0b10010000
        # the untouched flush candidates do not flush
        assert want["n_events"][15, 0] == 2


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_piwm_dc_edge_trains_match_jax(caps):
    """The last symbol a break that also flushes, a bit over the reset
    limit, a non-bit at exactly the reset limit, breaks with and without
    bits since the previous candidate, flush candidates with nothing
    since the previous one; on the planted specs (lanes 0 and 1) and the
    registry's."""
    caps = BANK_CAPS["piwm_dc"] if caps == "bank" else SMALL_CAPS
    _d, _t, want, got = _run_both("piwm_dc", caps, trains=piwm_dc_edges(),
                                  bounds=symbol_edge_bounds("piwm_dc"))
    _same(want, got, "piwm_dc edges")
    # the last symbol breaks, then flushes the event with the row it opened
    assert want["n_events"][0, 0] == 1 and want["num_rows"][0, 0, 0] == 2
    assert want["bits_per_row"][0, 0, 0].tolist()[:2] == [3, 0]
    # OVER is a flush candidate on spec 0, a 0 that flushes on spec 1
    assert want["n_events"][1, 0] == 3 and want["n_events"][1, 1] == 4
    assert want["bits_per_row"][1, 1, 0, 0] == 2
    # EQ does nothing: four bits, a break, and the last symbol, a 0 here,
    # emits and flushes
    assert want["n_events"][2, 0] == 1
    assert want["num_rows"][2, 0, 0] == 2
    assert want["bits_per_row"][2, 0, 0, :2].tolist() == [4, 1]


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_rzi_edge_trains_match_jax(caps):
    """Runs that span several words, share their edge words and pass the
    row's bits; a flush that emits nothing (a reset gap before any 1); a
    pulse that opens a message (no base offset) beside one that does not;
    a negative num (spec 1); an event of zeros; events past E; and each
    of them behind 1 to 31 pulses of a flushed event, so that every case
    also falls on a tile's first and last thread."""
    caps = BANK_CAPS["rzi"] if caps == "bank" else SMALL_CAPS
    edges = rzi_edges()
    trains = edges + pulse_cap_trains("rzi", caps)
    for k, (p, g) in enumerate(edges[:-1] * 7):
        lead = 1 + k % 31
        trains.append(([150] * lead + p, [200] * (lead - 1) + [1500] + g))
    _d, _t, want, got = _run_both("rzi", caps, trains=trains,
                                  bounds=pulse_edge_bounds("rzi"))
    _same(want, got, "rzi edges")
    E, R, BY = caps
    # the wide runs pass the row's bits in one event
    assert want["n_events"][0, 0] == 1 and want["ovf"][0, 0]
    assert want["bits_per_row"][0, 0, 0, 0] == 376
    # two empty candidates emit nothing; 2 ones and a 0, then an empty
    # candidate at the last pulse
    assert want["n_events"][1, 0] == 1
    assert want["bits_per_row"][1, 0, :2, 0].tolist() == [3, 0]
    # a 60-wide pulse is a 1 where it opens a message, else nothing
    assert want["n_events"][2, 0] == 3
    assert want["bits_per_row"][2, 0, :, 0].tolist() == [2, 2, 3, 0][:E]
    # spec 1's base offset makes num negative: no ones
    assert want["bits_per_row"][3, :2, 0, 0].tolist() == [17, 9]
    # zeros alone make an event
    assert want["n_events"][4, 0] == 1
    assert want["bits_per_row"][4, 0, 0, 0] == 3
    if caps == BANK_CAPS["rzi"]:
        # 33 ones, a 0, then the next run from bit 34
        assert want["bytes"][0, 0, 0, 0, :5].tolist() == [255] * 4 + [191]
        assert want["bytes"][2, 0, :3, 0, 0].tolist() == [128, 128, 192]
        assert not want["bytes"][4, 0].any()
    # the lead's event, then the case's own, on every offset
    assert (want["n_events"][len(edges) + 3:, 0] >= 2).all()


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_osv1_edge_trains_match_jax(caps):
    """Preambles of 11, 12 and 13 pulses; pulse 11 with its gap at hmax
    (no break there); a corrupt preamble; a sync whose gap is not the
    longer; a failed sync; a flush at the last pulse and at a reset gap; a
    train that ends on its sync; more than 8 * BY bits, with two and with
    over a hundred ones clipped into the row's last byte (phase 0 crosses
    the tile of 8 pulses on every train)."""
    caps = BANK_CAPS["osv1"] if caps == "bank" else SMALL_CAPS
    trains = osv1_edges() + pulse_cap_trains("osv1", caps)
    _d, _t, want, got = _run_both("osv1", caps, trains=trains,
                                  bounds=pulse_edge_bounds("osv1"))
    _same(want, got, "osv1 edges")
    E, R, BY = caps
    # only the 12-pulse preamble leads to a sync that passes
    assert want["n_events"][:10, 0].tolist() == [0, 1, 0, 0, 0, 1, 0, 1, 1,
                                                  0]
    assert want["bits_per_row"][6, 0, 0, 0] == 0
    # the sync alone: its 0
    assert want["bits_per_row"][9, 0, 0, 0] == 1
    # no 0 from the sync: the first data pulse is a 1 at bit 0
    assert want["bytes"][5, 0, 0, 0, 0] >= 128
    # bit 2k a 1 up to bit 2n - 2: 323 and 449 bits
    assert want["bits_per_row"][10:12, 0, 0, 0].tolist() == [323, 449]
    assert want["ovf"][10:, 0].all() if caps == BANK_CAPS["osv1"] \
        else want["ovf"][[1, 5, 7, 10, 11, 12], 0].all()
    assert (want["n_events"][10:, 0] == 1).all()
    if caps == BANK_CAPS["osv1"]:
        # 0b10101010 and the clipped ones: 2, then 65
        assert want["bytes"][10:12, 0, 0, 0, BY - 1].tolist() == [172, 235]


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_pcm_edge_trains_match_jax(caps):
    """NRZ preambles with three accepted runs, two of them inside one tile
    of 32 pulses, each at a width only the rate before accepted puts in the
    run class, and a fourth for the lane seeded at 1/40; an accepted run
    across a tile's edge; RZ runs of equal length, the later accepted too;
    a clear in a later tile erasing an event begun in the tile before; a
    clear after a flush in one tile; a clear that is a flush candidate too;
    a row break at the last pulse; runs of ones over word edges and past
    the row's bits; and trains past each cap; on the planted specs (lanes
    0-3) and the registry's."""
    caps = BANK_CAPS["pcm"] if caps == "bank" else SMALL_CAPS
    edges = pcm_edges()
    _d, _t, want, got = _run_both("pcm", caps,
                                  trains=edges + pcm_cap_trains(caps),
                                  bounds=pcm_edge_bounds())
    _same(want, got, "pcm edges")
    E, R, BY = caps
    K = len(edges)
    # one event a train on the NRZ specs; the RZ clears leave three
    assert (want["n_events"][:3, 1:4] == 1).all()
    assert want["n_events"][3:7, 0].tolist() == [1, 3, 1, 1]
    # the cap trains are flagged for their cap alone
    assert want["ovf"][K:, 0].all()
    assert want["n_events"][K, 0] > E
    assert want["num_rows"][K + 1, 0].max() > R
    assert want["bits_per_row"][K + 2, 0].max() > 8 * BY
    if caps == BANK_CAPS["pcm"]:
        # the three rates the NRZ lanes accept give them one event of three
        # rows (row breaks at gaps of 160 and 150), none flagged
        assert not want["ovf"][:2, 1:4].any()
        assert (want["num_rows"][0, 1:4, 0] == 3).all()
        assert want["bits_per_row"][0, 1, 0, :3].tolist() == [22, 70, 17]
        assert want["bits_per_row"][1, 1, 0, 0] == 154
        # runs of 37 to 40 ones past the row's 320 bits
        assert want["ovf"][2, 1] and want["bits_per_row"][2, 1, 0, 0] == 373
        assert want["bytes"][2, 1, 0, 0, -1] == 255
        assert not want["ovf"][3:7, 0].any()
        # a clear keeps only what follows it (10 pulses of a 1 and two
        # zeros, and the flush's 1 and 3 zeros), also after a flush in its
        # tile; a clear that is a flush candidate flushes nothing
        assert want["bits_per_row"][4, 0, :3, 0].tolist() == [34, 10, 10]
        assert want["bits_per_row"][5, 0, 0, 0] == 16
        # the row break at the last pulse: the event keeps the row it
        # opened, empty
        assert want["num_rows"][6, 0, 0] == 3
        assert want["bits_per_row"][6, 0, 0, :3].tolist() == [17, 13, 0]


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_pcm_edge_trains_match_jax_over_tile_borders(caps):
    """The PCM edge trains from every offset of a tile of 32 pulses (each
    train behind 1 to 32 pulses out of every run class, the last of them a
    flush candidate), so that each accepted run, clear and flush also falls
    on a tile's first and last thread."""
    caps = BANK_CAPS["pcm"] if caps == "bank" else SMALL_CAPS
    trains = []
    for k, (p, g) in enumerate(pcm_edges()[:-1] * 5):
        lead = k % 32
        trains.append(([80] * (lead + 1) + p, [80] * lead + [500] + g))
    _d, _t, want, got = _run_both("pcm", caps, trains=trains,
                                  bounds=pcm_edge_bounds())
    _same(want, got, "pcm edges over tile borders")
    assert (want["n_events"][:, 1:4] >= 1).all()


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_nrzs_edge_trains_match_jax(caps):
    """Pulses at exactly the bit limit (no bit), an event of them alone
    (flushed, empty), empty flushes back to back, a zero alone, runs of
    ones over word edges and past the row's bits, more events than E; on
    the planted spec (lane 0) and the registry's."""
    caps = BANK_CAPS["nrzs"] if caps == "bank" else SMALL_CAPS
    edges = nrzs_edges()
    _d, _t, want, got = _run_both("nrzs", caps,
                                  trains=edges + nrzs_cap_trains(caps),
                                  bounds=nrzs_edge_bounds())
    _same(want, got, "nrzs edges")
    E, R, BY = caps
    K = len(edges)
    # the exact-limit pulses emit nothing: event 0 flushes with no row,
    # event 1 holds two runs of 3 ones and a 0 each, and the last 0
    assert want["n_events"][:3, 0].tolist() == [2, 7, 2]
    assert want["bits_per_row"][0, 0, :2, 0].tolist() == [0, 9][:E]
    # empty flushes back to back: a row only where a 0 fell
    assert want["num_rows"][1, 0, :2].tolist() == [0, 0]
    assert want["ovf"][K:, 0].all()
    assert want["n_events"][K, 0] > E
    assert want["bits_per_row"][K + 1, 0, 0, 0] > 8 * BY
    if caps == BANK_CAPS["nrzs"]:
        assert want["num_rows"][0, 0, :2].tolist() == [0, 1]
        assert not want["ovf"][0, 0] and want["ovf"][1, 0]   # 7 events
        # 37, 29 and 33 ones, each and a zero: bits 0-36 set, 37 clear
        assert want["bytes"][2, 0, 0, 0, :5].tolist() == [255] * 4 + [251]
        assert want["bits_per_row"][2, 0, :2, 0].tolist() == [144, 370]
        assert want["ovf"][2, 0]


@pytest.mark.parametrize("caps", ["bank", "small"])
@pytest.mark.parametrize("fam", ["ppm", "mc", "pwm", "dmc", "piwm_dc", "rzi",
                                 "osv1"])
def test_cap_trains_match_jax(fam, caps):
    """Trains past the events, rows and row-bits caps, one cap each (RZI
    and OSV1 write row 0 alone, OSV1 one event: a run past the row's bits
    and more bits instead): the planted lane is flagged on every one (on
    the cursors before the flush) and every plane still equals JAX's, the
    writes past the caps dropped."""
    caps = BANK_CAPS[fam] if caps == "bank" else SMALL_CAPS
    if fam in ("rzi", "osv1"):
        _d, _t, want, got = _run_both(fam, caps,
                                      trains=pulse_cap_trains(fam, caps),
                                      bounds=pulse_edge_bounds(fam))
    elif fam == "ppm":
        _d, _t, want, got = _run_both(fam, caps, trains=ppm_cap_trains(caps),
                                      bounds=ppm_edge_bounds())
    elif fam in ("dmc", "piwm_dc"):
        _d, _t, want, got = _run_both(fam, caps,
                                      trains=symbol_cap_trains(fam, caps),
                                      bounds=symbol_edge_bounds(fam))
    else:
        dev = pwm_edge_dev() if fam == "pwm" else mc_edge_devs()[0]
        _d, _t, want, got = _run_both(fam, caps,
                                      trains=cap_trains(fam, dev, caps),
                                      devs=[dev] + family_devices(fam))
    _same(want, got, f"{fam} caps")
    E, R, BY = caps
    assert want["ovf"][:, 0].all()
    if fam == "osv1":
        assert (want["n_events"][:, 0] == 1).all()
    else:
        assert want["n_events"][0, 0] > E
    if fam in ("rzi", "osv1"):
        assert want["bits_per_row"][1, 0].max() > 8 * BY
    else:
        assert want["num_rows"][1, 0].max() > R
    assert want["bits_per_row"][2, 0].max() > 8 * BY


@pytest.mark.parametrize("fam", FAMS)
def test_length_trains_match_jax(fam):
    """Trains of 1, 31, 32, 33 and 1200 pulses: inside one tile of 32,
    on its edge, across it, and over 38 tiles; for DMC and PIWM-DC, whose
    tiles hold 32 symbols (16 pulses), of 1, 15, 16, 17 and 1200 pulses;
    for RZI and OSV1 also of 7, 8, 9, 12 and 13 (around a tile of 8, and
    OSV1's preamble and sync); for PCM and NRZS of 1, 31, 32, 33 and 8192
    (256 tiles, PCM's rate pass over every one of them first)."""
    devs = family_devices(fam)
    lengths = (1, 15, 16, 17, 1200) if fam in tslice.SYMBOL_FAMILIES \
        else (1, 7, 8, 9, 12, 13, 31, 32, 33, 1200) \
        if fam in ("rzi", "osv1") else (1, 31, 32, 33, 8192) \
        if fam in ("pcm", "nrzs") else (1, 31, 32, 33, 1200)
    trains = length_trains(fam, devs, 17, lengths)
    assert [len(p) for p, _g in trains] == list(lengths)
    _d, _t, want, got = _run_both(fam, BANK_CAPS[fam], trains=trains,
                                  devs=devs)
    _same(want, got, f"{fam} lengths")
    if fam == "osv1":
        # one frame a train; every train past its sync and first data
        # pulses flushes it
        long_ = np.asarray(lengths) > 13
        assert (want["n_events"][long_] == 1).all()
        assert not want["n_events"][~long_].any()
    else:
        assert want["n_events"][-1].sum() > 20


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


@pytest.mark.parametrize("fam", ["ppm", "pcm", "dmc", "nrzs", "osv1"])
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


def test_all_nine_families_run_as_groups():
    """No family walks a lane on one thread: every family of the kernel
    runs a thread group per lane."""
    assert tslice.GROUP_FAMILIES == tuple(tslice.FAMILIES)
    assert sorted(tslice.GROUP_FAMILIES) == sorted(
        ["ppm", "pwm", "pcm", "mc", "dmc", "piwm_dc", "nrzs", "rzi", "osv1"])


@pytest.mark.parametrize("N", [1, 12, 64, 1200, 8192])
@pytest.mark.parametrize("caps", _CAPS_IN_USE, ids=str)
@pytest.mark.parametrize("fam", tslice.GROUP_FAMILIES)
def test_launch_plan_groups_fit_every_cap_set_in_use(fam, caps, N):
    """A group of 8, 16 or 32 threads per lane (by the lane's steps: N
    pulses, or 2N symbols for DMC and PIWM-DC), whole warps of lanes (up
    to four, fewer where S is smaller), each lane staging every event,
    inside the 227 KB a block may use."""
    E, R, BY = caps
    steps = 2 * N if fam in tslice.SYMBOL_FAMILIES else N
    for S in (1, 3, 12, 26, 125):
        lanes, g, sb, smem = tslice.launch_plan(S, N, caps, fam)
        assert g in (8, 16, 32) and lanes * g % 32 == 0
        assert lanes * g <= 128
        assert lanes <= -(-S // (32 // g)) * (32 // g)
        assert sb == tslice.stage_bytes(caps) and sb % 32 == 16
        assert sb >= E * (R * (-(-BY // 4) * 4) + 8 * R + 4)
        assert smem == -(-8 * N // 16) * 16 + lanes * sb
        assert smem <= tslice.SMEM_MAX
        if g < 32:
            assert steps <= g


@pytest.mark.parametrize("fam,N,g", [
    ("mc", 1, 8), ("mc", 8, 8), ("mc", 9, 16), ("mc", 16, 16),
    ("mc", 17, 32), ("mc", 64, 32), ("mc", 1200, 32), ("pwm", 9, 16),
    ("ppm", 1, 8), ("ppm", 8, 8), ("ppm", 9, 16), ("ppm", 16, 16),
    ("ppm", 17, 32), ("ppm", 1200, 32),
    ("dmc", 1, 8), ("dmc", 4, 8), ("dmc", 5, 16), ("dmc", 8, 16),
    ("dmc", 9, 32), ("dmc", 1200, 32), ("piwm_dc", 4, 8),
    ("piwm_dc", 5, 16), ("piwm_dc", 9, 32), ("rzi", 1, 8), ("rzi", 8, 8),
    ("rzi", 9, 16), ("rzi", 16, 16), ("rzi", 17, 32), ("rzi", 1200, 32),
    ("osv1", 8, 8), ("osv1", 12, 16), ("osv1", 13, 16), ("osv1", 17, 32),
    ("osv1", 2048, 32), ("pcm", 1, 8), ("pcm", 8, 8), ("pcm", 9, 16),
    ("pcm", 16, 16), ("pcm", 17, 32), ("pcm", 64, 32), ("pcm", 8192, 32),
    ("nrzs", 1, 8), ("nrzs", 8, 8), ("nrzs", 9, 16), ("nrzs", 16, 16),
    ("nrzs", 17, 32), ("nrzs", 8192, 32)])
def test_launch_plan_group_size_follows_n(fam, N, g):
    """A group per lane of 8, 16 or 32 threads by the lane's steps: N
    pulses, or for DMC and PIWM-DC 2N symbols."""
    assert tslice.launch_plan(26, N, BANK_CAPS[fam], fam)[1] == g


@pytest.mark.parametrize("N", [64, 1200, 2048, 8192])
@pytest.mark.parametrize("fam", ["mc", "dmc", "piwm_dc"])
def test_launch_plan_puts_several_group_blocks_on_an_sm_at_mc_caps(fam, N):
    """At MC's caps (8 x 24 x 20: 5.4 KB a lane; DMC's and PIWM-DC's too)
    a block of four lanes leaves room for several blocks per SM."""
    assert BANK_CAPS[fam] == BANK_CAPS["mc"]
    lanes, g, sb, smem = tslice.launch_plan(125, N, BANK_CAPS[fam], fam)
    assert (lanes, g) == (4, 32)
    assert tslice.SMEM_SM // (smem + 1024) >= (4 if N <= 2048 else 2)


@pytest.mark.parametrize("fam", tslice.GROUP_FAMILIES)
def test_launch_plan_takes_a_warp_per_lane_where_a_group_would_not_fit(fam):
    """Four lanes of 8 threads (one warp) need four stages; where those do
    not fit, a warp runs one lane."""
    caps = tslice.SliceCaps(4, 32, 500)
    sb = tslice.stage_bytes(caps)
    assert 16 + 4 * sb > tslice.SMEM_MAX >= 16 + 3 * sb
    assert tslice.launch_plan(26, 2, caps, fam)[:2] == (3, 32)


@pytest.mark.parametrize("caps,N", [((4, 64, 1024), 64), ((4, 16, 40), 30000)])
def test_launch_plan_raises_where_no_group_fits(caps, N):
    """No fallback to the plain version: a plan that does not fit
    raises."""
    for fam in tslice.GROUP_FAMILIES:
        with pytest.raises(ValueError, match="shared memory"):
            tslice.launch_plan(100, N, tslice.SliceCaps(*caps), fam)

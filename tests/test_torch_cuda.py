"""The CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``: each test skips itself where torch sees no CUDA device
(the kernels have no CPU mode). On a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from rtl_433_tpu_torch.dsp.engine import DetectorParams, detector_init
from rtl_433_tpu_torch.ops import _cuda
from rtl_433_tpu_torch.ops import compact as cmp
from rtl_433_tpu_torch.ops import detector as det
from rtl_433_tpu_torch.ops import frontend as fe

pytestmark = pytest.mark.cuda


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("use_mag_est", [False, True])
@pytest.mark.parametrize("enable_fm", [False, True])
@pytest.mark.parametrize("n_valid", [4096, 3000])
def test_frontend_kernel_matches_plain(use_mag_est, enable_fm, n_valid):
    dev = _gpu()
    rng = np.random.default_rng(1)
    iq = torch.from_numpy(rng.integers(0, 256, (37, 4096, 2),
                                       dtype=np.uint8)).to(dev)
    st = torch.from_numpy(rng.integers(-100, 100, (6, 37)).astype(
        np.int32)).to(dev)
    alp1, blp = fe._coeffs(250_000, enable_fm, 0.0, False)
    kw = dict(use_mag_est=use_mag_est, enable_fm=enable_fm, alp1=alp1,
              blp=blp, n_valid=n_valid)
    before = _cuda.LAUNCHES["frontend"]
    got = fe.frontend_cuda(iq, st, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["frontend"] == before + 1
    want = fe.frontend_plain(iq, st, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


@pytest.mark.parametrize("N,C,n_valid", [(4099, 37, 4099), (4099, 37, 0),
                                         (100, 3, 57), (1000, 64, 999)])
def test_frontend_kernel_ragged_shapes(N, C, n_valid):
    """Block lengths that rule out the 16-byte staging copies, a last
    channel group of 5, and n_valid at 0 and inside the block."""
    dev = _gpu()
    rng = np.random.default_rng(4)
    iq = torch.from_numpy(rng.integers(0, 256, (C, N, 2),
                                       dtype=np.uint8)).to(dev)
    st = torch.from_numpy(rng.integers(-100, 100, (6, C)).astype(
        np.int32)).to(dev)
    alp1, blp = fe._coeffs(250_000, True, 0.0, False)
    kw = dict(use_mag_est=False, enable_fm=True, alp1=alp1, blp=blp,
              n_valid=n_valid)
    got = fe.frontend_cuda(iq, st, **kw)
    torch.cuda.synchronize()
    want = fe.frontend_plain(iq, st, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("enable_fm", [True, False])
def test_detector_kernel_matches_plain(minmax, enable_fm):
    dev = _gpu()
    rng = np.random.default_rng(2)
    C, N = 16, 16384
    iq = rng.integers(120, 136, (C, N, 2), dtype=np.uint8)
    for c in range(C):
        for k in range(6):
            s = 500 + k * 2500 + c * 7
            iq[c, s:s + 600] = rng.integers(10, 246, (600, 2),
                                            dtype=np.uint8)
    iq = torch.from_numpy(iq).to(dev)
    p = DetectorParams(fsk_minmax=minmax, enable_fm=enable_fm)
    st = detector_init(p, C, dev)
    am, fm, st, _ = fe.frontend(iq, st, sample_rate=250_000,
                                enable_fm=enable_fm, fsk_minmax=minmax,
                                time_major=True)
    assert fm.dtype == (torch.int16 if enable_fm else torch.int32)
    regs = det.pack_regs(st)
    gen0 = st["gen"].clone()
    got = det.detector_scan_cuda(am, fm, regs, gen0, params=p,
                                 n_valid=N - 333)
    torch.cuda.synchronize()
    want = det.detector_scan_plain(am, fm, regs, gen0, params=p,
                                   n_valid=N - 333)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[1] < det.KEY_INVALID).sum()) > 0


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("enable_fm", [True, False])
def test_process_block_cuda_matches_cpu(minmax, enable_fm):
    """The whole engine (both kernels and the torch drain on the card)
    against the CPU run of the same block: every state key equal."""
    from rtl_433_tpu_torch.dsp.engine import process_block
    dev = _gpu()
    rng = np.random.default_rng(3)
    C, N = 8, 32768
    iq = rng.integers(120, 136, (C, N, 2), dtype=np.uint8)
    for c in range(C):
        for k in range(8):
            s = 300 + k * 3900 + c * 11
            iq[c, s:s + 900] = rng.integers(10, 246, (900, 2),
                                            dtype=np.uint8)
    p = DetectorParams(fsk_minmax=minmax, enable_fm=enable_fm, pkg_cap=4)
    out = {}
    for d in ("cpu", dev):
        st = detector_init(p, C, d)
        x = torch.from_numpy(iq).to(d)
        st, _ = process_block(p, st, x[:, :N // 2].contiguous(), None)
        st, _ = process_block(p, st, x[:, N // 2:].contiguous(), N // 2 - 5,
                              flush=True)
        out[str(d)] = {k: v.cpu() for k, v in st.items()}
    cpu, gpu = out["cpu"], out[str(dev)]
    assert int(cpu["out_n"].sum()) > 0
    for k in cpu:
        assert torch.equal(cpu[k], gpu[k]), k


@pytest.mark.parametrize("name", ["c33", "fixed", "ramp", "mid_nvalid",
                                  "lead_in", "wide_ring", "run_bound"])
def test_detector_quiet_cases_match_plain(name):
    """The quiet-chunk path on its edge cases: bit-exact outputs and the
    same count of quiet chunks as the plain version."""
    from torch_scan_cases import CASES
    dev = _gpu()
    case = CASES[name](16384)
    args = [case[k].to(dev) for k in ("am", "fm", "regs", "gen0")]
    kw = dict(params=case["params"], n_valid=case["n_valid"])
    got = det.detector_scan_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = det.detector_scan_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    G = 16384 // case["params"].chunk
    assert 0 < int(want[5].min()) and int(want[5].max()) < G


@pytest.mark.parametrize("C", [1, 33, 4096])
@pytest.mark.parametrize("cap", [1, 7, 768])
@pytest.mark.parametrize("P", [1200, 13])
def test_compact_kernel_matches_plain(C, cap, P):
    """Ragged states (out_n over the slot count, meta over the whole int32
    range): all five outputs bit-exact, and the packed buffer they view,
    its zero padding columns included. P=13 takes the scalar row copy."""
    dev = _gpu()
    rng = np.random.default_rng(C * 1000 + cap)
    S = 8
    ins = [rng.integers(0, 13, C).astype(np.int32),
           rng.integers(0, 1 << 31, (C, S, P), dtype=np.int64).astype(
               np.int32),
           rng.integers(0, 1 << 31, (C, S, P), dtype=np.int64).astype(
               np.int32),
           rng.integers(-(1 << 31), 1 << 31, (C, S, 9), dtype=np.int64)
           .astype(np.int32)]
    ins = [torch.from_numpy(a).to(dev) for a in ins]
    before = _cuda.LAUNCHES["compact"]
    got = cmp.compact_packages_cuda(*ins, cap)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compact"] == before + 1
    want = cmp.compact_packages_plain(*ins, cap)
    for k in ("pulse", "gap", "meta", "channel", "count", "rows"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def _compact_ins(rng, C, S, P, n_hi):
    return [rng.integers(0, n_hi + 1, C).astype(np.int32),
            rng.integers(0, 1 << 31, (C, S, P), dtype=np.int64).astype(
                np.int32),
            rng.integers(0, 1 << 31, (C, S, P), dtype=np.int64).astype(
                np.int32),
            rng.integers(-(1 << 31), 1 << 31, (C, S, 9), dtype=np.int64)
            .astype(np.int32)]


@pytest.mark.parametrize("what,C,S,P,cap", [
    ("large C, two-level count", 65536, 8, 13, 768),
    ("large C, every row kept", 20000, 2, 8, 50000),
    ("cap past C * S", 33, 8, 12, 400),
    ("every channel full", 4096, 8, 16, 2048),
    ("every channel full, all kept", 300, 8, 1200, 2400)])
def test_compact_kernel_new_paths(what, C, S, P, cap):
    """The one-launch kernel's other branches: past 8192 channels the
    tile sums shared across a cooperative grid, a cap beyond every slot
    (padding rows after all C * S), and states whose every channel is full
    (out_n at or past S): all six outputs bit-exact, one launch a call."""
    dev = _gpu()
    rng = np.random.default_rng(C + cap)
    ins = _compact_ins(rng, C, S, P, 12)
    if "full" in what:
        ins[0] = np.where(rng.random(C) < 0.5, S, S + 3).astype(np.int32)
    ins = [torch.from_numpy(a).to(dev) for a in ins]
    before = _cuda.LAUNCHES["compact"]
    got = cmp.compact_packages_cuda(*ins, cap)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compact"] == before + 1
    want = cmp.compact_packages_plain(*ins, cap)
    for k in ("pulse", "gap", "meta", "channel", "count", "rows"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
    if "full" in what:
        assert int(want["count"]) == C * S


def test_sharded_engine_on_the_card_matches_cpu():
    """ShardedEngine on a one-GPU mesh and on the CPU: the same packages,
    through the compaction kernel on the card."""
    from rtl_433_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
    dev = _gpu()
    rng = np.random.default_rng(6)
    C, N = 16, 32768
    iq = rng.integers(120, 136, (C, N, 2), dtype=np.uint8)
    for c in range(C):
        for k in range(6):
            s = 500 + k * 5000 + c * 13
            iq[c, s:s + 1200] = rng.integers(10, 246, (1200, 2),
                                             dtype=np.uint8)
    p = DetectorParams(pkg_cap=4)
    out = {}
    for d in ("cpu", dev):
        eng = ShardedEngine(p, C, make_mesh(devices=[d]), pkg_cap_total=40)
        before = _cuda.LAUNCHES["compact"]
        eng.push(iq, flush=True)
        out[str(d)] = (eng.take_packages(), eng.n_pkg_dropped,
                       _cuda.LAUNCHES["compact"] - before)
    (cpu, cdrop, claunch), (gpu, gdrop, glaunch) = out["cpu"], out[str(dev)]
    assert (claunch, glaunch) == (0, 1)
    assert cdrop == gdrop and len(cpu) == len(gpu) > 0
    for a, b in zip(cpu, gpu):
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# ---- device slicing: csrc/slice.cu (kernel A) and csrc/dispatch.cu (B, C)

def _slice_inputs(fam, seed, n, dev, repeat=1):
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import family_devices, family_trains, pack
    devs = family_devices(fam)
    trains = family_trains(fam, devs, seed, n=n)
    trains = [(p * repeat, g * repeat) for p, g in trains]
    bounds = getattr(sl, f"{fam}_bounds")(devs, 250_000)
    return [torch.from_numpy(a).to(dev) for a in pack(trains)], bounds


def _same_planes(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].cpu().to(torch.int64),
                           want[k].cpu().to(torch.int64)), k


@pytest.mark.parametrize("caps", ["bank", "small"])
@pytest.mark.parametrize("fam", ["ppm", "pwm", "pcm", "mc", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_matches_plain(fam, caps):
    """Every plane on every lane, flagged lanes included, at the bank's
    caps and at caps that flag most lanes; one launch per call."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import BANK_CAPS, SMALL_CAPS
    dev = _gpu()
    caps = BANK_CAPS[fam] if caps == "bank" else SMALL_CAPS
    args, bounds = _slice_inputs(fam, 5, 24, dev)
    key = f"slice_{fam}"
    before = _cuda.LAUNCHES[key]
    got = sl.slice_cuda(fam, *args, bounds, caps)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[key] == before + 1
    want = sl.PLAIN[fam](*[a.cpu() for a in args], bounds, caps)
    _same_planes(got, want)
    assert want["n_events"].sum() > 0


@pytest.mark.parametrize("fam", ["ppm", "pcm", "dmc", "piwm_dc"])
def test_slice_kernel_long_trains(fam):
    """Trains of hundreds of pulses (the symbol families step over twice as
    many), padded to N = 8192: 64 KB of staging, above the default
    dynamic shared memory."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import BANK_CAPS, pack
    dev = _gpu()
    args, bounds = _slice_inputs(fam, 7, 6, dev, repeat=12)
    cpu = [a.cpu() for a in args]
    want = sl.PLAIN[fam](*cpu, bounds, BANK_CAPS[fam])
    pulse, gap, npl = cpu
    wide = [torch.zeros((pulse.shape[0], 8192), dtype=torch.int32)
            for _ in range(2)]
    for w, a in zip(wide, (pulse, gap)):
        w[:, :a.shape[1]] = a
    got = sl.slice_cuda(fam, wide[0].to(dev), wide[1].to(dev), npl.to(dev),
                        bounds, BANK_CAPS[fam])
    torch.cuda.synchronize()
    _same_planes(got, want)



@pytest.mark.parametrize("fam", ["ppm", "pwm", "pcm", "mc", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_at_the_drain_shape(fam):
    """The 4096-channel drain's largest slicer call: 256 trains of 64
    pulses x 125 specs at the bank's caps, so a train spans two blocks
    of 64 lanes; every element of the uninitialized outputs written."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import BANK_CAPS, RATE, drain_shaped
    dev = _gpu()
    arrs, devs = drain_shaped(fam, 3)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    args = [torch.from_numpy(a) for a in arrs]
    assert sl.launch_plan(125, 64, BANK_CAPS[fam], fam)[:2] == (4, 32)
    # garbage where the outputs will be allocated: the kernel must write
    # every element, not find zeros
    torch.full((256 << 20,), 0x5A, dtype=torch.uint8, device=dev)
    got = sl.slice_cuda(fam, *(a.to(dev) for a in args), bounds,
                        BANK_CAPS[fam])
    torch.cuda.synchronize()
    _same_planes(got, sl.PLAIN[fam](*args, bounds, BANK_CAPS[fam]))



@pytest.mark.parametrize("every", [True, False])
@pytest.mark.parametrize("fam", ["ppm", "pwm", "pcm", "mc", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_either_staging(fam, every, monkeypatch):
    """The same lanes (64 drain-shaped trains x 125 specs) in blocks of
    one lane (``every``) and of four lanes, every event of a lane staged,
    the plan forced either way: both equal the plain version."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import BANK_CAPS, RATE, drain_shaped
    dev = _gpu()
    caps = BANK_CAPS[fam]
    arrs, devs = drain_shaped(fam, 4, B=64)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    args = [torch.from_numpy(a) for a in arrs]
    sb = sl.stage_bytes(caps)
    lanes = 1 if every else 4
    plan = (lanes, 32, sb, -(-8 * 64 // 16) * 16 + lanes * sb)
    monkeypatch.setattr(sl, "launch_plan", lambda *a, **k: plan)
    got = sl.slice_cuda(fam, *(a.to(dev) for a in args), bounds, caps)
    torch.cuda.synchronize()
    _same_planes(got, sl.PLAIN[fam](*args, bounds, caps))

def test_slice_kernel_open_event_erased_at_the_end():
    """RZ PCM lanes whose open event is cleared at the last pulse: its
    rows, written and then erased in the stage, leave as zeros (alone,
    and after a kept event); the same run ending on a reset is kept."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, RATE, family_devices, pack,
                                   pcm_open_erased)
    dev = _gpu()
    devs = [d for d in family_devices("pcm") if d.short_width != d.long_width]
    bounds = sl.pcm_bounds(devs[:1], RATE)
    args = [torch.from_numpy(a) for a in pack(pcm_open_erased(devs[0]))]
    got = sl.slice_cuda("pcm", *(a.to(dev) for a in args), bounds,
                        BANK_CAPS["pcm"])
    torch.cuda.synchronize()
    want = sl.PLAIN["pcm"](*args, bounds, BANK_CAPS["pcm"])
    _same_planes(got, want)
    assert want["n_events"][:, 0].tolist() == [0, 1, 1]
    assert int(want["bits_per_row"][2, 0, 0, 0]) > 0


@pytest.mark.parametrize("caps", ["bank", "small"])
def test_slice_kernel_lane_past_every_cap(caps):
    """PPM lanes that pass the events, rows and row-bytes caps in one
    train: every write outside them dropped as the plain version drops
    it, the counts kept."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, RATE, SMALL_CAPS,
                                   family_devices, pack, ppm_overflow)
    dev = _gpu()
    caps = BANK_CAPS["ppm"] if caps == "bank" else SMALL_CAPS
    devs = family_devices("ppm")
    bounds = sl.ppm_bounds(devs, RATE)
    args = [torch.from_numpy(a) for a in pack([ppm_overflow(d, caps)
                                               for d in devs])]
    got = sl.slice_cuda("ppm", *(a.to(dev) for a in args), bounds, caps)
    torch.cuda.synchronize()
    want = sl.PLAIN["ppm"](*args, bounds, caps)
    _same_planes(got, want)
    E, R, BY = caps
    own = torch.arange(len(devs))
    assert (want["n_events"][own, own] > E).all()
    assert (want["num_rows"][own, own].amax(-1) > R).all()
    assert (want["bits_per_row"][own, own].amax((-1, -2)) > 8 * BY).all()

def _group_call(fam, arrs, bounds, caps, dev, g=None, monkeypatch=None):
    """One launch of a family's kernel over outputs allocated where
    garbage was (every element must be written), the plan's threads per
    lane forced to ``g``; held to the plain version."""
    from rtl_433_tpu_torch.ops import slice as sl
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    B, N = args[0].shape
    if g is not None:
        S = len(bounds["ok"])
        sb = sl.stage_bytes(caps)
        lanes = min(4 * 32 // g, -(-S // (32 // g)) * (32 // g))
        plan = (lanes, g, sb, -(-8 * N // 16) * 16 + lanes * sb)
        monkeypatch.setattr(sl, "launch_plan", lambda *a, **k: plan)
    torch.full((256 << 20,), 0x5A, dtype=torch.uint8, device=dev)
    key = f"slice_{fam}"
    before = _cuda.LAUNCHES[key]
    got = sl.slice_cuda(fam, *(a.to(dev) for a in args), bounds, caps)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[key] == before + 1
    want = sl.PLAIN[fam](*args, bounds, caps)
    _same_planes(got, want)
    return want


@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("fam", ["ppm", "mc", "pwm", "pcm", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_each_group_size(fam, g, monkeypatch):
    """Each threads-per-lane the plan can pick, forced on the drain's
    shape (64 trains of up to 64 pulses x 125 specs) and on trains of 1,
    31, 32, 33 and 1200 pulses (twice as many symbols for DMC and
    PIWM-DC): several tiles per lane at every size."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, RATE, drain_shaped,
                                   family_devices, length_trains, pack)
    dev = _gpu()
    arrs, devs = drain_shaped(fam, 6, B=64)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    _group_call(fam, arrs, bounds, BANK_CAPS[fam], dev, g, monkeypatch)
    devs = family_devices(fam)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    want = _group_call(fam, pack(length_trains(fam, devs, 23)), bounds,
                       BANK_CAPS[fam], dev, g, monkeypatch)
    assert want["n_events"].sum() > 0


def _pulse_group_trains(fam, caps):
    """RZI's, OSV1's, PCM's or NRZS's planted trains (edge cases, a train
    past each cap it can pass, trains of 1 to 1200 pulses around tiles of
    8; PCM's and NRZS's edge trains also behind 1 to 32 pulses of a
    flushed event, so that each case falls on every thread of a tile) with
    the planted specs' bound columns."""
    from torch_slice_cases import (family_devices, length_trains,
                                   nrzs_cap_trains, nrzs_edge_bounds,
                                   nrzs_edges, osv1_edges, pcm_cap_trains,
                                   pcm_edge_bounds, pcm_edges,
                                   pulse_cap_trains, pulse_edge_bounds,
                                   rzi_edges)
    lengths = length_trains(fam, family_devices(fam), 29,
                            (1, 7, 8, 9, 12, 13, 31, 32, 33, 1200))
    if fam in ("rzi", "osv1"):
        edges = rzi_edges() if fam == "rzi" else osv1_edges()
        return (edges + pulse_cap_trains(fam, caps) + lengths,
                pulse_edge_bounds(fam))
    if fam == "pcm":
        edges, caps_, bounds, lead = (pcm_edges(), pcm_cap_trains(caps),
                                      pcm_edge_bounds(), (80, 80, 500))
    else:
        edges, caps_, bounds, lead = (nrzs_edges(), nrzs_cap_trains(caps),
                                      nrzs_edge_bounds(), (9, 5, 100))
    shifted = []
    for k, (p, g) in enumerate(edges[:-1] * 5):
        n = k % 32
        shifted.append(([lead[0]] * (n + 1) + p,
                        [lead[1]] * n + [lead[2]] + g))
    return edges + caps_ + shifted + lengths, bounds


@pytest.mark.parametrize("caps", ["bank", "small"])
@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("fam", ["rzi", "osv1", "pcm", "nrzs"])
def test_slice_kernel_pulse_group_edges_each_group_size(fam, g, caps,
                                                         monkeypatch):
    """RZI's, OSV1's, PCM's and NRZS's planted trains on the group kernel
    with 8, 16 and 32 threads per lane: runs over several words and past
    the row, empty flushes, OSV1's preambles, syncs and clipped ones,
    phase 0 across a tile of 8; PCM's accepted runs (several in one tile,
    one across a tile's edge), its clears across tiles and its row break
    at the last pulse, each behind leads of 1 to 32 pulses."""
    from torch_slice_cases import BANK_CAPS, SMALL_CAPS, pack
    dev = _gpu()
    caps = BANK_CAPS[fam] if caps == "bank" else SMALL_CAPS
    trains, bounds = _pulse_group_trains(fam, caps)
    want = _group_call(fam, pack(trains), bounds, caps, dev, g, monkeypatch)
    assert want["ovf"].any() and (~want["ovf"]).any()
    assert want["n_events"].sum() > 0


@pytest.mark.parametrize("g", [8, 16])
def test_slice_kernel_pcm_rounds_differ_within_a_warp(g, monkeypatch):
    """Several lanes of one warp (8 or 16 threads each) whose NRZ rate
    passes take different numbers of rounds on the same train: the
    planted RZ spec (one round a tile) and the NRZ specs seeded at 1/20,
    1/26 and 1/40 (the last accepts a run more) in the first warp, on the
    PCM edge trains behind leads of 1 to 32 pulses: every group of the
    warp runs a round while any needs one, and each lane equals the plain
    version."""
    from torch_slice_cases import BANK_CAPS, pack, pcm_edge_bounds
    dev = _gpu()
    trains, _b = _pulse_group_trains("pcm", BANK_CAPS["pcm"])
    bounds = {k: v[:4] for k, v in pcm_edge_bounds().items()}
    want = _group_call("pcm", pack(trains), bounds, BANK_CAPS["pcm"], dev, g,
                       monkeypatch)
    assert want["n_events"][:, 1:].sum() > 0 and want["n_events"][:, 0].sum()


@pytest.mark.parametrize("caps", ["bank", "small"])
@pytest.mark.parametrize("fam", ["ppm", "mc", "pwm", "pcm", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_planted_group_trains(fam, caps):
    """The planted trains of tests/torch_slice_cases.py: each family's edge
    cases, a train past each cap, and trains of 1 to 1200 pulses."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, RATE, SMALL_CAPS, cap_trains,
                                   dmc_edges, family_devices, length_trains,
                                   mc_edge_devs, mc_edges, pack,
                                   piwm_dc_edges, ppm_cap_trains,
                                   ppm_edge_bounds, ppm_edges, pwm_edge_dev,
                                   pwm_edges, symbol_cap_trains,
                                   symbol_edge_bounds)
    dev = _gpu()
    caps = BANK_CAPS[fam] if caps == "bank" else SMALL_CAPS
    if fam in ("rzi", "osv1", "pcm", "nrzs"):
        trains, bounds = _pulse_group_trains(fam, caps)
        want = _group_call(fam, pack(trains), bounds, caps, dev)
        assert want["ovf"].any() and (~want["ovf"]).any()
        return
    if fam == "ppm":
        trains = ppm_edges() + ppm_cap_trains(caps) + length_trains(
            fam, family_devices(fam), 29)
        want = _group_call(fam, pack(trains), ppm_edge_bounds(), caps, dev)
        assert want["ovf"].any() and (~want["ovf"]).any()
        return
    if fam in sl.SYMBOL_FAMILIES:
        edges = dmc_edges() if fam == "dmc" else piwm_dc_edges()
        trains = edges + symbol_cap_trains(fam, caps) + length_trains(
            fam, family_devices(fam), 29, (1, 4, 8, 15, 16, 17, 1200))
        want = _group_call(fam, pack(trains), symbol_edge_bounds(fam), caps,
                           dev)
        assert want["ovf"].any() and (~want["ovf"]).any()
        return
    if fam == "pwm":
        lead = [pwm_edge_dev()]
        edges = pwm_edges(lead[0])
    else:
        lead = list(mc_edge_devs())
        edges = mc_edges(*lead)
    devs = lead + family_devices(fam)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    trains = edges + cap_trains(fam, lead[0], caps) + length_trains(
        fam, devs, 29)
    want = _group_call(fam, pack(trains), bounds, caps, dev)
    assert want["ovf"].any() and (~want["ovf"]).any()


@pytest.mark.parametrize("fam", ["ppm", "mc", "pwm", "pcm", "dmc", "piwm_dc",
                                 "nrzs", "rzi", "osv1"])
def test_slice_kernel_groups_at_the_mixed_shapes(fam):
    """The mixed streams' calls: a few trains of tens to 1200 pulses in a
    bucket of 2048, every spec of the family in the registry (MC 41, PWM
    91, DMC 6, PIWM-DC 4, RZI, OSV1 and NRZS one each, PPM and PCM all of
    theirs), the plan's own choice."""
    from rtl_433_tpu_torch.ops import slice as sl
    from torch_slice_cases import (BANK_CAPS, RATE, family_devices,
                                   length_trains, pack)
    dev = _gpu()
    devs = family_devices(fam, k=1000)
    bounds = getattr(sl, f"{fam}_bounds")(devs, RATE)
    trains = length_trains(fam, devs, 31, lengths=(12, 40, 75, 300, 1200,
                                                    640, 90, 5))
    want = _group_call(fam, pack(trains, n_min=2048), bounds,
                       BANK_CAPS[fam], dev)
    assert want["n_events"].sum() > 0


def _dup_planes(seed, dev):
    from torch_slice_cases import dup_planes
    return {k: torch.from_numpy(v).to(dev) for k, v in
            dup_planes(seed, B=5, J=7, E=8, R=6, W=20).items()}


@pytest.mark.parametrize("seed", [1, 2])
def test_content_dup_kernel_matches_plain(seed):
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    dev = _gpu()
    planes = _dup_planes(seed, dev)
    before = _cuda.LAUNCHES["content_dup"]
    got = ddp._content_dup(planes)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["content_dup"] == before + 1
    want = ddp._content_dup_plain(planes)
    assert torch.equal(got.cpu(), want.cpu())
    E = want.shape[2]
    assert (want.cpu() != torch.arange(E, dtype=torch.int32)).any()


def _dup_edge_call(planes, dev, offset=0):
    """One launch of the content-dedup kernel on ``planes`` (NumPy), the
    bytes plane placed ``offset`` bytes past an aligned base; held to the
    plain version."""
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    t = {k: torch.from_numpy(v).to(dev) for k, v in planes.items()}
    if offset:
        nb = t["bytes"]
        buf = torch.empty(nb.numel() + offset, dtype=torch.uint8, device=dev)
        t["bytes"] = buf[offset:].view(nb.shape)
        t["bytes"].copy_(nb)
        assert t["bytes"].data_ptr() % 16 == offset % 16
    before = _cuda.LAUNCHES["content_dup"]
    got = ddp._content_dup(t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["content_dup"] == before + 1
    want = ddp._content_dup_plain({k: v.cpu() for k, v in t.items()})
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("E,R,W", [(4, 16, 20), (8, 24, 20), (6, 5, 7),
                                   (8, 5, 13), (8, 5, 20), (1, 3, 7),
                                   (4, 2, 13)], ids=str)
def test_content_dup_kernel_edges(E, R, W, offset):
    """The CPU tests' dedup edges (tests/test_torch_device_dispatch.py
    DUP_SHAPES: counts of -1 and R + 1, an all-zero lane, near repeats,
    rows of 7, 13 and 20 bytes) with the bytes' base 16-byte aligned, at 4
    and at 1 byte past it."""
    from torch_slice_cases import dup_edge_planes
    dev = _gpu()
    for plant in (True, False):
        planes = dup_edge_planes(E + R + W, B=9, J=13, E=E, R=R, W=W,
                                 plant=plant)
        want = _dup_edge_call(planes, dev, offset)
        if plant and E > 1:
            assert (want != torch.arange(E, dtype=torch.int32)).any()


@pytest.mark.parametrize("E", [16, 17, 32])
def test_content_dup_kernel_many_open_pairs(E):
    """Lanes whose events all share one count but differ (every pair open,
    up to 31 candidates an event: more than 16 open events take two
    rounds a candidate), beside lanes of equal events, and E = 32, a
    whole warp of events."""
    from torch_slice_cases import dup_edge_planes
    dev = _gpu()
    rng = np.random.default_rng(E)
    B, J, R, W = 3, 5, 2, 3
    planes = {"bytes": rng.integers(0, 2, (B, J, E, R, W)).astype(np.uint8),
              "num_rows": np.ones((B, J, E), np.int32),
              "bits_per_row": np.zeros((B, J, E, R), np.int32),
              "syncs": np.zeros((B, J, E, R), np.int32)}
    planes["bytes"][0] = 1
    want = _dup_edge_call(planes, dev)
    assert (want[0] == 0).all() and (want[1:] != 0).any()
    _dup_edge_call(dup_edge_planes(E, B=4, J=9, E=E, R=5, W=13), dev, 1)


def test_content_dup_kernel_raises_past_32_events():
    """A lane's events share one warp: more than 32 raise, no fallback."""
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from torch_slice_cases import dup_edge_planes
    dev = _gpu()
    planes = {k: torch.from_numpy(v).to(dev) for k, v in
              dup_edge_planes(3, B=1, J=2, E=33, R=2, W=3).items()}
    with pytest.raises(ValueError, match="warp"):
        ddp._content_dup(planes)


def test_gather_records_kernel_matches_plain():
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    dev = _gpu()
    planes = _dup_planes(3, dev)
    rng = np.random.default_rng(3)
    idx = [rng.integers(0, n, 40).astype(np.int32)
           for n in planes["bytes"].shape[:3]]
    before = _cuda.LAUNCHES["gather_records"]
    got = ddp._gather_records(planes["bytes"], planes["syncs"], *idx)
    assert _cuda.LAUNCHES["gather_records"] == before + 1
    want = ddp._gather_records_plain(
        planes["bytes"], planes["syncs"],
        *(torch.from_numpy(a.astype(np.int64)).to(dev) for a in idx))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.cpu().numpy())


def _gather_family(seed, dev, B, J, E, R, W, shift=0):
    """Slicer planes on the card, their bytes ``shift`` bytes past an
    aligned base (shift 1: no 16- or 4-byte path), and records that
    include every plane's last index."""
    from torch_slice_cases import dup_planes
    p = dup_planes(seed, B=B, J=J, E=E, R=R, W=W, plant=E > 1)
    flat = torch.zeros(p["bytes"].size + 16, dtype=torch.uint8, device=dev)
    by = flat[shift:shift + p["bytes"].size].view(B, J, E, R, W)
    by.copy_(torch.from_numpy(p["bytes"]))
    sy = torch.from_numpy(p["syncs"]).to(dev)
    return by, sy


@pytest.mark.parametrize("families", [1, 9])
def test_gather_records_batched_kernel_matches_plain(families):
    """One launch for every family: shapes that differ by family, W of 13
    and 7 (no aligned vector path) beside 20 and 40, a base one byte off,
    P per family not a multiple of 8 (one family with none), records at
    each plane's last index."""
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    dev = _gpu()
    shapes = [(3, 4, 6, 16, 20), (2, 5, 4, 16, 40), (4, 3, 8, 24, 20),
              (3, 2, 5, 5, 13), (1, 1, 1, 1, 1), (2, 3, 4, 7, 7),
              (5, 4, 3, 16, 20), (2, 2, 2, 3, 13), (3, 3, 3, 16, 40)]
    counts = [37, 13, 1, 29, 3, 0, 61, 5, 11]
    rng = np.random.default_rng(families)
    groups = []
    for f in range(families):
        B, J, E, R, W = shapes[f]
        by, sy = _gather_family(f, dev, B, J, E, R, W, shift=f % 2)
        P = counts[f] if families > 1 else 37
        idx = [rng.integers(0, n, P).astype(np.int32) for n in (B, J, E)]
        if P:
            for a, n in zip(idx, (B, J, E)):
                a[-1] = n - 1
        groups.append((by, sy, *idx))
    before = _cuda.LAUNCHES["gather_records"]
    got = ddp._gather_many(groups)
    assert _cuda.LAUNCHES["gather_records"] == before + 1
    want = ddp._gather_many_plain(groups)
    assert len(got) == len(want) == families
    for (gb, gs), (wb, ws) in zip(got, want):
        assert np.array_equal(gb, wb.cpu().numpy())
        assert np.array_equal(gs, ws.cpu().numpy())
    one = ddp._gather_records(*groups[0])
    assert _cuda.LAUNCHES["gather_records"] == before + 2
    assert np.array_equal(one[0], got[0][0]) \
        and np.array_equal(one[1], got[0][1])


def test_device_slicing_on_the_card_matches_cpu():
    """RtlTpu(device_slice=True) on the card: a fixture's events equal the
    CPU run's, through the slicer, dedup and gather kernels."""
    import os
    from rtl_433_tpu_torch.api import RtlTpu
    from rtl_433_tpu_torch.output.data_model import event_to_json
    dev = _gpu()
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "lacrosse_tx35", "g054_433.92M_250k.cu8")
    out = {}
    for d in ("cpu", dev):
        _cuda.reset_launches()
        rx = RtlTpu(device=d, device_slice=True, report_time="off")
        out[str(d)] = ([event_to_json(e) for e in rx.decode_file(path)],
                       dict(_cuda.LAUNCHES))
    (cpu, cl), (gpu, gl) = out["cpu"], out[str(dev)]
    assert cpu == gpu and cpu
    assert not any(cl.values())
    # an FSK capture: the FSK side's families
    for k in ("slice_pcm", "slice_pwm", "slice_mc", "content_dup",
              "gather_records", "decl_bank"):
        assert gl[k] > 0, k


# ---- time sharding: per-lane origins in csrc/frontend.cu and
# csrc/detector.cu, and csrc/timeshard.cu's chain and gather

def _segment_lanes(dev, D, C, S, seed):
    """A [D*C, S, 2] batch of segments (lane d*C + c) with OOK bursts, the
    lanes' block-frame origins and seeded front-end carries."""
    rng = np.random.default_rng(seed)
    iq = rng.integers(120, 136, (C, D * S, 2), dtype=np.uint8)
    for c in range(C):
        for s in range(300 + 11 * c, D * S - 900, 2300):
            iq[c, s:s + 700] = rng.integers(10, 246, (700, 2), dtype=np.uint8)
    lanes = torch.from_numpy(iq).view(C, D, S, 2).transpose(0, 1).reshape(
        D * C, S, 2).contiguous().to(dev)
    t0 = (torch.arange(D, dtype=torch.int32)[:, None] * S).expand(
        D, C).reshape(-1).contiguous().to(dev)
    st = torch.from_numpy(rng.integers(-100, 100, (6, D * C)).astype(
        np.int32)).to(dev)
    return lanes, t0, st


@pytest.mark.parametrize("D,C,nv_seg", [(8, 1, 5.5), (32, 1, 32),
                                        (4, 9, 2.25)])
def test_lane_origin_kernels_match_per_segment_plain(D, C, nv_seg):
    """The front end and the detector with a per-lane origin against their
    plain versions, one plain call per segment with a scalar t0; n_valid
    inside a segment, at the block's end, and over 32-lane groups."""
    dev = _gpu()
    S = 4096
    nv = int(nv_seg * S)
    iq, t0, st = _segment_lanes(dev, D, C, S, seed=D + C)
    alp1, blp = fe._coeffs(250_000, True, 0.0, False)
    kw = dict(use_mag_est=False, enable_fm=True, alp1=alp1, blp=blp,
              n_valid=nv, lane_t0=t0)
    got = fe.frontend_cuda(iq, st, **kw)
    torch.cuda.synchronize()
    want = fe.frontend_plain(iq, st, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))
    p = DetectorParams(fsk_minmax=False)
    state = detector_init(p, D * C, dev)
    regs = det.pack_regs(state)
    regs[det.REG_KEYS.index("lead_in")] = 2000
    gen0 = state["gen"].clone()
    args = (got[0], got[1], regs, gen0)
    before = _cuda.LAUNCHES["detector_scan"]
    dgot = det.detector_scan_cuda(*args, params=p, n_valid=nv, lane_t0=t0)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["detector_scan"] == before + 1
    dwant = det.detector_scan_plain(*args, params=p, n_valid=nv, lane_t0=t0)
    for g, w in zip(dgot, dwant):
        assert torch.equal(g, w)
    assert int((dgot[1] < det.KEY_INVALID).sum()) > 0


@pytest.mark.parametrize("seed,D,C", [(1, 8, 5), (2, 32, 40), (3, 1, 3),
                                      (4, 2, 300), (5, 32, 1), (6, 8, 4096),
                                      (7, 64, 33)])
def test_timeshard_chain_kernel_matches_plain(seed, D, C):
    from rtl_433_tpu_torch.ops import timeshard as ots
    from rtl_433_tpu_torch.parallel import timeshard as pts
    from torch_timeshard_cases import random_chain
    dev = _gpu()
    start, fin = random_chain(seed, D, C)
    _, rowinfo = ots.verify_layout(*pts._verify_keys(DetectorParams()),
                                   pts._COUNTER_KEYS)
    args = [torch.from_numpy(start), torch.from_numpy(fin), rowinfo]
    ratio = DetectorParams().ook_high_low_ratio
    before = _cuda.LAUNCHES["timeshard_chain"]
    got = ots.timeshard_chain_cuda(*(a.to(dev) for a in args), D=D,
                                   ratio=ratio)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["timeshard_chain"] == before + 1
    want = ots.timeshard_chain_plain(*args, D=D, ratio=ratio)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if D > 2:
        assert int(want[4][0]) == 1 and int(want[3].ne(0).sum()) > 0


# (8, 1, 8, 128, 2): the smoke's shape at D=8 (16-byte copies, two EOP
# chunks a run); G=2, 9, 7 and 33 and G*E = 6, 9, 21 and 66: runs not
# 16-byte aligned (G=33: a record run past 32 lanes, three EOP chunks);
# G=80: a last EOP chunk of 8 items; C=70: units over many CTAs
@pytest.mark.parametrize("D,C,R,G,E", [(8, 3, 8, 4, 2), (32, 1, 8, 32, 2),
                                       (1, 2, 4, 2, 3), (4, 70, 2, 9, 1),
                                       (8, 1, 8, 128, 2), (3, 5, 3, 7, 3),
                                       (2, 70, 8, 128, 2), (2, 3, 4, 33, 2),
                                       (2, 2, 2, 80, 2)])
def test_timeshard_gather_kernel_matches_plain(D, C, R, G, E):
    from rtl_433_tpu_torch.ops import timeshard as ots
    from torch_timeshard_cases import random_logs
    dev = _gpu()
    args = [torch.from_numpy(a) for a in random_logs(D + C, D, C, R, G, E)]
    before = _cuda.LAUNCHES["timeshard_gather"]
    got = ots.timeshard_gather_cuda(*(a.to(dev) for a in args), R=R)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["timeshard_gather"] == before + 1
    want = ots.timeshard_gather_plain(*args, R=R)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_timeshard_gather_kernel_unaligned_pointers():
    """Inputs and outputs that start 4 bytes past a 16-byte boundary (G and
    G*E multiples of 4): the scalar copies, equal to the plain version."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    from torch_timeshard_cases import random_logs
    dev = _gpu()
    D, C, R, G, E = 8, 2, 8, 32, 2
    args = [torch.from_numpy(a) for a in random_logs(11, D, C, R, G, E)]

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v
    ins = [shifted(a) for a in args[:4]] + [a.to(dev) for a in args[4:]]
    assert all(a.data_ptr() % 16 == 4 for a in ins[:4])
    want = ots.timeshard_gather_plain(*args, R=R)
    out = [shifted(torch.zeros_like(w)) for w in want]
    got = ots.timeshard_gather_cuda(*ins, R=R, out=out)
    torch.cuda.synchronize()
    for g, o, w in zip(got, out, want):
        assert g.data_ptr() == o.data_ptr()
        assert torch.equal(g.cpu(), w)


def _pair_case(seed, D, C, dev):
    """A chain (random_chain: links that fail for D > 2) and candidate logs
    of the same D and C, on the card."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    from rtl_433_tpu_torch.parallel import timeshard as pts
    from torch_timeshard_cases import random_chain, random_logs
    start, fin = random_chain(seed, D, C)
    _, rowinfo = ots.verify_layout(*pts._verify_keys(DetectorParams()),
                                   pts._COUNTER_KEYS)
    chain = [torch.from_numpy(start).to(dev), torch.from_numpy(fin).to(dev),
             rowinfo.to(dev)]
    logs = [torch.from_numpy(a).to(dev)
            for a in random_logs(seed, D, C, 8, 128, 2)[:4]]
    return chain, logs


@pytest.mark.parametrize("seed,D,C", [(1, 8, 1), (2, 32, 1), (3, 8, 70),
                                      (4, 1, 3)])
def test_timeshard_gather_behind_the_chain(seed, D, C):
    """The gather enqueued right behind the chain, as the step enqueues it,
    before any host read: with skip_if_bad on a chain that fails (D > 2)
    it writes nothing (the sentinel fill stays), on one that verifies
    (D=1) it equals the plain version; without skip_if_bad it gathers what
    the chain selected, also where the chain failed."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    dev = _gpu()
    chain, logs = _pair_case(seed, D, C, dev)
    ratio = DetectorParams().ook_high_low_ratio
    R = 8
    sentinel = -0x5a5a5a5b
    for skip in (True, False):
        sel, delta, _, _, bad = ots.timeshard_chain_cuda(*chain, D=D,
                                                         ratio=ratio)
        shapes = [(C * R, D * 128)] * 3 + [(C, D * 256, 9)]
        out = [torch.full(sh, sentinel, dtype=torch.int32, device=dev)
               for sh in shapes]
        got = ots.timeshard_gather_cuda(*logs, sel, delta, R=R,
                                        skip_if_bad=bad if skip else None,
                                        out=out)
        torch.cuda.synchronize()
        failed = int(bad[0]) != 0
        assert failed == (D > 2)
        want = ots.timeshard_gather_plain(*(a.cpu() for a in logs),
                                          sel.cpu(), delta.cpu(), R=R)
        for g, w in zip(got, want):
            if skip and failed:
                assert bool((g == sentinel).all())
            else:
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("seed,D,C", [(7, 8, 1), (8, 1, 70)])
def test_timeshard_gather_plain_launch(seed, D, C):
    """The gather as a plain launch (pdl=False, which the smoke times the
    kernel alone with) behind the chain: the same outputs as with PDL,
    nothing written behind a chain that fails (D > 2)."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    dev = _gpu()
    chain, logs = _pair_case(seed, D, C, dev)
    ratio = DetectorParams().ook_high_low_ratio
    sentinel = -0x5a5a5a5b
    sel, delta, _, _, bad = ots.timeshard_chain_cuda(*chain, D=D,
                                                     ratio=ratio)
    want = ots.timeshard_gather_plain(*(a.cpu() for a in logs), sel.cpu(),
                                      delta.cpu(), R=8)
    out = [torch.full_like(w, sentinel).to(dev) for w in want]
    got = ots.timeshard_gather_cuda(*logs, sel, delta, R=8, skip_if_bad=bad,
                                    out=out, pdl=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if D > 2:
            assert bool((g == sentinel).all())
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("debug", [False, True])
def test_timeshard_chain_gather_counts(debug):
    """timeshard_chain_gather on the card: one chain and one gather launch
    for a block that fails and one that verifies; the gather counts as
    copied where the block verified, or under debug (its logs then equal
    the plain version's on the chain's selection); a failed block without
    debug gives no logs."""
    from rtl_433_tpu_torch.ops import timeshard as ots
    dev = _gpu()
    ratio = DetectorParams().ook_high_low_ratio
    _cuda.reset_launches()
    for n, (seed, D) in enumerate(((5, 8), (6, 1)), 1):
        chain, logs = _pair_case(seed, D, 2, dev)
        (sel, delta, *_), ok, got = ots.timeshard_chain_gather(
            *chain, [(dev, lambda x: x, logs)], D=D, ratio=ratio, R=8,
            debug=debug)
        assert ok == (D == 1)
        assert _cuda.LAUNCHES["timeshard_chain"] == n
        assert _cuda.LAUNCHES["timeshard_gather"] == n
        if not ok and not debug:
            assert got is None
        else:
            want = ots.timeshard_gather_plain(*(a.cpu() for a in logs),
                                              sel.cpu(), delta.cpu(), R=8)
            for g, w in zip(got[0], want):
                assert torch.equal(g.cpu(), w)
    assert _cuda.LAUNCHES["timeshard_gather_copied"] == (2 if debug else 1)
    _cuda.reset_launches()
    assert _cuda.LAUNCHES["timeshard_gather_copied"] == 0


@pytest.mark.parametrize("D,cut", [(8, 0), (32, 0), (8, 40000)])
def test_timeshard_engine_on_the_card_matches_sequential(D, cut):
    """TimeShardEngine on Mesh([cuda] * D) over a three-block stream (a
    quiet block that verifies, then two blocks of packages longer than the
    halo, the last partial, that fall back): the sequential engine's
    packages, the same fallbacks and final state as the same engine on the
    CPU, and every kernel of the path launched."""
    _timeshard_engine_case(D, cut, lambda d: [torch.device(d)] * D)


# "one card": two groups of one card, [cuda:0] * 4 + [cuda] * 4 (and the
# CPU's two spellings for the CPU engine); "distinct": one segment on each
# of two GPUs, or of 4 or 8 where there are as many (skips with one)
@pytest.mark.parametrize("split,cut", [("one card", 0), ("one card", 40000),
                                       ("distinct", 0)])
def test_grouped_timeshard_engine_on_the_card_matches_sequential(split, cut):
    """The same stream through TimeShardEngine on a mesh of several
    groups: the sequential engine's packages, the CPU engine's fallbacks
    and final state."""
    _gpu()
    n = min(torch.cuda.device_count(), 8)
    if split == "distinct":
        if n < 2:
            pytest.skip("needs two GPUs: one segment per card")
        D = 1 << (n.bit_length() - 1)
        devices = lambda d: [torch.device(d, i) for i in range(D)] \
            if d == "cuda" else [torch.device(d), torch.device(d, 0)] * (
                D // 2)
    else:
        D = 8
        devices = lambda d: [torch.device(d, 0)] * 4 + [torch.device(d)] * 4
    _timeshard_engine_case(D, cut, devices)


def _timeshard_engine_case(D, cut, devices):
    """The three-block stream through the sequential engine, and through
    TimeShardEngine on the meshes ``devices("cuda")`` and
    ``devices("cpu")`` (D entries each): equal packages, fallbacks and
    final state, and every kernel of the path launched."""
    import synth
    from rtl_433_tpu_torch.parallel.sharding import Mesh, ShardedEngine
    from rtl_433_tpu_torch.parallel.timeshard import TimeShardEngine
    train = []
    for rep in range(6):
        train += synth.ppm_pulses("10110010", pulse_us=500, gap_zero_us=1000,
                                  gap_one_us=2000, reset_us=6000, repeats=2)
        train += [(0, 30_000)]
    iq = synth.synth_ook(train, rate=250_000, lead_in_us=20_000,
                         tail_us=60_000, seed=3)
    N = 131072
    iq = np.pad(iq, ((0, 2 * N - iq.shape[0]), (0, 0)),
                constant_values=128)[:2 * N - cut]
    quiet = synth.synth_ook([(0, 500_000)], rate=250_000,
                            lead_in_us=20_000, tail_us=20_000, seed=4)
    blocks = [(quiet[None, :N], N, False),
              (iq[None, :N], N, False),
              (np.pad(iq[None, N:], ((0, 0), (0, cut), (0, 0)),
                      constant_values=128), N - cut, True)]
    p = DetectorParams()
    dev = _gpu()
    mesh = lambda d: Mesh(devices(d), ("sp",), (D,))
    runs = {}
    _cuda.reset_launches()
    for name, eng in (
            ("seq", ShardedEngine(p, 1, Mesh([dev], ("ch",), (1,)))),
            ("gpu", TimeShardEngine(p, mesh=mesh("cuda"))),
            ("cpu", TimeShardEngine(p, mesh=mesh("cpu")))):
        pkgs = []
        for blk, nv, flush in blocks:
            eng.push(blk, n_valid=nv, flush=flush)
            pkgs += eng.take_packages()
        runs[name] = (pkgs, (getattr(eng, "fallbacks", None),
                             getattr(eng, "verified", None)),
                      {k: v.cpu() for k, v in eng.state.items()})
    for k in ("frontend", "detector_scan", "timeshard_chain",
              "timeshard_gather", "compact"):
        assert _cuda.LAUNCHES[k] > 0, k
    seq, gpu, cpu = runs["seq"], runs["gpu"], runs["cpu"]
    assert len(seq[0]) == len(gpu[0]) >= 6
    for a, b in zip(seq[0], gpu[0]):
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert gpu[1] == cpu[1]
    assert gpu[1][0] >= 1 and gpu[1][1] >= 1, gpu[1]
    for k in cpu[2]:
        assert torch.equal(gpu[2][k], cpu[2][k]), k


# ---- the declarative decode bank (csrc/decl_bank.cu) and the MIC digests
# (csrc/mic.cu)

@pytest.mark.parametrize("B,stale", [(2048, True), (1024, False), (5, True),
                                     (1, True)])
def test_decl_bank_kernel_matches_plain(B, stale):
    """The fuzz batch of tests/torch_decl_cases.py (every spec and stage),
    with stale bits below n_store or canonically zero-padded rows, and
    batches that leave a CTA partly empty."""
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from torch_decl_cases import fuzz_batch
    dev = _gpu()
    bank = get_runner().bank
    bits, n, sid, ns = fuzz_batch(3, max(B, 16))
    bits, n, sid, ns = bits[:B], n[:B], sid[:B], ns[:B]
    if not stale:
        bits = (bits * (np.arange(bank.in_bits) < n[:, None])).astype(
            np.uint8)
    args = [torch.from_numpy(a).to(dev) for a in (bits, n, sid)]
    nst = torch.from_numpy(ns).to(dev) if stale else None
    before = _cuda.LAUNCHES["decl_bank"]
    got = dbk.run_torch(bank, *args, nst)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decl_bank"] == before + 1
    want = dbk.run_torch_plain(bank, *args, nst)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)


def _planted_decl_batch(B, seed):
    """The fuzz batch with every third row replaced by a planted row of a
    Manchester, an invert or the widest-entry spec, and every seventh by
    a row whose alignment moves the frame before bit 0."""
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from torch_decl_cases import _planted, fuzz_batch
    bank = get_runner().bank
    bits, n, sid, ns = fuzz_batch(seed, max(B, 16))
    bits, n, sid, ns = bits[:B], n[:B].copy(), sid[:B].copy(), ns[:B].copy()
    start = dbk.sparse_tables(bank)[2]
    widest = int(np.argmax(np.diff(start)))
    picks = [s for s in range(bank.n_specs)
             if bank.transform[s] in (dbk.TF_MANCHESTER, dbk.TF_INVERT)]
    picks.append(widest)
    neg = [(s, int(ln)) for s in range(bank.n_specs)
           for ln, o in zip(bank.la_len[s], bank.la_off[s])
           if ln > 0 and o + bank.align_off[s] < 0 and bank.plen[s] == 0]
    rng = np.random.default_rng(seed)
    for i in range(0, B, 3):
        s = picks[(i // 3) % len(picks)]
        bits[i], n[i], ns[i] = _planted(bank, s, rng)
        sid[i] = s
    for i in range(1, B, 7):
        sid[i], n[i] = neg[(i // 7) % len(neg)]
        ns[i] = max(ns[i], n[i])
    return bank, bits, n, sid, ns


@pytest.mark.parametrize("B", [1, 33, 2460, 8192])
def test_decl_bank_sparse_kernel_matches_plain(B):
    """The kernel over the sparse entry lists at a lone candidate, a CTA
    and a bit, a dense_4096 drain's batch and the fuzz batch's size, with
    planted Manchester, invert, widest-entry and negative-offset rows:
    equal to the dense plain version and to the sparse emulation, one
    launch."""
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    dev = _gpu()
    bank, bits, n, sid, ns = _planted_decl_batch(B, 8)
    args = [torch.from_numpy(a).to(dev) for a in (bits, n, sid, ns)]
    before = _cuda.LAUNCHES["decl_bank"]
    got = dbk.run_torch(bank, *args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["decl_bank"] == before + 1
    want = dbk.run_torch_plain(bank, *args)
    emu = dbk.run_torch_sparse_plain(bank, *args)
    assert _cuda.LAUNCHES["decl_bank"] == before + 1
    for g, w, e in zip(got, want, emu):
        assert torch.equal(g, w) and torch.equal(g, e)
    if B > 1:
        assert (got[0] == 0).any()


def test_decl_bank_kernel_odd_rows():
    """Rows of 500 bits (not a multiple of 32) with n and n_store past
    them: the clamped reads of the JAX path."""
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from torch_decl_cases import fuzz_batch
    dev = _gpu()
    bank = get_runner().bank
    bits, n, sid, ns = fuzz_batch(4, 512)
    rng = np.random.default_rng(4)
    n = np.where(rng.random(512) < 0.2, rng.integers(500, 560, 512),
                 np.minimum(n, 500)).astype(np.int32)
    ns = np.maximum(ns, n).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (bits[:, :500], n, sid, ns)]
    got = dbk.run_torch(bank, *args[:3], args[3])
    torch.cuda.synchronize()
    want = dbk.run_torch_plain(bank, *args[:3], args[3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_decode_many_on_the_card_matches_host():
    from rtl_433_tpu_torch.bits.bitbuffer import BitBuffer
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.output.data_model import event_to_json
    from torch_decl_cases import oracle_items
    dev = _gpu()
    items = [(s, BitBuffer.parse(c)) for s, c in oracle_items()]
    norm = lambda r: [event_to_json(e) for e in r] \
        if isinstance(r, list) else repr(r)
    runner = get_runner()
    before = _cuda.LAUNCHES["decl_bank"]
    got = [norm(r) for r in runner.decode_many(items, device=dev)]
    assert _cuda.LAUNCHES["decl_bank"] == before + 1
    assert got == [norm(r) for r in runner.decode_many(items)]
    assert sum(isinstance(r, list) and bool(r) for r in got) > 50


# (digest, nbytes, parameters): the cases of tests/test_mic_kernels.py
MIC_CASES = ([("crc8", 4, 0x31, 0x00), ("crc8", 8, 0x31, 0xFF),
              ("crc8le", 7, 0x31, 0x00), ("crc8le", 5, 0x9C, 0x3D),
              ("crc16", 10, 0x8005, 0xFFFF), ("crc16", 6, 0x1021, 0x0000),
              ("crc16lsb", 9, 0x1021, 0xFFFF), ("crc16lsb", 4, 0x8810, 0),
              ("lfsr_digest8", 5, 0x98, 0xF1),
              ("lfsr_digest8_reverse", 7, 0x83, 0x7A),
              ("lfsr_digest8_reflect", 9, 0x31, 0xF4),
              ("lfsr_digest16", 11, 0x8810, 0x0ACC)]
             + [(f, n) for f in ("xor_bytes", "add_bytes", "add_nibbles",
                                 "parity_bytes") for n in (0, 7, 13)])


@pytest.mark.parametrize("case", MIC_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mic_kernel_matches_plain_and_host(case):
    from rtl_433_tpu_torch.bits import util
    from rtl_433_tpu_torch.ops import mic
    dev = _gpu()
    name, nbytes, *params = case
    fn, plain = mic.DIGESTS[name]
    rng = np.random.default_rng(nbytes)
    msgs = rng.integers(0, 256, (3, 257, 15), dtype=np.uint8)
    high = msgs.astype(np.int32) + (rng.integers(-9, 9, msgs.shape)
                                    << 8).astype(np.int32)
    host = np.array([getattr(util, name)(bytes(m), nbytes, *params)
                     for m in msgs.reshape(-1, 15)]).reshape(3, 257)
    for m in (msgs, high):
        t = torch.from_numpy(m).to(dev)
        before = _cuda.LAUNCHES[f"mic_{name}"]
        got = fn(t, nbytes, *params)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[f"mic_{name}"] == before + 1
        assert got.dtype == torch.int32 and got.shape == (3, 257)
        assert torch.equal(got, plain(t, nbytes, *params))
        assert np.array_equal(got.cpu().numpy(), host)
    # array-like input goes to the card; shapes [] and [0]
    assert fn(msgs[0, 0], nbytes, *params).device.type == "cuda"
    assert int(fn(msgs[0, 0], nbytes, *params)) == host[0, 0]
    assert fn(msgs[:0, 0], nbytes, *params).shape == (0,)


def _mic_check(name, t, nbytes, params, host_rows):
    """One launch of digest ``name`` on ``t``, bit-exact against the plain
    version and against bits/util.py on ``host_rows`` (uint8 [n, B])."""
    from rtl_433_tpu_torch.bits import util
    from rtl_433_tpu_torch.ops import mic
    fn, plain = mic.DIGESTS[name]
    before = _cuda.LAUNCHES[f"mic_{name}"]
    got = fn(t, nbytes, *params)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[f"mic_{name}"] == before + 1
    assert torch.equal(got, plain(t, nbytes, *params))
    host = [getattr(util, name)(bytes(m), nbytes, *params)
            for m in host_rows]
    assert got.reshape(-1).cpu().tolist() == host


MIC_SHAPE_CASES = [("crc8", 14, 0x2F, 0x00), ("crc8le", 5, 0x9C, 0x3D),
                   ("crc16", 14, 0x8005, 0xFFFF),
                   ("crc16lsb", 9, 0x1021, 0xFFFF),
                   ("lfsr_digest8", 9, 0x31, 0xF4),
                   ("lfsr_digest8_reverse", 7, 0x83, 0x7A),
                   ("lfsr_digest8_reflect", 9, 0x31, 0xF4),
                   ("lfsr_digest16", 11, 0x8810, 0x0ACC),
                   ("xor_bytes", 13), ("add_bytes", 16), ("add_nibbles", 1),
                   ("parity_bytes", 15)]


@pytest.mark.parametrize("layout", ["stride16_aligned", "stride15",
                                    "int32", "int32_offset", "offset_view",
                                    "wide_rows"])
@pytest.mark.parametrize("case", MIC_SHAPE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mic_kernel_row_paths(case, layout):
    """Each way the kernel reads its rows: uint8 rows of stride 16 on an
    aligned base (16-byte row loads), stride 15 (single loads), int32 rows
    (read & 0xFF: 16-byte loads on an aligned base, single loads one int
    off it), an offset view made contiguous (unaligned, single loads), and
    rows of 81 bytes (single loads); 4099 rows, so that the last tile is
    ragged."""
    dev = _gpu()
    name, nbytes, *params = case
    B = {"stride15": 15, "wide_rows": 81}.get(layout, 16)
    nbytes = min(nbytes, B)
    rng = np.random.default_rng(len(name) * 100 + B)
    msgs = rng.integers(0, 256, (4099, B), dtype=np.uint8)
    if layout.startswith("int32"):
        t = torch.from_numpy(msgs.astype(np.int32) + (rng.integers(
            -9, 9, msgs.shape) << 8).astype(np.int32)).to(dev)
        if layout == "int32_offset":
            t = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(
                4099, B)
            assert t.data_ptr() % 16 == 4
    elif layout == "offset_view":
        flat = torch.from_numpy(msgs.reshape(-1)).to(dev)
        t = torch.cat([flat[:3], flat])[3:].view(4099, B)
        assert t.is_contiguous() and t.data_ptr() % 16 == 3
    else:
        t = torch.from_numpy(msgs).to(dev)
    if layout == "stride16_aligned":
        assert t.data_ptr() % 16 == 0 and t.stride(0) == 16
    _mic_check(name, t, nbytes, params, msgs)


@pytest.mark.parametrize("name", ["lfsr_digest8", "lfsr_digest8_reverse",
                                  "lfsr_digest8_reflect", "lfsr_digest16",
                                  "crc8", "crc16lsb", "add_nibbles"])
@pytest.mark.parametrize("B", [112, 133])
def test_mic_kernel_past_one_table_chunk(name, B):
    """nbytes past MIC_CHUNK: the LFSR digests walk their position tables
    in chunks (every tile reloading them), on aligned rows of 112 bytes
    and unaligned rows of 133; 600 rows."""
    from rtl_433_tpu_torch.ops import mic
    dev = _gpu()
    nbytes = mic.MIC_CHUNK + 37
    params = {"crc8": (0x31, 0x00), "crc16lsb": (0x8005, 0xFFFF),
              "lfsr_digest16": (0x8810, 0x5412),
              "add_nibbles": ()}.get(name, (0x98, 0xF1))
    msgs = np.random.default_rng(B).integers(0, 256, (600, B),
                                             dtype=np.uint8)
    _mic_check(name, torch.from_numpy(msgs).to(dev), nbytes, params, msgs)


def test_mic_tensor_is_not_moved():
    from rtl_433_tpu_torch.ops import mic
    dev = _gpu()
    msgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (64, 9), dtype=np.uint8))
    on_card = msgs.to(dev)
    assert torch.equal(mic.crc16(on_card, 9, 0x1021, 0, device="cuda"),
                       mic.crc16(on_card, 9, 0x1021, 0))
    with pytest.raises(ValueError, match="not moved"):
        mic.crc16(msgs, 9, 0x1021, 0, device="cuda")
    with pytest.raises(ValueError, match="not moved"):
        mic.crc16(on_card, 9, 0x1021, 0, device="cpu")


def _replay(argv):
    """The port's CLI in this process, clock pinned: (rc, stdout, stderr)."""
    from rtl_433_tpu_torch import cli
    from torch_replay_cases import run_cli
    return run_cli(cli.main, argv)


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx35", 75)])
def test_flex_device_slice_replay_matches_cpu(name, num):
    """A -X flex decoder made from a protocol's timings, alone, with
    -Y deviceslice on the card: the same bytes as --device cpu, and the
    slicer kernels launched."""
    _gpu()
    from rtl_433_tpu_torch.decoders import Registry
    from rtl_433_tpu_torch.decoders.flex import MODULATIONS
    from torch_replay_cases import fixture, flex_spec
    spec = flex_spec(Registry().get(num), MODULATIONS, name=f"flex_{name}")
    argv = ["-R", "0", "-X", spec, "-r", fixture(name), "-F", "json", "-Y",
            "deviceslice"]
    _cuda.reset_launches()
    got = _replay(argv)
    assert sum(v for k, v in _cuda.LAUNCHES.items()
               if k.startswith("slice_")) > 0
    assert got == _replay(argv + ["--device", "cpu"])
    assert got[0] == 0 and f'"flex_{name}"' in got[1]


def test_sigmf_replay_matches_cpu(tmp_path):
    """A capture written as SigMF replays on the card to the bytes of
    --device cpu and of the capture's own replay."""
    _gpu()
    from rtl_433_tpu_torch.io import load_iq, sigmf
    from torch_replay_cases import fixture
    path = fixture("lacrosse_tx35")
    sm = str(tmp_path / "tx35.sigmf")
    sigmf.write(sm, load_iq(path, "cu8"), 250_000, 433_920_000)
    argv = ["-R", "75", "-r", sm, "-F", "json", "-M", "level"]
    got = _replay(argv)
    assert got == _replay(argv + ["--device", "cpu"])
    assert got == _replay(["-R", "75", "-r", path, "-F", "json", "-M",
                           "level"])
    assert got[0] == 0 and "LaCrosse" in got[1]


def _live_cli(blocks, argv):
    """cli.main -d against a loopback server of ``blocks``, clock pinned:
    ((rc, stdout, stderr), the commands the server received)."""
    from torch_live_cases import LoopbackRtlTcp
    srv = LoopbackRtlTcp(blocks)
    srv.start()
    res = _replay(["-d", srv.device] + argv)
    srv.join(timeout=60)
    return res, srv.commands


def test_live_decode_matches_cpu():
    """Live input over rtl_tcp on the card, the default registration: the
    same output and tuner commands as --device cpu, and every block
    through the front-end and detector kernels."""
    _gpu()
    from rtl_433_tpu_torch.io import load_iq
    from torch_live_cases import stream_blocks
    from torch_replay_cases import fixture
    iq = np.concatenate([load_iq(fixture(n), "cu8")
                         for n in ("nexus", "lacrosse_tx35")])
    blocks = stream_blocks(iq)
    argv = ["-F", "json", "-M", "level"]
    _cuda.reset_launches()
    got = _live_cli(blocks, argv)
    assert _cuda.LAUNCHES["frontend"] == len(blocks)
    assert _cuda.LAUNCHES["detector_scan"] == len(blocks)
    assert got == _live_cli(blocks, argv + ["--device", "cpu"])
    assert got[0][0] == 0 and "Nexus-TH" in got[0][1] \
        and "LaCrosse" in got[0][1]


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx35", 75)])
def test_stream_dumps_match_cpu(name, num, tmp_path):
    """The am.s16/fm.s16 dumps of a capture (FM off for nexus, on for
    lacrosse_tx35): the card's, from the front-end kernel's outputs, equal
    the CPU's, from the plain front end."""
    _gpu()
    from torch_live_cases import read_dumps
    from torch_replay_cases import fixture
    out = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        d.mkdir()
        res = _replay(["-R", str(num), "-r", fixture(name), "-F", "json",
                       "-w", str(d / "dump.am.s16"), "-w",
                       str(d / "dump.fm.s16"), "--device", device])
        out[device] = res, read_dumps(str(d))
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0][0] == 0
    assert len(out["cuda"][1]["dump.am.s16"]) > 0


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx35", 75)])
def test_network_outputs_match_cpu(name, num, tmp_path):
    """Every network output but mqtts (-F syslog, mqtt, influx, trigger,
    http) and -K FILE and -K gpsd against loopback stubs: the card's run
    gives --device cpu's bytes at every stub and on stdout and stderr,
    and every block goes through the front-end and detector kernels."""
    _gpu()
    from rtl_433_tpu_torch import cli
    from torch_output_cases import run_network_cli
    from torch_replay_cases import fixture
    argv = ["-R", str(num), "-r", fixture(name), "-F", "json"]
    _cuda.reset_launches()
    got = run_network_cli(cli.main, argv, str(tmp_path / "cuda"))
    assert _cuda.LAUNCHES["frontend"] > 0
    assert _cuda.LAUNCHES["detector_scan"] == _cuda.LAUNCHES["frontend"]
    want = run_network_cli(cli.main, argv + ["--device", "cpu"],
                           str(tmp_path / "cpu"))
    # device_info names where each run's receiver is
    assert got[1]["http"][0].pop("device_info")["driver"] == "cuda"
    assert want[1]["http"][0].pop("device_info")["driver"] == "cpu"
    assert got == want
    (rc, out, _), seen = got
    assert rc == 0 and out and seen["syslog"] and seen["mqtt"]
    assert seen["influx"] and seen["trigger"] and seen["http"][0]["ws"]


@pytest.mark.parametrize("name,num", [("nexus", 19), ("lacrosse_tx35", 75),
                                      ("lacrosse_tx141x", 73)])
def test_analyzer_matches_cpu(name, num):
    """-A on the card: the analyzer's text on stderr equals --device
    cpu's."""
    _gpu()
    from torch_replay_cases import fixture
    argv = ["-R", str(num), "-r", fixture(name), "-A"]
    got = _replay(argv)
    assert got == _replay(argv + ["--device", "cpu"])
    assert got[0] == 0 and "Guessing modulation: " in got[2]


def test_locked_retune_against_a_running_run_live():
    """A thread retunes (frequency, rate, gain, ppm, hop interval, the
    protocol verb) in a loop while run_live decodes on the card: nothing
    raises, and every block ran under one set of parameters, the ones its
    detector params were built for."""
    dev = _gpu()
    import threading
    import time

    from rtl_433_tpu_torch import api as tapi
    from rtl_433_tpu_torch.output.http_server import HttpServerSink
    from torch_live_cases import BLOCK, LoopbackRtlTcp
    rx = tapi.RtlTpu(register_all=False, device=dev)
    rx.registry.register(19)
    rx.registry.register(75)
    snap = lambda: (rx.sample_rate, rx.center_frequency, rx.fsk_minmax,
                    rx.gain_db, rx.ppm_error,
                    tuple(d.num for d in rx.registry.active))
    blocks = []
    real = rx._push_block

    def inner(iq, flush):
        start = snap()
        out = real(iq, flush)
        blocks.append((start, snap(), rx._params))
        return out

    rx._push_block = inner
    verbs = HttpServerSink.__new__(HttpServerSink)
    verbs.receiver = rx
    stop, errors = threading.Event(), []

    def retuner():
        i = 0
        try:
            while not stop.is_set():
                i += 1
                rx.set_frequency((433_920_000, 868_300_000)[i % 2])
                rx.set_sample_rate((250_000, 1_024_000)[(i // 2) % 2])
                rx.set_gain((None, 20.0)[i % 2])
                rx.set_ppm_error(i % 5)
                rx.set_hop_interval(1 + i % 3)
                verbs.handle_cmd("protocol", -75 if i % 2 else 75)
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    rng = np.random.default_rng(9)
    srv = LoopbackRtlTcp([rng.integers(118, 138, (BLOCK, 2), np.uint8)
                          for _ in range(12)])
    srv.start()
    t = threading.Thread(target=retuner, daemon=True)
    t.start()
    try:
        rx.run_live(srv.device, block_samples=BLOCK, watchdog_interval=60)
    finally:
        stop.set()
        t.join(30)
        srv.join(30)
    torch.cuda.synchronize()
    assert not errors and rx.exit_code == 0 and len(blocks) == 12
    for start, end, params in blocks:
        assert start == end
        assert (params.sample_rate, params.fsk_minmax) == start[0:3:2]


# ---- the launch device: every wrapper launches under its tensors' device

def _launch_call(name, dev):
    """One small call of the wrapper that launches kernel ``name``, with
    every tensor on ``dev``."""
    from rtl_433_tpu_torch.decoders import device_dispatch as ddp
    from rtl_433_tpu_torch.decoders.declarative import get_runner
    from rtl_433_tpu_torch.ops import decode_bank as dbk
    from rtl_433_tpu_torch.ops import mic
    from rtl_433_tpu_torch.ops import slice as sl
    from rtl_433_tpu_torch.ops import timeshard as ots
    from torch_decl_cases import fuzz_batch
    from torch_slice_cases import BANK_CAPS
    rng = np.random.default_rng(11)
    p = DetectorParams()
    if name in ("frontend", "detector_scan"):
        lanes, t0, st = _segment_lanes(dev, 2, 3, 4096, 11)
        alp1, blp = fe._coeffs(250_000, True, 0.0, False)
        kw = dict(use_mag_est=False, enable_fm=True, alp1=alp1, blp=blp,
                  n_valid=2 * 4096)
        if name == "frontend":
            return lambda: fe.frontend_cuda(lanes, st, lane_t0=t0, **kw)
        am, fm = fe.frontend_plain(lanes.cpu(), st.cpu(), lane_t0=t0.cpu(),
                                   **kw)[:2]
        regs = det.pack_regs(detector_init(p, 6, dev))
        gen0 = torch.zeros(6, dtype=torch.int32, device=dev)
        return lambda: det.detector_scan_cuda(
            am.to(dev), fm.to(dev), regs, gen0, params=p, n_valid=2 * 4096,
            lane_t0=t0)
    if name == "compact":
        ins = [torch.from_numpy(a).to(dev)
               for a in _compact_ins(rng, 5, 8, 13, 8)]
        return lambda: cmp.compact_packages_cuda(*ins, 7)
    if name == "slice_pwm":
        args, bounds = _slice_inputs("pwm", 5, 8, dev)
        return lambda: sl.slice_cuda("pwm", *args, bounds, BANK_CAPS["pwm"])
    if name == "content_dup":
        planes = _dup_planes(1, dev)
        return lambda: ddp._content_dup(planes)
    if name == "gather_records":
        planes = _dup_planes(3, dev)
        idx = [rng.integers(0, n, 9).astype(np.int32)
               for n in planes["bytes"].shape[:3]]
        return lambda: ddp._gather_records(planes["bytes"], planes["syncs"],
                                           *idx)
    if name in ("timeshard_chain", "timeshard_gather"):
        chain, logs = _pair_case(1, 8, 2, dev)
        ratio = p.ook_high_low_ratio
        if name == "timeshard_chain":
            return lambda: ots.timeshard_chain_cuda(*chain, D=8, ratio=ratio)
        sel, delta = (torch.from_numpy(rng.integers(0, 3, (8, 2)).astype(
            np.int32)).to(dev) for _ in range(2))
        return lambda: ots.timeshard_gather_cuda(*logs, sel, delta, R=8)
    if name == "decl_bank":
        bits, n, sid, ns = (torch.from_numpy(a).to(dev)
                            for a in fuzz_batch(3, 16))
        return lambda: dbk.run_torch(get_runner().bank, bits, n, sid, ns)
    assert name == "mic_crc16"
    msgs = torch.from_numpy(rng.integers(0, 256, (64, 9),
                                         dtype=np.uint8)).to(dev)
    return lambda: mic.crc16(msgs, 9, 0x1021, 0)


LAUNCH_WRAPPERS = ("frontend", "detector_scan", "compact", "slice_pwm",
                   "content_dup", "gather_records", "timeshard_chain",
                   "timeshard_gather", "decl_bank", "mic_crc16")


@pytest.mark.parametrize("name", LAUNCH_WRAPPERS)
def test_every_wrapper_launches_on_its_tensors_device(name, monkeypatch):
    """Each launch enters the device of its tensors through
    ``_cuda.launch_device`` once: on the host's last GPU, which is not the
    current device where there are two or more, the device current during
    the launch is that GPU, and the one current before is current again
    after it."""
    import contextlib
    _gpu()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    call = _launch_call(name, dev)
    real = _cuda.launch_device
    entered = []

    @contextlib.contextmanager
    def spy(t):
        with real(t):
            entered.append((t.device, torch.cuda.current_device()))
            yield
    monkeypatch.setattr(_cuda, "launch_device", spy)
    current = torch.cuda.current_device()
    before = _cuda.LAUNCHES[name]
    call()
    torch.cuda.synchronize(dev)
    assert _cuda.LAUNCHES[name] == before + 1
    assert entered == [(dev, dev.index)]
    assert torch.cuda.current_device() == current


def test_a_launch_across_devices_raises():
    """A launch whose tensors lie on two devices raises ValueError, copies
    nothing and counts no launch: on two GPUs where the host has them,
    else on a CUDA and a CPU tensor; a launch on the current device
    switches nothing."""
    from rtl_433_tpu_torch.ops import mic, timeshard
    dev = _gpu()
    other = torch.device("cuda", 1) if torch.cuda.device_count() > 1 \
        else torch.device("cpu")
    a = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda.launch_device(a.cpu())
    msgs = torch.zeros((8, 4), dtype=torch.uint8, device=dev)
    table = mic._device_table("crc8", 0, 0x31, 0, dev).to(other)
    before = _cuda.LAUNCHES["mic_crc8"]
    with pytest.raises(ValueError, match="device"):
        mic._launch("crc8", msgs, 4, table=table)
    assert _cuda.LAUNCHES["mic_crc8"] == before
    start = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    fin = torch.zeros((4, 6), dtype=torch.int32, device=other)
    before = _cuda.LAUNCHES["timeshard_chain"]
    with pytest.raises(ValueError, match="device"):
        timeshard.timeshard_chain_cuda(start, fin, a, D=2, ratio=8)
    assert _cuda.LAUNCHES["timeshard_chain"] == before
    with torch.cuda.device(a.device):
        assert _cuda.launch_device(a) is _cuda._CURRENT

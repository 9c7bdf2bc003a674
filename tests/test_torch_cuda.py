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


@pytest.mark.parametrize("fam", ["ppm", "pcm", "dmc"])
def test_slice_kernel_long_trains(fam):
    """Trains of hundreds of pulses (the symbol families walk twice as
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
                                      (4, 2, 300)])
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


@pytest.mark.parametrize("D,C,R,G,E", [(8, 3, 8, 4, 2), (32, 1, 8, 32, 2),
                                       (1, 2, 4, 2, 3), (4, 70, 2, 9, 1)])
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


@pytest.mark.parametrize("D,cut", [(8, 0), (32, 0), (8, 40000)])
def test_timeshard_engine_on_the_card_matches_sequential(D, cut):
    """TimeShardEngine on Mesh([cuda] * D) over a three-block stream (a
    quiet block that verifies, then two blocks of packages longer than the
    halo, the last partial, that fall back): the sequential engine's
    packages, the same fallbacks and final state as the same engine on the
    CPU, and every kernel of the path launched."""
    import synth
    from rtl_433_tpu_torch.parallel.sharding import Mesh, ShardedEngine
    from rtl_433_tpu_torch.parallel.timeshard import TimeShardEngine
    dev = _gpu()
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
    mesh = lambda d: Mesh([torch.device(d)] * D, ("sp",), (D,))
    runs = {}
    _cuda.reset_launches()
    for name, eng in (
            ("seq", ShardedEngine(p, 1, Mesh([dev], ("ch",), (1,)))),
            ("gpu", TimeShardEngine(p, mesh=mesh(dev))),
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

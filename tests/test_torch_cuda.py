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

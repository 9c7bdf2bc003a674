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

"""Seeded inputs for the time-shard chain and gather (ops/timeshard.py),
shared by tests/test_torch_timeshard.py (the plain versions against the
JAX package's code) and tests/test_torch_cuda.py (the kernels against the
plain versions). Imports neither jax nor the JAX package.
"""

import numpy as np

from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.ops import detector as det
from rtl_433_tpu_torch.ops import timeshard as ots
from rtl_433_tpu_torch.parallel import timeshard as pts


def random_chain(seed, D, C):
    """Seeded start/fin register sets in the port's lane layout, each link
    built to verify (the next start is the predecessor's selected final,
    with low_est moved by the hedge), then planted mismatches: per link a
    random share of channels with one key of each class off (an always
    key; an open key, caught only while the predecessor is open; low_est
    by 2; high_est; a counter, never caught). Returns numpy start
    [NROW, D*C] and fin [NROW, 3*D*C]."""
    rng = np.random.default_rng(seed)
    NROW = ots.NROW
    rows = {k: i for i, k in enumerate(ots.TS_KEYS)}
    ratio = te.DetectorParams().ook_high_low_ratio
    fin = rng.integers(-3000, 3000, (NROW, 3, D, C)).astype(np.int32)
    fin[rows["ook_state"]] = rng.choice([0, 0, 1, 3], (D, C))
    fin[rows["min_high"]] = rng.integers(100, 400, (D, C))
    fin[rows["low_est"]] = rng.integers(0, 40, (D, C)) + \
        np.arange(-1, 2)[:, None, None]
    idle = fin[rows["ook_state"]] == 0
    fin[rows["high_est"]] = np.where(
        idle, np.maximum(ratio * fin[rows["low_est"]],
                         fin[rows["min_high"]]), fin[rows["high_est"]])
    start = np.zeros((NROW, D, C), np.int32)
    start[:, 0] = rng.integers(-3000, 3000, (NROW, C))
    always = [k for k in pts._VERIFY_ALWAYS if k in rows
              and k not in ("low_est", "high_est")]
    opened = ["plen", "num", "f1", "vmax", "hist_p2", "hist_g0"]
    sel = np.ones(C, np.int64)
    for d in range(1, D):
        prev = fin[:, sel, d - 1, np.arange(C)]
        sel = rng.integers(0, 3, C)
        st = prev.copy()
        st[rows["low_est"]] = prev[rows["low_est"]] - (sel - 1)
        for c in range(C):
            u = rng.random(5)
            if u[0] < 0.15:
                st[rows[rng.choice(always)], c] += 1
            if u[1] < 0.3:
                st[rows[rng.choice(opened)], c] += 5
            if u[2] < 0.1:
                st[rows["low_est"], c] += 2
            if u[3] < 0.1:
                st[rows["high_est"], c] += 1
            if u[4] < 0.5:
                st[rows[rng.choice(pts._COUNTER_KEYS)], c] -= 7
        start[:, d] = st
    return (start.reshape(NROW, D * C),
            fin.reshape(NROW, 3 * D * C))


def random_logs(seed, D, C, R, G, E):
    """Candidate-lane logs for timeshard_gather: key3/p3/g3 [3*D*C*R, G]
    (40% invalid keys), eop3 [3*D*C, G*E, 9] (a third of the EOPs
    empty), sel and delta [D, C]; all int32 numpy."""
    rng = np.random.default_rng(seed)
    L3 = 3 * D * C
    key3 = rng.integers(0, 1 << 20, (L3 * R, G)).astype(np.int32)
    key3[rng.random(key3.shape) < 0.4] = det.KEY_INVALID
    p3 = rng.integers(0, 5000, (L3 * R, G)).astype(np.int32)
    g3 = rng.integers(0, 5000, (L3 * R, G)).astype(np.int32)
    eop3 = rng.integers(-100, 100000, (L3, G * E, 9)).astype(np.int32)
    eop3[:, :, det.M_TYPE] = rng.choice([0, 0, 1, 2], (L3, G * E))
    sel = rng.integers(0, 3, (D, C)).astype(np.int32)
    delta = rng.integers(-3, 50, (D, C)).astype(np.int32)
    return key3, p3, g3, eop3, sel, delta

"""Helpers for the port-vs-JAX parity tests (tests/test_torch_*.py).

Runs one block through the JAX package's ``process_block`` (jit, the
non-Pallas path) and through the port's on the CPU, from the same state,
and compares the whole state dict key by key.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rtl_433_tpu.dsp import engine as je
from rtl_433_tpu_torch.dsp import engine as te
from rtl_433_tpu_torch.dsp.convert import (params_from_jax, state_from_numpy,
                                           state_to_numpy)

_JIT = {}


def jax_block(params):
    fn = _JIT.get(params)
    if fn is None:
        fn = jax.jit(functools.partial(je.process_block, params),
                     static_argnames=("flush",))
        _JIT[params] = fn
    return fn


def pad_block(iq, chunk=128):
    """[N, 2] or [C, N, 2] cu8 -> [C, N', 2] padded with 128 to a chunk
    multiple, and the real length N."""
    if iq.ndim == 2:
        iq = iq[None]
    n = iq.shape[1]
    pad = (-n) % chunk
    return np.pad(iq, ((0, 0), (0, pad), (0, 0)), constant_values=128), n


def run_both(params, iq, n_valid=None, flush=False, state=None):
    """One block through both engines from ``state`` (numpy dict, or a
    fresh detector_init). Returns (jax_state, port_state, jax_avg,
    port_avg) with states as numpy dicts."""
    C = iq.shape[0]
    if state is None:
        state = {k: np.asarray(v)
                 for k, v in je.detector_init(params, C).items()}
    js, javg = jax_block(params)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(iq),
        None if n_valid is None else jnp.int32(n_valid), flush=flush)
    ts, tavg = te.process_block(params_from_jax(params),
                                state_from_numpy(state, "cpu"),
                                torch.from_numpy(np.ascontiguousarray(iq)),
                                n_valid, flush=flush)
    return ({k: np.asarray(v) for k, v in js.items()}, state_to_numpy(ts),
            np.asarray(javg), tavg.numpy())


def assert_same_state(js, ts):
    assert sorted(js) == sorted(ts)
    for k in js:
        assert ts[k].dtype == np.int32, k
        assert ts[k].shape == js[k].shape, k
        assert np.array_equal(js[k], ts[k]), k


def check_block(params, iq, n_valid=None, flush=False, state=None):
    """run_both + full-state and avg_db comparison; returns the states."""
    js, ts, javg, tavg = run_both(params, iq, n_valid, flush, state)
    assert_same_state(js, ts)
    assert np.allclose(javg, tavg, atol=1e-4)
    return js, ts

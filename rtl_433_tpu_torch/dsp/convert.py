"""Carry detector configuration and state across from the JAX package.

Used to start both packages from the same mid-stream state. Takes and
gives plain Python values and numpy arrays only, so nothing here imports
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import DetectorParams


def params_from_jax(p) -> DetectorParams:
    """The port's DetectorParams from a JAX DetectorParams (its
    ``_asdict()``)."""
    return DetectorParams(**p._asdict())


def state_from_numpy(d: dict, device="cuda") -> dict:
    """A detector-state dict of numpy arrays -> int32 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v).astype(np.int32),
                               device=device).clone()
            for k, v in d.items()}


def state_to_numpy(state: dict) -> dict:
    """The port's detector state -> a dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}

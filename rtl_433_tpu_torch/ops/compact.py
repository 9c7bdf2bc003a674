"""Package compaction: the CUDA kernel's wrapper and its plain version.

Gathers every published package slot of every channel into dense
``[cap, ...]`` rows, in the order of ``take_packages`` (channel-major, then
slot), so that one small transfer replaces pulling the whole
``[C, S, max_pulses]`` buffers to the host. The contract is the JAX
engine's ``compact_packages``, to the integer:

- ``v[c] = clamp(out_n[c], 0, S)`` valid slots per channel;
- ``pulse``, ``gap`` ``[cap, P]`` and ``meta`` ``[cap, F]``: the whole rows
  of the first ``min(count, cap)`` valid slots, all zeros after them;
- ``channel`` ``[cap]``: the row's channel, -1 in padding rows;
- ``count``: the number of valid slots, which may exceed ``cap``.

The four row outputs are views of one int32 buffer, ``rows`` ``[cap, W]``
(pulse, gap, meta, channel, then zeros to a 16-byte stride), so that the
kept rows reach the host in one copy.

:func:`compact_packages` launches ``csrc/compact.cu`` for CUDA tensors and
runs :func:`compact_packages_plain` for CPU tensors. All tensors are int32.
"""

from __future__ import annotations

import torch

from . import _cuda


def _check(out_n, out_p, out_g, out_meta, cap):
    if out_p.dim() != 3 or out_g.shape != out_p.shape:
        raise ValueError("compact: out_p and out_g must be [C, S, P]")
    C, S, _ = out_p.shape
    if out_n.shape != (C,) or out_meta.dim() != 3 \
            or out_meta.shape[:2] != (C, S):
        raise ValueError("compact: out_n must be [C] and out_meta [C, S, F]")
    if any(t.dtype != torch.int32 for t in (out_n, out_p, out_g, out_meta)):
        raise ValueError("compact: every input must be int32")
    if int(cap) < 1:
        raise ValueError(f"compact: cap must be at least 1, not {cap}")


def _width(P, F):
    """The row stride of the packed buffer: pulse, gap, meta and the
    channel, rounded up to 16 bytes so that every row's planes stay
    aligned for the kernel's int4 copies."""
    return -(-(2 * P + F + 1) // 4) * 4


def _views(rows, count, P, F):
    return {"pulse": rows[:, :P], "gap": rows[:, P:2 * P],
            "meta": rows[:, 2 * P:2 * P + F], "channel": rows[:, 2 * P + F],
            "count": count.reshape(()), "rows": rows}


def compact_packages_plain(out_n, out_p, out_g, out_meta, cap: int) -> dict:
    """Plain version of the kernel (boolean mask and advanced indexing)."""
    _check(out_n, out_p, out_g, out_meta, cap)
    C, S, P = out_p.shape
    F = out_meta.shape[2]
    dev = out_p.device
    v = out_n.clamp(0, S)
    valid = (torch.arange(S, device=dev)[None, :] < v[:, None]).reshape(-1)
    src = torch.nonzero(valid).reshape(-1)[:cap]
    k = src.numel()
    rows = torch.zeros((cap, _width(P, F)), dtype=torch.int32, device=dev)
    rows[:k, :P] = out_p.reshape(C * S, P)[src]
    rows[:k, P:2 * P] = out_g.reshape(C * S, P)[src]
    rows[:k, 2 * P:2 * P + F] = out_meta.reshape(C * S, F)[src]
    rows[:, 2 * P + F] = -1
    rows[:k, 2 * P + F] = (src // S).to(torch.int32)
    return _views(rows, valid.sum(dtype=torch.int32), P, F)


def compact_packages_cuda(out_n, out_p, out_g, out_meta, cap: int) -> dict:
    """Launch ``csrc/compact.cu``; same contract as
    :func:`compact_packages_plain` (``count`` stays on the card)."""
    _check(out_n, out_p, out_g, out_meta, cap)
    ins = (out_n, out_p, out_g, out_meta)
    if not all(t.is_cuda and t.is_contiguous() and t.device == out_p.device
               for t in ins):
        raise ValueError("compact: inputs must be contiguous CUDA tensors on "
                         "one device")
    C, S, P = out_p.shape
    F = out_meta.shape[2]
    cap = int(cap)
    W = _width(P, F)
    rows = torch.empty((cap, W), dtype=torch.int32, device=out_p.device)
    # the kernel's row sources, then the count
    scratch = torch.empty((cap + 1,), dtype=torch.int32, device=out_p.device)
    # 16-byte row copies need P % 4 == 0 and 16-byte aligned planes
    vec = int(P % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (out_p, out_g, rows)))
    fn = _cuda.launcher("compact")
    _cuda.LAUNCHES["compact"] += 1
    err = fn(out_n.data_ptr(), out_p.data_ptr(), out_g.data_ptr(),
             out_meta.data_ptr(), C, S, P, F, cap, W, vec, scratch.data_ptr(),
             rows.data_ptr(), scratch[cap:].data_ptr(),
             _cuda.stream_of(out_p))
    _cuda.check(err, "compact")
    return _views(rows, scratch[cap], P, F)


def compact_packages(out_n, out_p, out_g, out_meta, cap: int) -> dict:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    run = compact_packages_cuda if out_p.is_cuda else compact_packages_plain
    return run(out_n, out_p, out_g, out_meta, cap)

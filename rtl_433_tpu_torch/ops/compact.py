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
kept rows reach the host in one copy. Both versions return the six in a
dict (:func:`_views`); the kernel's ``rows`` and ``count`` lie in its one
buffer (:func:`views_of`).

:func:`compact_packages` launches ``csrc/compact.cu`` (one kernel launch)
for CUDA tensors and runs :func:`compact_packages_plain` for CPU tensors.
All tensors are int32.
"""

from __future__ import annotations

import torch

from . import _cuda

# channels up to which every CTA of the kernel counts out_n itself; past
# them it shares MAX_TILES tile sums through scratch after the count
# (csrc/compact.cu kOneCta, kMaxTiles)
ONE_CTA = 8192
MAX_TILES = 8192


def _check(out_n, out_p, out_g, out_meta, cap):
    if out_p.dim() != 3 or out_g.shape != out_p.shape:
        raise ValueError("compact: out_p and out_g must be [C, S, P]")
    C, S, _ = out_p.shape
    if out_n.shape != (C,) or out_meta.dim() != 3 \
            or out_meta.shape[:2] != (C, S):
        raise ValueError("compact: out_n must be [C] and out_meta [C, S, F]")
    i32 = torch.int32
    if out_n.dtype != i32 or out_p.dtype != i32 or out_g.dtype != i32 \
            or out_meta.dtype != i32:
        raise ValueError("compact: every input must be int32")
    if int(cap) < 1:
        raise ValueError(f"compact: cap must be at least 1, not {cap}")


def _width(P, F):
    """The row stride of the packed buffer: pulse, gap, meta and the
    channel, rounded up to 16 bytes so that every row's planes stay
    aligned for the kernel's int4 copies."""
    return -(-(2 * P + F + 1) // 4) * 4


def buffer_ints(C, P, F, cap):
    """The kernel's one int32 buffer: ``rows`` ``[cap, W]``, the count, and
    past ONE_CTA channels the tile sums' scratch."""
    return cap * _width(P, F) + 1 + (MAX_TILES if C > ONE_CTA else 0)


def _views(rows, count, P, F):
    return {"pulse": rows[:, :P], "gap": rows[:, P:2 * P],
            "meta": rows[:, 2 * P:2 * P + F], "channel": rows[:, 2 * P + F],
            "count": count.reshape(()), "rows": rows}


def views_of(buf, cap, P, F):
    """The six outputs of :func:`_views` over the kernel's one buffer
    ``buf`` (a tensor at the start of its own storage, laid out as
    :func:`buffer_ints` says), each made by one ``as_strided``, which
    costs the host less than :func:`_views`' slicing and reshaping."""
    W = _width(P, F)
    at = buf.as_strided
    return {"pulse": at((cap, P), (W, 1)), "gap": at((cap, P), (W, 1), P),
            "meta": at((cap, F), (W, 1), 2 * P),
            "channel": at((cap,), (W,), 2 * P + F),
            "count": at((), (), cap * W), "rows": at((cap, W), (W, 1))}


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


def _check_cuda(out_n, out_p, out_g, out_meta, cap):
    """:func:`_check`, and every input contiguous on one CUDA device."""
    _check(out_n, out_p, out_g, out_meta, cap)
    dev = out_p.get_device()
    if dev < 0 or out_n.get_device() != dev or out_g.get_device() != dev \
            or out_meta.get_device() != dev or not (
                out_n.is_contiguous() and out_p.is_contiguous()
                and out_g.is_contiguous() and out_meta.is_contiguous()):
        raise ValueError("compact: inputs must be contiguous CUDA tensors on "
                         "one device")


def _run(out_n, out_p, out_g, out_meta, cap, buf):
    """One launch of ``csrc/compact.cu`` into ``buf`` (int32, laid out as
    :func:`buffer_ints` says; the kernel takes its int4 path where P % 4 ==
    0 and the planes are 16-byte aligned)."""
    C, S, P = out_p.shape
    F = out_meta.shape[2]
    fn = _cuda.launcher("compact")
    with _cuda.launch_device(out_p):
        _cuda.LAUNCHES["compact"] += 1
        err = fn(out_n.data_ptr(), out_p.data_ptr(), out_g.data_ptr(),
                 out_meta.data_ptr(), C, S, P, F, cap, _width(P, F),
                 buf.data_ptr(), _cuda.stream_of(buf))
    _cuda.check(err, "compact")


def compact_packages_cuda(out_n, out_p, out_g, out_meta, cap: int):
    """Launch ``csrc/compact.cu`` once; same contract as
    :func:`compact_packages_plain` (``count`` stays on the card). One
    allocation holds ``rows``, the count and any scratch."""
    _check_cuda(out_n, out_p, out_g, out_meta, cap)
    P, F, cap = out_p.shape[2], out_meta.shape[2], int(cap)
    buf = torch.empty(buffer_ints(out_p.shape[0], P, F, cap),
                      dtype=torch.int32, device=out_p.device)
    _run(out_n, out_p, out_g, out_meta, cap, buf)
    return views_of(buf, cap, P, F)


def compact_packages(out_n, out_p, out_g, out_meta, cap: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    run = compact_packages_cuda if out_p.is_cuda else compact_packages_plain
    return run(out_n, out_p, out_g, out_meta, cap)

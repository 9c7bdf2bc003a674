"""Channel-sharded execution of the pulse-detection engine.

Independent receiver channels are the leading axis of every state tensor
and of the IQ block, and they split evenly over the devices of a mesh. The
only cross-channel value is diagnostic: the global noise floor, the mean
of the per-channel block levels (the JAX package's ``pmean`` over its
mesh; ref src/r_flow.c:166-194 keeps one process-wide noise EWMA).

Here a mesh is a list of ``torch.device``s with axis names, driven from
one process. Channels split into equal contiguous shards, one per device,
so the noise floor is the mean of the per-shard means, which equals the
global mean. On a one-device mesh the state is one dict of tensors on
that device: no split, concatenation or copy per block. A mesh of several
CPU devices (``[torch.device("cpu")] * 8``) runs the shards one after the
other, which is how the tests mirror the JAX package's 8-device CPU mesh.
Several processes over ``torch.distributed`` are ``parallel/multihost.py``;
one channel's samples split over time are ``parallel/timeshard.py``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..dsp.engine import (DetectorParams, PKG_FSK, compact_packages,
                          detector_init, packages_from_compact,
                          process_block)


class Mesh:
    """The devices that channels are split over, and the mesh's axis names
    (``shape`` has one entry per axis; channels shard over all of them)."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Sequence[str], shape: Sequence[int]):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("ch",),
              devices=None) -> Mesh:
    """Build a device mesh for channel sharding.

    Without ``devices`` it takes every CUDA device and raises when there is
    none. 1-D ``("ch",)`` puts all (or the first ``n_devices``) devices on
    the channel axis; 2-D ``("host", "ch")`` factors them as ``hosts x
    per_host``, and one process is one host.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA GPU is available (pass devices=, e.g. "
                "[torch.device('cpu')] * 8, to shard over CPU devices)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if len(axes) == 1:
        return Mesh(devices, axes, (len(devices),))
    if len(axes) == 2:
        return Mesh(devices, axes, (1, len(devices)))
    raise ValueError(f"unsupported mesh axes {axes!r}")


def _split(x, mesh: Mesh) -> list:
    """Equal contiguous channel shards of ``x``, each on its device (on a
    one-device mesh ``x`` itself, if it is there already)."""
    return [p.to(d) for p, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


def shard_state(state, mesh: Mesh) -> List[dict]:
    """A detector-state dict -> one state dict per mesh device, channel
    axis split evenly."""
    parts = {k: _split(v, mesh) for k, v in state.items()}
    return [{k: parts[k][i] for k in state} for i in range(mesh.size)]


def shard_block(iq, mesh: Mesh) -> list:
    """An IQ block [C, N, 2] (numpy or tensor) -> one tensor per mesh
    device, channel axis split evenly."""
    if isinstance(iq, np.ndarray):
        iq = torch.from_numpy(np.ascontiguousarray(iq))
    return _split(iq, mesh)


def sharded_process_block(params: DetectorParams, mesh: Mesh,
                          flush: bool = False):
    """The engine step over a mesh.

    Returns ``fn(shards, iq_shards, n_valid, flush=flush) -> (shards,
    avg_db, noise_floor_db)``: ``avg_db`` [C] on the mesh's first device,
    and ``noise_floor_db`` the global mean block level, the mean of the
    per-shard means (shards are equal).
    """
    dev0 = mesh.devices[0]

    def step(shards, iq_shards, n_valid, flush=flush):
        out, avgs = [], []
        for st, iq in zip(shards, iq_shards):
            st, avg_db = process_block(params, st, iq, n_valid, flush=flush)
            out.append(st)
            avgs.append(avg_db)
        if len(avgs) == 1:
            return out, avgs[0], avgs[0].mean()
        noise = avgs[0].mean().to(dev0)
        for a in avgs[1:]:
            noise = noise + a.mean().to(dev0)
        return (out, torch.cat([a.to(dev0) for a in avgs]),
                noise / len(avgs))

    return step


def sharded_init(params: DetectorParams, channels: int,
                 mesh: Mesh) -> List[dict]:
    """Fresh detector state, one dict per mesh device.

    ``channels`` must divide evenly by the mesh size.
    """
    n = mesh.size
    if channels % n:
        raise ValueError(f"channels ({channels}) must be a multiple of the "
                         f"mesh size ({n})")
    return shard_state(detector_init(params, channels, mesh.devices[0]),
                       mesh)


class ShardedEngine:
    """A multi-channel engine spread over a mesh: the analogue of running N
    independent rtl_433 processes, one state per device, one step for all
    of them.
    """

    def __init__(self, params: DetectorParams, channels: int,
                 mesh: Optional[Mesh] = None, registry=None,
                 center_frequency: float = 433_920_000.0,
                 pkg_cap_total: int = 2048):
        self.params = params
        self.mesh = mesh if mesh is not None else make_mesh()
        self.channels = channels
        self.shards = sharded_init(params, channels, self.mesh)
        self._step = sharded_process_block(params, self.mesh)
        self.noise_floor_db = None
        self.center_frequency = center_frequency
        self.registry = registry
        self.pkg_cap_total = pkg_cap_total
        self.n_pkg_dropped = 0
        self._stream_pos = 0
        self._base = 0
        self._undrained = False
        self._pending = []
        self._compact = functools.partial(compact_packages,
                                          cap=pkg_cap_total)

    @property
    def state(self) -> dict:
        """The whole detector state: the one shard's dict on a one-device
        mesh, else the shards joined on the first device (a copy)."""
        if len(self.shards) == 1:
            return self.shards[0]
        dev0 = self.mesh.devices[0]
        return {k: torch.cat([s[k].to(dev0) for s in self.shards])
                for k in self.shards[0]}

    def push(self, iq, n_valid=None, flush: bool = False):
        """Feed one [C, N, 2] CU8 block; returns per-channel block dB.

        Package ``start`` offsets published by the device are relative to
        the block that published them, so any packages still sitting in
        device slots are harvested (with this block's base) BEFORE the next
        block is pushed -- callers may push several blocks between drains
        without corrupting absolute offsets.
        """
        if n_valid is None:
            n_valid = iq.shape[1]
        if self._undrained:
            self._harvest()
        self._base = self._stream_pos
        self._stream_pos += int(n_valid)
        self._undrained = True
        iq = shard_block(iq, self.mesh)
        self.shards, avg_db, noise = self._step(self.shards, iq, int(n_valid),
                                                flush)
        self.noise_floor_db = noise
        return avg_db

    # -- scaled event service ------------------------------------------------
    #
    # sharded detect -> device-side package compaction -> one small transfer
    # -> slice/decode on the host -> per-channel-attributed events (ref
    # src/r_flow.c:241-340, the per-package loop).

    def _harvest(self):
        """Fetch device packages, stamping the publishing block's base.
        Each shard is compacted on its device; the shards' rows, in channel
        order and cut at ``pkg_cap_total``, are the global compaction's."""
        self._publish(*self._compact_shards())

    def _compact_shards(self):
        """Compact every shard and reset its slots. Returns this engine's
        packages in channel order, cut at ``pkg_cap_total``, and their
        count before the cut."""
        pkgs, count = [], 0
        for i, st in enumerate(self.shards):
            got, n = packages_from_compact(self._compact(st))
            per = st["out_n"].shape[0]
            for pkg in got:
                pkg["channel"] += i * per
            pkgs.extend(got)
            count += n
            st["out_n"] = torch.zeros_like(st["out_n"])
        return pkgs[:self.pkg_cap_total], count

    def _publish(self, pkgs, count, channel0=0):
        """Queue harvested packages: count the dropped ones, stamp each
        with the block's base and offset its channel by ``channel0``."""
        if count > len(pkgs):
            self.n_pkg_dropped += count - len(pkgs)
        for pkg in pkgs:
            pkg["base"] = self._base
            pkg["channel"] += channel0
        self._pending.extend(pkgs)
        self._undrained = False

    def take_packages(self):
        """Compact + fetch all published packages (resets device slots).

        Each returned package dict carries ``base``: the absolute stream
        position of the block that published it (``base + start`` is the
        absolute sample offset of the package start)."""
        self._harvest()
        pkgs, self._pending = self._pending, []
        return pkgs

    def use_decode_pool(self, n_workers: Optional[int] = None):
        """Fan host decode out across worker processes (decoders/pool.py).

        Channel-affine and order-preserving, so stateful decoders and
        event order are unchanged; call close_decode_pool() (or rely on
        process exit -- workers are daemonic) when done."""
        from ..decoders.pool import DecodePool
        self._decode_pool = DecodePool(self.registry, n_workers=n_workers)
        return self._decode_pool

    def close_decode_pool(self):
        pool = getattr(self, "_decode_pool", None)
        if pool is not None:
            pool.close()
            self._decode_pool = None

    def drain_events(self, block_len: Optional[int] = None):
        """Decode all published packages into channel-attributed events.

        Requires a ``registry`` (decoders.Registry). Returns a list of
        (channel, Event) in harvest order, and within a package in the
        registry's order. The pulse->event path is identical to the
        single-channel flow (same slicers, decoders, priority semantics).
        With :meth:`use_decode_pool` active, packages decode on the worker
        pool (channel-affine, order-preserving) instead of inline.
        """
        from ..pulse.data import PulseData
        if self.registry is None:
            raise ValueError("ShardedEngine needs registry= for events")
        pool = getattr(self, "_decode_pool", None)
        out = []
        pkgs = self.take_packages()
        if self.registry.device_slice and pkgs:
            # one batched kernel pass on the mesh's first device slices
            # every new train in this drain; the pool's workers, forked
            # before, do not see the memo and slice on the host
            self.registry.slice_device = self.mesh.devices[0]
            self.registry.prewarm_trains(
                [(pkg["type"] == PKG_FSK, pkg["pulse"], pkg["gap"])
                 for pkg in pkgs], self.params.sample_rate)
        for pkg in pkgs:
            pd = PulseData(
                pulse=pkg["pulse"].tolist(), gap=pkg["gap"].tolist(),
                sample_rate=self.params.sample_rate,
                offset=pkg["base"] + pkg["start"],
                ook_low_estimate=pkg["ook_low_estimate"],
                ook_high_estimate=pkg["ook_high_estimate"],
                fsk_f1_est=pkg["fsk_f1_est"], fsk_f2_est=pkg["fsk_f2_est"])
            pd.calc_rssi_snr(self.params.sample_rate, self.center_frequency,
                             sample_size=2,
                             use_mag_est=self.params.use_mag_est)
            ch = pkg["channel"]
            is_fsk = pkg["type"] == PKG_FSK
            if pool is not None:
                pool.submit(ch, is_fsk, pd)
                continue
            cb = lambda dev, ev, _ch=ch: out.append((_ch, ev))
            if is_fsk:
                self.registry.run_fsk_demods(pd, cb)
            else:
                self.registry.run_ook_demods(pd, cb)
        if pool is not None:
            out.extend((ch, ev) for ch, dev, ev in pool.drain())
        return out

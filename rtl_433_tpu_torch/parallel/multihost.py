"""Multi-process execution: the channel-sharded engine across processes.

The reference is a single process (SURVEY §2 "Distributed communication
backend: none"). Here each process drives its own devices and its own
channels over ``torch.distributed``: the global channel axis is
process-major (process ``p`` owns channels ``p*L .. p*L + L - 1``), every
process holds only its channels' state, and event decode is partitioned
(each process decodes its own channels' packages), so no IQ-rate data
crosses processes. Two small collectives remain, both on the host over
gloo:

- the noise floor, the mean block level over all channels: each process's
  mean of its per-shard means, summed with ``all_reduce`` and divided by
  the process count (the JAX package's hierarchical ``pmean``; shards and
  processes are equal in size, so this is the global mean);
- the package cap: the JAX package compacts the *global* state with one
  cap over the channel-major rank, so process ``p`` keeps
  ``max(0, cap - sum of the counts of processes q < p)`` of its packages,
  from an ``all_gather`` of one count per process.

gloo reduces host tensors, and NCCL cannot put two ranks on one GPU; so on
one card several processes share it, each with its own CUDA context.

The JAX package's ``make_global`` (assembling one ``jax.Array`` from every
process's rows) has no counterpart: a torch tensor lives in one process,
and nothing here needs the global array.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import Mesh, ShardedEngine, shard_block

# this process's CUDA device count, as given to initialize()
_LOCAL_DEVICE_COUNT: Optional[int] = None


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: Optional[int] = None):
    """Join the process group (gloo over TCP): ``coordinator_address`` is
    ``host:port`` (or ``tcp://host:port``) of process 0. Call once per
    process before building a :class:`MultiHostEngine`.
    ``local_device_count`` limits this process's devices to the first that
    many CUDA devices (default: every one)."""
    global _LOCAL_DEVICE_COUNT
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group("gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _LOCAL_DEVICE_COUNT = local_device_count


def global_mesh(axes: Sequence[str] = ("host", "ch"), devices=None) -> Mesh:
    """2-D mesh: process axis x local-device axis. ``devices`` are this
    process's (default: its CUDA devices, raising when there is none); the
    mesh holds only them, and its shape names every process."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "global_mesh: no CUDA GPU is available (pass devices=, e.g. "
                "[torch.device('cpu')] * 4)")
        n = torch.cuda.device_count()
        if _LOCAL_DEVICE_COUNT is not None:
            n = min(n, _LOCAL_DEVICE_COUNT)
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    return Mesh(devices, axes, (dist.get_world_size(), len(devices)))


class MultiHostEngine(ShardedEngine):
    """Channel-sharded detector spanning all processes.

    The numeric path of :class:`~.sharding.ShardedEngine` on this process's
    channels, with the noise floor and the package cap taken over every
    process. :meth:`local_packages` / :meth:`local_events` return this
    process's channels' packages / events, with global channel numbers.
    Every process must call :meth:`push` and :meth:`local_packages` (or
    :meth:`local_events`) in the same order: both are collective.
    """

    def __init__(self, params, channels_per_process: int, registry=None,
                 pkg_cap_total: int = 256,
                 center_frequency: float = 433_920_000.0, devices=None):
        mesh = global_mesh(devices=devices)
        super().__init__(params, channels_per_process,
                         Mesh(mesh.devices, ("ch",), (mesh.size,)),
                         registry=registry, center_frequency=center_frequency,
                         pkg_cap_total=pkg_cap_total)
        self.mesh = mesh
        self.nproc = dist.get_world_size()
        self.rank = dist.get_rank()
        self.local_channels = channels_per_process
        self.channels = channels_per_process * self.nproc

    def _local_slice(self):
        lo = self.rank * self.local_channels
        return slice(lo, lo + self.local_channels)

    def push(self, local_iq):
        """Feed this process's [local_channels, N, 2] CU8 block; returns its
        channels' block dB. As in ShardedEngine.push, undrained packages
        are harvested with the publishing block's base first."""
        if self._undrained:
            self._harvest()
        n = local_iq.shape[1]
        self._base = self._stream_pos
        self._stream_pos += int(n)
        self._undrained = True
        iq = shard_block(local_iq, self.mesh)
        self.shards, avg_db, noise = self._step(self.shards, iq, int(n),
                                                False)
        total = noise.detach().to("cpu", torch.float32).reshape(1)
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        self.noise_floor_db = float(total[0] / self.nproc)
        return avg_db

    def _harvest(self):
        """Compact this process's shards, keep the packages whose rank in
        the global channel-major order is under the cap, and stamp them
        with global channels and the publishing block's base."""
        pkgs, count = self._compact_shards()
        counts = [torch.zeros(1, dtype=torch.int64)
                  for _ in range(self.nproc)]
        dist.all_gather(counts, torch.tensor([count], dtype=torch.int64))
        before = sum(int(c[0]) for c in counts[:self.rank])
        keep = max(0, self.pkg_cap_total - before)
        self._publish(pkgs[:keep], count, self._local_slice().start)

    def local_packages(self):
        """This process's channels' published packages (and reset slots).

        Each package carries ``base``: the absolute stream position of the
        block that published it."""
        return self.take_packages()

    def local_events(self):
        """Decode this process's packages into (channel, Event) tuples."""
        return self.drain_events()

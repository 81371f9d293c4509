"""Device mesh over torch.distributed ranks for the proving fleet.

Two mesh axes, as in the JAX package:
  * 'data'  — voter-batch data parallelism (each rank proves its slice of
    the voter lanes);
  * 'model' — proving-key table and R1CS row sharding for the MSMs (the
    partial points are combined with an all_gather and a tree of adds) and
    the domain-sharded NTT's stage exchanges (all_to_all).

The world's ranks are laid out as (data, model) with the model axis
innermost: rank = d * n_model + m.  Each axis is an ``Axis``: its size,
this rank's index in it, its process group and the collectives the port
uses, on the leading dimension.  A tensor's split is a tuple of axis
names or None, one per dimension (the JAX package's PartitionSpec):
``data_sharding`` splits the leading dimension over 'data',
``replicated`` splits nothing.

Collectives take tensors on the rank's device and hand them to the
backend as they are.  NCCL is for one card a rank.  Gloo runs ranks on
the CPU, and ranks that share one card (NCCL refuses two ranks of a
communicator on one device); it takes CUDA tensors for all_to_all_single
and all_gather (PyTorch 2.11, checked on the card) and moves them
through pinned host memory itself.  ``CollectiveStats.devices`` records
the device types the collectives were given.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..utils import devices

@dataclass
class CollectiveStats:
    """Calls, bytes sent to other members, the device types of the
    tensors handed over and (when `timing` is set) seconds of the
    collectives of one mesh.  Timing synchronizes the device around each
    collective, so it is on only where a caller asks for stage seconds."""
    timing: bool = False
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    devices: set = field(default_factory=set)

    def snapshot(self) -> tuple:
        return self.calls, self.bytes, self.seconds


@dataclass
class Axis:
    name: str
    size: int
    index: int
    group: object                 # ProcessGroup, or None at size 1
    device: torch.device
    stats: CollectiveStats = field(default_factory=CollectiveStats)

    def _run(self, x: torch.Tensor, nbytes: int, fn):
        st = self.stats
        st.devices.add(x.device.type)
        if st.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if st.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st.seconds += time.perf_counter() - t0
        st.calls += 1
        st.bytes += nbytes
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Split the leading dimension into `size` chunks, send chunk i to
        member i, concatenate the chunks received in member order."""
        if self.size == 1:
            return x
        x = x.contiguous()

        def go():
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            return out

        return self._run(x, x.nbytes * (self.size - 1) // self.size, go)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """-> (size, *x.shape): every member's x, in member order."""
        if self.size == 1:
            return x[None]
        x = x.contiguous()

        def go():
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.stack(parts)

        return self._run(x, x.nbytes * (self.size - 1), go)


@dataclass
class Mesh:
    data: Axis
    model: Axis
    device: torch.device
    stats: CollectiveStats

    @property
    def shape(self) -> dict:
        return {"data": self.data.size, "model": self.model.size}

    def axis(self, name: str) -> Axis:
        return {"data": self.data, "model": self.model}[name]


def rank_device(device=None) -> torch.device:
    """This rank's device: the one named, except that "cuda" with no index
    (and None) mean cuda:(local rank mod device count), so ranks spread
    over the cards; raises when no card is visible (devices.resolve)."""
    dev = devices.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh | None:
    """(data, model) mesh over the first n_data * n_model ranks of the
    default process group (default n_data: world // n_model).  Every rank
    of the world must call it, in the same order as the other ranks: each
    creates every subgroup.  Returns this rank's Mesh, or None on a rank
    outside the mesh.  Without an initialized process group only a 1 x 1
    mesh exists."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"make_mesh: ({n_data}, {n_model}) does not fit a "
                         f"world of {world}")

    def groups(members: list) -> list:
        if len(members[0]) == 1:
            return [None] * len(members)
        return [dist.new_group(ranks=r) for r in members]

    model_groups = groups([[d * n_model + m for m in range(n_model)]
                           for d in range(n_data)])
    data_groups = groups([[d * n_model + m for d in range(n_data)]
                          for m in range(n_model)])
    if rank >= n_data * n_model:
        return None
    d, m = divmod(rank, n_model)
    dev = rank_device(device)
    stats = CollectiveStats()
    return Mesh(
        data=Axis("data", n_data, d, data_groups[m], dev, stats),
        model=Axis("model", n_model, m, model_groups[d], dev, stats),
        device=dev, stats=stats)


def staged_through_host(mesh: Mesh) -> bool:
    """True when a collective of a mesh on the card was handed a host
    tensor, i.e. the planes were copied through the host before it."""
    return mesh.device.type == "cuda" and "cpu" in mesh.stats.devices


def data_sharding(mesh: Mesh) -> tuple:
    """Batch-leading tensors split over the 'data' axis."""
    return ("data",)


def replicated(mesh: Mesh) -> tuple:
    return ()

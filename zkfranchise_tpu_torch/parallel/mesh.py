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

Every collective call is a ``Collective`` (op, axis, input, output
buffers) that the axis runs at once, unless the mesh is ``hooked``: then
the hook gets it instead.  parallel/prove.py's ShardedStep records a
step that way, cutting its CUDA capture at each collective, and runs the
recorded collectives on their buffers between the graphs' replays.
"""
from __future__ import annotations

import contextlib
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
class Collective:
    """One collective call of an Axis: its op ("all_to_all" or
    "all_gather"), the axis, the input tensor and the output buffers (a
    tensor like x for all_to_all, a list of `size` tensors like x for
    all_gather).  run() runs it on exactly those tensors, so it can run
    again on buffers that a CUDA graph reads and writes."""
    op: str
    axis: "Axis"
    x: torch.Tensor
    out: object

    @property
    def nbytes(self) -> int:
        """Bytes this member sends to the others."""
        n = self.axis.size
        if self.op == "all_to_all":
            return self.x.nbytes * (n - 1) // n
        return self.x.nbytes * (n - 1)

    def signature(self) -> tuple:
        return (self.op, self.axis.name, tuple(self.x.shape),
                str(self.x.dtype))

    def run(self) -> None:
        self.axis._run(self)


@dataclass
class Axis:
    name: str
    size: int
    index: int
    group: object                 # ProcessGroup, or None at size 1
    device: torch.device
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    # set by Mesh.hooked: called with each Collective in place of running it
    hook: object = None

    def _run(self, c: Collective) -> None:
        st = self.stats
        st.devices.add(c.x.device.type)
        if st.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if c.op == "all_to_all":
            dist.all_to_all_single(c.out, c.x, group=self.group)
        else:
            dist.all_gather(c.out, c.x, group=self.group)
        if st.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st.seconds += time.perf_counter() - t0
        st.calls += 1
        st.bytes += c.nbytes

    def _dispatch(self, c: Collective) -> None:
        if self.hook is None:
            self._run(c)
        else:
            self.hook(c)

    def all_to_all(self, x: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """Split the leading dimension into `size` chunks, send chunk i to
        member i, concatenate the chunks received in member order.  With
        `out` (a contiguous tensor like x) the result is written there and
        out is returned."""
        if self.size == 1:
            return x if out is None else out.copy_(x)
        x = x.contiguous()
        c = Collective("all_to_all", self, x,
                       torch.empty_like(x) if out is None else out)
        self._dispatch(c)
        return c.out

    def all_gather(self, x: torch.Tensor,
                   out: list | None = None) -> torch.Tensor:
        """-> (size, *x.shape): every member's x, in member order.  With
        `out` (a list of `size` contiguous tensors like x) the collective
        writes member i's x into out[i]; the result is stacked from them."""
        if self.size == 1:
            if out is not None:
                out[0].copy_(x)
            return x[None]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)] \
            if out is None else out
        self._dispatch(Collective("all_gather", self, x, parts))
        return torch.stack(parts)


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

    @contextlib.contextmanager
    def hooked(self, hook):
        """Within: every collective of either axis is handed to
        hook(Collective) in place of running; the hook may run it
        (Collective.run) or keep it for later (a segmented capture)."""
        self.data.hook = self.model.hook = hook
        try:
            yield
        finally:
            self.data.hook = self.model.hook = None

    def barrier(self) -> None:
        """Returns once every rank of the mesh has called it: a barrier on
        the model group, then on the data group."""
        for ax in (self.model, self.data):
            if ax.group is not None:
                dist.barrier(group=ax.group)


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

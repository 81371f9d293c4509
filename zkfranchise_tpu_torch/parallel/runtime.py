"""Multi-process runtime for the proving fleet on torch.distributed.

Usage in every process (one a rank):

    from zkfranchise_tpu_torch.parallel import runtime
    runtime.init_distributed(backend="nccl")   # False (no-op) when alone
    mesh = runtime.global_mesh(n_model=4)      # (world // 4, 4)

then a parallel.prove.ShardedProver over `mesh`; every rank runs the same
steps on its own shards.  The backend is always the caller's choice:
"nccl" for one card a rank, "gloo" on the CPU and for ranks that share a
card.  parallel/launch.py starts local ranks this way.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

# how long a rank waits for the others at the rendezvous and in a
# collective before the process group raises
TIMEOUT_S = 300


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Initialize the default process group from the arguments or the
    environment: ZKF_COORDINATOR (host:port, or an init URL such as
    tcp://host:port or file:///path), ZKF_NUM_PROCESSES, ZKF_PROCESS_ID.
    Returns False, doing nothing, when neither a coordinator nor a process
    count is configured (one process); True once the group is up.  A
    multi-process run must name its backend: ValueError otherwise."""
    coordinator_address = coordinator_address or os.environ.get(
        "ZKF_COORDINATOR")
    if num_processes is None and "ZKF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ZKF_NUM_PROCESSES"])
    if process_id is None and "ZKF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ZKF_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: backend must be 'nccl' or "
                         f"'gloo', got {backend!r}")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed: coordinator, process count and "
                         "process id are all needed")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def global_mesh(n_model: int = 1, device=None) -> Mesh | None:
    """(world // n_model, n_model) mesh over every rank of the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_data=world // n_model, n_model=n_model, device=device)


def local_shard(x, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """Full host copy of `x` (the same on every rank) -> this rank's shard
    on its device.  spec: one axis name or None per leading dimension (a
    shorter spec leaves the rest whole); a named dimension is cut into
    the axis's size equal contiguous parts and this rank takes its own."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh.axis(name)
        if t.shape[dim] % ax.size:
            raise ValueError(f"local_shard: dim {dim} of {tuple(t.shape)} "
                             f"does not split {ax.size} ways")
        t = t.chunk(ax.size, dim)[ax.index]
    return t.contiguous().to(mesh.device)


def process_info(mesh: Mesh | None = None) -> dict:
    up = dist.is_initialized()
    return {
        "rank": dist.get_rank() if up else 0,
        "world_size": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "device": str(mesh.device) if mesh is not None else None,
        "cuda_devices": torch.cuda.device_count(),
    }

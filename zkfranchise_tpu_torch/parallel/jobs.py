"""Rank jobs for parallel/launch.py: the distributed NTT, the sharded MSM
and the sharded prover, each run on every rank of a world and checked
against the single-device functions (the tests and chip_smoke.py run
them).  Each job builds its mesh from the world the launcher set up and
returns plain Python and numpy values."""
from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import lm, ntt, ntt_dist
from ..ops.cuda import lm_kernels as K
from . import runtime
from .mesh import make_mesh, staged_through_host


def random_plane(n: int, T: int, seed: int) -> np.ndarray:
    """(n, 21, T) int32 limbs of values below 2^253 < p (any value below p
    is a Montgomery-form element): 19 random 13-bit limbs and 6 bits."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, lm.N_LIMBS, T), np.int32)
    x[:, :19] = rng.integers(0, 1 << lm.LIMB_BITS, (n, 19, T), np.int32)
    x[:, 19] = rng.integers(0, 1 << 6, (n, T), np.int32)
    return x


def ntt_job(x, log_n: int, device, with_arrays: bool) -> dict:
    """The world as one model axis of nm ranks; x: (2^log_n, 21, T)
    Montgomery, the same on every rank.  Each rank takes its contiguous
    rows and runs intt_dist, ntt_dist on its result and coset_evals_dist.
    Rank 0 gathers them (unstriding the inverse) and holds each against
    ops/ntt.py on the whole plane on its device, canonical limb for limb:
    {"inverse_equal", "roundtrip_equal", "coset_equal"}, and with_arrays
    the gathered planes (numpy) under "inverse", "roundtrip", "coset"."""
    mesh = make_mesh(n_data=1, n_model=dist.get_world_size(), device=device)
    ax = mesh.model
    plan = ntt_dist.plan(log_n, ax.size)
    xl = runtime.local_shard(x, mesh, ("model",))
    co = ntt_dist.intt_dist(xl, ax, plan)
    back = ntt_dist.ntt_dist(co, ax, plan)
    cos = ntt_dist.coset_evals_dist(xl, ax, plan)
    inverse = ntt_dist.unstride(ax.all_gather(co), ax.size)
    roundtrip = ax.all_gather(back).reshape(inverse.shape)
    coset = ax.all_gather(cos).reshape(inverse.shape)
    if ax.index:
        return {}
    whole = torch.as_tensor(np.asarray(x), device=mesh.device)
    canon = lm.from_mont
    out = {"inverse_equal": torch.equal(canon(inverse),
                                        canon(ntt.ntt(whole, True))),
           "roundtrip_equal": torch.equal(canon(roundtrip), canon(whole)),
           "coset_equal": torch.equal(canon(coset), canon(
               ntt.coset_evals_from_domain_evals(whole))),
           "staged_through_host": staged_through_host(mesh),
           "collective_tensor_devices": sorted(mesh.stats.devices)}
    if with_arrays:
        out.update(inverse=inverse.cpu().numpy(),
                   roundtrip=roundtrip.cpu().numpy(),
                   coset=coset.cpu().numpy())
    return out


def msm_job(scalars, tables: dict, device) -> dict:
    """The world as one model axis; scalars (n, 21, B) plain and tables
    {kind: (n, arows) affine}, the same on every rank, n a multiple of the
    world.  -> {kind: _sharded_msm's (B, rows, 1) result, numpy}."""
    from .prove import _sharded_msm

    mesh = make_mesh(n_data=1, n_model=dist.get_world_size(), device=device)
    ax = mesh.model
    sc = torch.as_tensor(np.asarray(scalars), device=mesh.device)
    out = {}
    for kind, tab in tables.items():
        s = tab.shape[0] // ax.size
        shard = torch.as_tensor(np.ascontiguousarray(
            tab[ax.index * s:(ax.index + 1) * s]), device=mesh.device)
        out[kind] = _sharded_msm(sc, shard, kind, s, ax).cpu().numpy()
    return out


def prove_job(key_path: str, n_levels: int, arrays: dict, seed: int,
              n_model: int, device, steps: int = 0,
              ntt_check: tuple | None = None) -> dict:
    """A (world // n_model, n_model) mesh; the proving key read from
    key_path (ProvingKey.save), arrays the whole batch's
    inputs.batch_to_arrays.  prove_batch(arrays, seed) with the launch
    counts set to 0 just before it; the proofs come back from the ranks of
    model index 0, with the first lane each holds.  Then `steps` timed
    prove_batch_arrays on the same lanes (stage and collective seconds and
    bytes, their median by key), and, given ntt_check = (log_n, T, seed),
    ntt_job's check of a random_plane on this world as one model axis."""
    from ..groth16.setup import ProvingKey
    from ..models.census import CensusCircuit
    from .prove import ShardedProver, _in_spec

    t0 = time.perf_counter()
    pk = ProvingKey.load(key_path)
    circuit = CensusCircuit(n_levels)
    mesh = runtime.global_mesh(n_model, device=device)
    prover = ShardedProver(circuit, pk, mesh)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    init_s = time.perf_counter() - t0

    K.reset_launches()
    t0 = time.perf_counter()
    proofs, pubs = prover.prove_batch(arrays, seed=seed)
    prove_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    B = int(np.asarray(arrays["address"]).shape[-1])
    lane0 = mesh.data.index * (B // mesh.data.size)
    out = {"rank": runtime.process_info(mesh), "mesh": mesh.shape,
           "model_index": mesh.model.index, "data_index": mesh.data.index,
           "dist_ntt": prover._dist_ntt, "init_s": init_s,
           "prove_batch_s": prove_s, "launches": launches,
           "staged_through_host": staged_through_host(mesh),
           "collective_tensor_devices": sorted(mesh.stats.devices),
           "table_rows": {k: int(v.shape[0]) for k, v in prover.tabs.items()},
           "padded_rows": prover.padded}
    if mesh.model.index == 0:
        out.update(lane0=lane0, proofs=[json.dumps(p.to_dict())
                                        for p in proofs], publics=pubs)
    if steps:
        local = {k: runtime.local_shard(v, mesh, _in_spec(k))
                 for k, v in arrays.items()}
        from ..groth16.device import draw_rs
        r, s = (runtime.local_shard(x, mesh, (None, "data"))
                for x in draw_rs(seed, B))
        runs = []
        for _ in range(steps):
            st: dict = {}
            t0 = time.perf_counter()
            prover.prove_batch_arrays(local, r, s, stage_seconds=st)
            st["total"] = time.perf_counter() - t0
            runs.append(st)
        out["stage_seconds_median"] = {
            k: statistics.median(run[k] for run in runs) for k in runs[0]}
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            mesh.device)
    if ntt_check is not None:
        log_n, T, plane_seed = ntt_check
        del prover
        out["ntt_check"] = ntt_job(random_plane(1 << log_n, T, plane_seed),
                                   log_n, device, False)
    return out

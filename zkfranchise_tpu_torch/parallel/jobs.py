"""Rank jobs for parallel/launch.py: the distributed NTT, the sharded MSM
and the sharded prover, each run on every rank of a world and checked
against the single-device functions (the tests and chip_smoke.py run
them).  Each job builds its mesh from the world the launcher set up and
returns plain Python and numpy values."""
from __future__ import annotations

import contextlib
import functools
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
              n_model: int, device, *, steps: int = 0,
              ntt_check: tuple | None = None, probes: bool = False,
              capture: bool = False) -> dict:
    """A (world // n_model, n_model) mesh; the proving key read from
    key_path (ProvingKey.save), arrays the whole batch's
    inputs.batch_to_arrays.  prove_batch(arrays, seed) with the launch
    counts set to 0 just before it; the proofs come back from the ranks of
    model index 0, with the first lane each holds.  Then, on the same
    lanes:
      * probes: the collective schedule of that prove_batch and of one
        more prove_fused (run under tools.host_tensors: the host tensors
        it makes), and each axis's collectives into given buffers against
        the allocating ones (out_buffer_check), under "probes";
      * `steps` timed prove_batch_arrays (stage and collective seconds
        and bytes, their median by key);
      * capture (on the card): ShardedProver.capture, prove_batch through
        it (the replay's proofs from the ranks of model index 0), the
        step's records, memory, the error a mismatched input raises, one
        round of eager and replay steps (eager, replay, replay, eager)
        each with its collective seconds, and on rank 0 an upper bound of
        one replay's device busy time, under "capture";
      * given ntt_check = (log_n, T, seed), ntt_job's check of a
        random_plane on this world as one model axis."""
    from ..groth16.setup import ProvingKey
    from ..models.census import CensusCircuit
    from .. import tools
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

    first: list = []
    K.reset_launches()
    t0 = time.perf_counter()
    with _recorded(mesh, first) if probes else contextlib.nullcontext():
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
    local = {k: runtime.local_shard(v, mesh, _in_spec(k))
             for k, v in arrays.items()}
    r, s = prover.local_rs(seed, B)
    if probes:
        second: list = []
        made: list = []
        with _recorded(mesh, second), tools.host_tensors(made):
            prover.prove_fused(local, r, s)
        out["probes"] = {"schedules": [first, second], "host_tensors": made,
                         "out_buffers": out_buffer_check(mesh, seed)}
    if steps:
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
    if capture:
        out["capture"], replayed = _captured(prover, arrays, seed, local, r,
                                             s)
        if mesh.model.index == 0:
            out.update(replay_proofs=[json.dumps(p.to_dict())
                                      for p in replayed[0]],
                       replay_publics=replayed[1])
    if ntt_check is not None:
        log_n, T, plane_seed = ntt_check
        del prover
        t0 = time.perf_counter()
        out["ntt_check"] = ntt_job(random_plane(1 << log_n, T, plane_seed),
                                   log_n, device, False)
        out["ntt_check_s"] = time.perf_counter() - t0
    return out


def _recorded(mesh, log: list):
    """Context: every collective of the mesh runs as always, and its
    (op, axis, input shape, dtype) is appended to `log`."""
    def hook(c):
        log.append(c.signature())
        c.run()
    return mesh.hooked(hook)


def out_buffer_check(mesh, seed: int) -> dict:
    """On each axis of size > 1: all_to_all(x, out=buf) and all_gather(x,
    out=parts) against the allocating forms on a random int32 x.  ->
    {axis: {op: {"equal": results equal, "into_out": the result lies in
    the given buffers, "stats": [(calls, bytes) the allocating form added,
    (calls, bytes) the given-buffer form added]}}}."""
    g = torch.Generator().manual_seed(1000 * seed + dist.get_rank())
    st = mesh.stats
    res: dict = {}
    for ax in (mesh.data, mesh.model):
        if ax.size == 1:
            continue
        x = torch.randint(0, 1 << lm.LIMB_BITS, (3 * ax.size, lm.N_LIMBS, 2),
                          dtype=torch.int32, generator=g).to(mesh.device)

        def ticks(fn):
            c0 = st.snapshot()
            y = fn()
            c1 = st.snapshot()
            return y, (c1[0] - c0[0], c1[1] - c0[1])

        a, a_st = ticks(lambda: ax.all_to_all(x))
        buf = torch.empty_like(x)
        b, b_st = ticks(lambda: ax.all_to_all(x, out=buf))
        ga, ga_st = ticks(lambda: ax.all_gather(x))
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        gb, gb_st = ticks(lambda: ax.all_gather(x, out=parts))
        res[ax.name] = {
            "all_to_all": {"equal": torch.equal(a, b),
                           "into_out": b.data_ptr() == buf.data_ptr(),
                           "stats": [a_st, b_st]},
            "all_gather": {"equal": torch.equal(ga, gb),
                           "into_out": all(torch.equal(p, ga[i])
                                           for i, p in enumerate(parts)),
                           "stats": [ga_st, gb_st]}}
    return res


class _PartClock:
    """Wall seconds since the last mark, by part name."""

    def __init__(self):
        self.parts: dict = {}
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def _pool_bytes(dev, pool) -> int:
    """Bytes of the allocator's segments in graph pool `pool` on `dev`."""
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if seg["device"] == dev.index
               and tuple(seg["segment_pool_id"]) == tuple(pool))


def _captured(prover, arrays, seed, local, r, s) -> tuple:
    """prove_job's capture part -> (its record, the replay's (proofs,
    publics)).  "memory" holds the allocator at the capture's four probe
    points, "part_s" the wall seconds of each part: the capture with its
    warm-up, the records, the replayed prove_batch, the turns and the
    profiled replay."""
    from .. import tools

    dev = prover.device
    B = int(np.asarray(arrays["address"]).shape[-1])
    memory: dict = {}

    def probe(stage):
        torch.cuda.synchronize(dev)
        mem = torch.cuda.memory_stats(dev)
        memory[stage] = {k: mem.get(f"{k}_bytes.all.current", 0)
                         for k in ("reserved", "allocated")}

    clock = _PartClock()
    step = prover.capture(B, probe=probe)
    torch.cuda.synchronize(dev)
    clock.mark("capture")
    rec = {"stretches": step.stretches, "schedule": step.schedule(),
           "launches": step.launches, "eager_launches": step.eager_launches,
           "nodes": step.node_counts(),
           "nodes_by_stretch": step.node_counts_by_stretch(),
           "warmup_s": step.warmup_s, "capture_s": step.capture_s,
           "instantiate_s": step.instantiate_s,
           "pool_bytes": _pool_bytes(dev, step.pool), "memory": memory,
           "part_s": clock.parts}
    clock.mark("records")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    replayed = step.prove_batch(arrays, seed=seed)
    rec["replay_prove_batch_s"] = time.perf_counter() - t0
    rec["peak_allocated_with_graphs"] = torch.cuda.max_memory_allocated(dev)
    rec["peak_reserved_with_graphs"] = torch.cuda.max_memory_reserved(dev)
    clock.mark("replay_prove_batch")
    # check_step_inputs refuses it before any copy or collective
    try:
        step({**local, "password": local["password"].long()}, r, s)
    except ValueError as err:
        rec["mismatch"] = str(err)

    st = prover.mesh.stats

    def timed(kind, fn):
        st.timing = True
        try:
            c0 = st.snapshot()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn(local, r, s)
            torch.cuda.synchronize(dev)
            t = time.perf_counter() - t0
            c1 = st.snapshot()
        finally:
            st.timing = False
        return {"kind": kind, "s": t, "collective_s": c1[2] - c0[2],
                "collective_bytes": c1[1] - c0[1]}

    rec["turns"] = [timed("eager", prover.prove_fused), timed("replay", step),
                    timed("replay", step), timed("eager", prover.prove_fused)]
    clock.mark("turns")
    # one replay profiled between spins on rank 0 (tools.kernel_events
    # calls it twice), two unprofiled on every other rank: each rank must
    # call a step with collectives as often as the others.  Kernels count
    # (the port's and PyTorch's own), copies do not: gloo stages through
    # them.  The other ranks time-slice the card and stretch rank 0's
    # kernels, so their sum bounds its busy time from above.
    replay = functools.partial(step, local, r, s)
    if dist.get_rank() == 0:
        events, spins = tools.kernel_events(replay, runs=1)
        kernels = [(name, us) for name, us in events
                   if not name.startswith(("Memcpy", "Memset"))]
        ours = [us for name, us in kernels if not tools._torch_kernel(name)]
        rec["replay_busy"] = {
            "busy_upper_bound_s":
                sum(us for _, us in kernels) / 1e6 if kernels else None,
            "port_kernels_s": sum(ours) / 1e6,
            "kernel_events": len(kernels), "port_kernel_events": len(ours),
            "copy_events": len(events) - len(kernels), "spins": spins}
    else:
        replay()
        replay()
    clock.mark("profiled_replay")
    return rec, replayed

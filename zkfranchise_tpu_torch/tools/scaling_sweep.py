"""Scaling sweep: the sharded prover over several (data, model) meshes.

The counterpart of the JAX package's ``scripts/scaling_sweep.py``.  One
world of local ranks (as many as the largest mesh) runs each mesh in
turn on its first data * model ranks, at a fixed problem: nlevels and
batch, the synthetic generator-point key of tools.dryrun_multichip.  Per
stage and mesh it times `iters` steps after a warm-up and holds the
step's result against the single-device one:

  * full      the whole step, ShardedProver.prove_batch_arrays, against
              DeviceProver.prove_arrays (points affine, publics exact);
  * quotient  witness + the row-sharded quotient with the distributed
              NTT, against groth16.device.quotient_stage;
  * msm       the model-sharded MSM over the A table (random scalars),
              against msm_lm.msm on the whole table (affine).

    python -m zkfranchise_tpu_torch.tools.scaling_sweep --out DIR \\
        [--device cuda|cpu] [--backend gloo|nccl] [--nlevels 4] \\
        [--batch 8] [--iters 3] [--stage msm,quotient] \\
        [--meshes 1x1,1x2,2x2,2x4]

It writes DIR/scaling.json only.  Ranks that share one card (or the CPU's
cores) cannot speed a step up: every time in the JSON stands beside
"ranks_per_card" (null on the CPU), and the JSON has no speed-up figure.
What it shows is that every mesh runs the real sharded stages and equals
the single device, and what each mesh's collectives move and take.  On the
CPU every process runs one intra-op thread.  Exits non-zero if a rank
fails or times out or a result differs.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from .dryrun_multichip import example_inputs, example_rs, synthetic_pk

STAGES = ("full", "quotient", "msm")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(meshes: list, stages: list, n_levels: int, device, arrs: dict,
          r, s, wa, iters: int) -> list:
    """Every mesh and stage in turn; -> [{mesh, stage, seconds, result
    planes (ranks of model index 0), collective calls, bytes}] of this
    rank, None where it lies outside the mesh."""
    import torch.distributed as dist

    from ..models.census import CensusCircuit
    from ..parallel import runtime
    from ..parallel.mesh import make_mesh
    from ..parallel.prove import ShardedProver, _in_spec

    circuit = CensusCircuit(n_levels)
    pk = synthetic_pk(circuit.cs)
    out = []
    for nd, nm in meshes:
        mesh = make_mesh(nd, nm, device=device)
        if mesh is None:
            out.extend(None for _ in stages)
            dist.barrier()
            continue
        sp = ShardedProver(circuit, pk, mesh)
        lanes = (None, "data")
        local = {k: runtime.local_shard(v, mesh, _in_spec(k))
                 for k, v in arrs.items()}
        r_l, s_l = (runtime.local_shard(x, mesh, lanes) for x in (r, s))
        wa_l = runtime.local_shard(wa, mesh, (None, None, "data"))
        for stage in stages:
            if stage == "quotient":
                def step():
                    return (sp._quotient(circuit.witness(local)),)
            elif stage == "msm":
                def step():
                    return (sp._msm(wa_l, "a"),)
            else:
                def step():
                    return sp.prove_batch_arrays(local, r_l, s_l)
            res = step()                            # warm-up
            _sync(mesh.device)
            c0 = mesh.stats.snapshot()
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                res = step()
                _sync(mesh.device)
                times.append(time.perf_counter() - t0)
            c1 = mesh.stats.snapshot()
            row = {"mesh": [nd, nm], "stage": stage, "seconds": times,
                   "dist_ntt": sp._dist_ntt,
                   "collective_calls": (c1[0] - c0[0]) // iters,
                   "collective_bytes": (c1[1] - c0[1]) // iters}
            if mesh.model.index == 0:
                row["lane0"] = mesh.data.index * (r.shape[-1] // nd)
                row["result"] = [x.cpu().numpy() for x in res]
            out.append(row)
        del sp
        dist.barrier()
    return out


def _reference(stage: str, n_levels: int, dev, arrs, r, s, wa) -> list:
    from ..groth16.device import DeviceProver, quotient_stage
    from ..models.census import CensusCircuit
    from ..ops import msm_lm

    circuit = CensusCircuit(n_levels)
    prover = DeviceProver(circuit, synthetic_pk(circuit.cs), device=dev)
    if stage == "quotient":
        w = circuit.witness({k: torch.as_tensor(v, device=dev)
                             for k, v in arrs.items()})
        out = (quotient_stage(prover._arrays_dev, prover.pk_meta[2], w),)
    elif stage == "msm":
        tab = prover.a_tab
        n = tab.shape[0]
        out = (msm_lm.msm(torch.as_tensor(wa[:n], device=dev), tab, "g1"),)
    else:
        out = prover.prove_arrays(arrs, torch.as_tensor(r),
                                  torch.as_tensor(s))
    return [x.cpu().numpy() for x in out]


def _equal(stage: str, got: list, want: list) -> bool:
    from ..ops import ec_lm

    def same(to_affine, a, b):
        return to_affine(torch.as_tensor(a)) == to_affine(torch.as_tensor(b))

    g1, g2 = ec_lm.g1_plane_to_affine, ec_lm.g2_plane_to_affine
    if stage == "quotient":
        return np.array_equal(got[0], want[0])
    if stage == "msm":                    # (B, 63, 1) -> (63, B)
        return same(g1, got[0][..., 0].T, want[0][..., 0].T)
    return (same(g1, got[0], want[0]) and same(g2, got[1], want[1]) and
            same(g1, got[2], want[2]) and np.array_equal(got[3], want[3]))


def _gather_lanes(rows: list, stage: str) -> list:
    """The result planes of the ranks of model index 0, in lane order (the
    msm stage's (B, rows, 1) planes put their lanes first)."""
    parts = sorted((row["lane0"], row["result"]) for row in rows
                   if "result" in row)
    axis = 0 if stage == "msm" else -1
    return [np.concatenate([p[i] for _, p in parts], axis)
            for i in range(len(parts[0][1]))]


def sweep(out: pathlib.Path, meshes: list, stages: list, n_levels: int = 4,
          batch: int = 8, iters: int = 3, device=None,
          backend: str = "gloo", timeout_s: float = 1800.0) -> dict:
    from ..models.census import CensusCircuit
    from ..ops.cuda import lm_kernels as K
    from ..parallel import launch
    from ..parallel.jobs import random_plane
    from ..utils import devices

    dev = devices.resolve(device)
    if dev.type == "cuda":
        K.build()                   # once here; the ranks only load them
    world = max(nd * nm for nd, nm in meshes)
    arrs = example_inputs(n_levels, batch, dev)
    r, s = example_rs(batch)
    cs = CensusCircuit(n_levels).cs
    # random canonical scalars for the A table, padded for every model size
    mult = math.lcm(*(nm for _, nm in meshes))
    wa = random_plane(-(-(cs.num_vars + 1) // mult) * mult, batch, 3)
    wa[cs.num_vars + 1:] = 0
    t0 = time.perf_counter()
    per_rank = launch.run(_rank, world, backend=backend, timeout_s=timeout_s,
                          args=(meshes, stages, n_levels, str(dev), arrs, r,
                                s, wa, iters))
    on_card = dev.type == "cuda"
    want = {stage: _reference(stage, n_levels, dev, arrs, r, s, wa)
            for stage in stages}
    sweeps: dict = {stage: [] for stage in stages}
    ok = True
    for j, (nd, nm) in enumerate(meshes):
        for k, stage in enumerate(stages):
            rows = [res[j * len(stages) + k] for res in per_rank]
            rows = [row for row in rows if row is not None]
            equal = _equal(stage, _gather_lanes(rows, stage), want[stage])
            ok &= equal
            per = [statistics.median(row["seconds"]) for row in rows]
            sweeps[stage].append({
                "mesh": f"{nd}x{nm}", "ranks": nd * nm,
                "dist_ntt": rows[0]["dist_ntt"],
                "step_seconds": max(per), "rank_step_seconds": per,
                "ranks_per_card": -(-nd * nm // torch.cuda.device_count())
                if on_card else None,
                "collective_calls": rows[0]["collective_calls"],
                "collective_bytes_per_rank": [row["collective_bytes"]
                                              for row in rows],
                "equal_to_single_device": equal})
            print(json.dumps({"stage": stage, **sweeps[stage][-1]}),
                  file=sys.stderr)
    result = {"nlevels": n_levels, "batch": batch, "iters": iters,
              "device": torch.cuda.get_device_name(dev) if on_card
              else "cpu", "backend": backend, "world": world,
              "seconds": time.perf_counter() - t0, "sweeps": sweeps,
              "caveat": (
                  "the ranks share one card (ranks_per_card) or the host's "
                  "cores, and gloo moves the planes through host memory: "
                  "wall time cannot fall with the rank count here, so no "
                  "speed-up is given. The evidence is that every mesh runs "
                  "the sharded stages and equals the single device, and "
                  "what its collectives move.")}
    out.mkdir(parents=True, exist_ok=True)
    (out / "scaling.json").write_text(json.dumps(result, indent=1))
    if not ok:
        raise AssertionError("scaling_sweep: a mesh differs from the single "
                             "device")
    return result


def _mesh(text: str) -> tuple:
    nd, nm = text.lower().split("x")
    return int(nd), int(nm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, type=pathlib.Path)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--nlevels", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--stage", default="msm,quotient")
    ap.add_argument("--meshes", default="1x1,1x2,2x2,2x4")
    ap.add_argument("--timeout", type=float, default=1800.0)
    a = ap.parse_args(argv)
    stages = a.stage.split(",")
    if any(st not in STAGES for st in stages):
        ap.error(f"--stage: each of {STAGES}")
    if a.device == "cpu":
        torch.set_num_threads(1)
    res = sweep(a.out, [_mesh(m) for m in a.meshes.split(",")], stages,
                a.nlevels, a.batch, a.iters, a.device, a.backend, a.timeout)
    print(json.dumps({k: res[k] for k in ("nlevels", "batch", "device",
                                          "backend", "world", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

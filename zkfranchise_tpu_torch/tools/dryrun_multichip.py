"""Multi-rank dry run: one sharded proving step, held against one device.

The counterpart of the JAX package's ``dryrun_multichip(n)``.  It lays
`n` ranks out as a (data, model) mesh (model 4 when 4 divides n, else 2,
else 1), builds a ShardedProver at nlevels=4 over a synthetic key
(generator points everywhere: the proofs do not verify, but every stage
runs), proves one fused step on ``mock_batch(4, B, seed=1)`` with 62-bit
r and s from numpy.random.default_rng(0), and holds the planes against a
single-device DeviceProver.prove_arrays on the same inputs: the points in
affine form (the reduction order differs, so projective Z does not
match), the publics exactly.  On the card the step goes through
``ShardedProver.capture`` (one CUDA graph a stretch between collectives),
as the JAX dry run goes through the compiled ``prove_fused``, and the
output gives each rank's stretches; a CPU mesh has no graphs, so there
the step runs eagerly.

    python -m zkfranchise_tpu_torch.tools.dryrun_multichip [--ranks 4] \\
        [--device cuda|cpu] [--backend gloo|nccl] [--batch B]

The ranks are local processes (parallel/launch.py) on the card by
default, all on one card when there is one: gloo is the default backend
because NCCL refuses two ranks of a communicator on one device.  On the
CPU every process runs one intra-op thread.  B defaults to the JAX dry
run's max(n_data, 2).  Exits non-zero if a rank fails or times out or a
plane differs.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time

import numpy as np
import torch

N_LEVELS = 4


def synthetic_pk(cs):
    """ProvingKey stand-in with generator points everywhere (valid curve
    points; proofs will not verify, but the whole pipeline runs)."""
    from ..groth16 import qap
    from ..groth16.setup import ProvingKey
    from ..ops import ec

    m = cs.num_vars
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    g1, g2 = ec.G1_GEN, ec.G2_GEN
    return ProvingKey(
        n_vars=m, n_public=cs.num_public, domain=n,
        alpha_g1=g1, beta_g1=g1, beta_g2=g2, delta_g1=g1, delta_g2=g2,
        a_g1=[g1] * m, b_g1=[g1] * m, b_g2=[g2] * m,
        k_g1=[g1] * (m - cs.num_public - 1), h_g1=[g1] * n)


def example_inputs(n_levels: int, n_voters: int, device) -> dict:
    from .. import inputs as inp
    return inp.batch_to_arrays(
        inp.mock_batch(n_levels, n_voters, seed=1, device=device), n_levels)


def example_rs(batch: int) -> tuple:
    """r and s as the JAX dry run draws them: 62-bit ints, rng(0)."""
    from ..ops import lm
    rng = np.random.default_rng(0)
    return tuple(lm.ints_to_lm([int(x) for x in rng.integers(
        1, 2**62, size=batch)]) for _ in range(2))


def mesh_shape(n: int) -> tuple:
    n_model = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return n // n_model, n_model


def _rank(n_data: int, n_model: int, device, arrs: dict, r, s) -> dict:
    """One rank: the fused sharded step on its lanes (captured on the
    card, eager on the CPU) -> its stretches, and on the ranks of model
    index 0 its planes with the index of its first lane."""
    from ..models.census import CensusCircuit
    from ..parallel import runtime
    from ..parallel.mesh import make_mesh, staged_through_host
    from ..parallel.prove import ShardedProver, _in_spec

    mesh = make_mesh(n_data, n_model, device=device)
    circuit = CensusCircuit(N_LEVELS)
    prover = ShardedProver(circuit, synthetic_pk(circuit.cs), mesh)
    local = {k: runtime.local_shard(v, mesh, _in_spec(k))
             for k, v in arrs.items()}
    r_l, s_l = (runtime.local_shard(x, mesh, (None, "data")) for x in (r, s))
    B = r.shape[-1]
    if mesh.device.type == "cuda":
        step = prover.capture(B)
        planes = step(local, r_l, s_l)
        stretches = step.stretches
    else:
        planes = prover.prove_fused(local, r_l, s_l)
        stretches = None
    if mesh.model.index:
        return {"stretches": stretches}
    return {"lane0": mesh.data.index * (B // n_data),
            "planes": [p.cpu().numpy() for p in planes],
            "stretches": stretches,
            "staged_through_host": staged_through_host(mesh)}


def _lanes(results: list, i: int) -> np.ndarray:
    """Plane i of every rank of model index 0, in lane order."""
    parts = sorted((r["lane0"], r["planes"][i]) for r in results
                   if "planes" in r)
    return np.concatenate([p for _, p in parts], -1)


def dryrun(n: int, device=None, backend: str = "gloo",
           batch: int | None = None, timeout_s: float = 900.0) -> dict:
    """Runs the dry run on n ranks; raises AssertionError if a plane
    differs from the single-device prover's."""
    from ..groth16.device import DeviceProver
    from ..models.census import CensusCircuit
    from ..ops import ec_lm
    from ..ops.cuda import lm_kernels as K
    from ..parallel import launch
    from ..utils import devices

    dev = devices.resolve(device)
    if dev.type == "cuda":
        K.build()                   # once here; the ranks only load them
    n_data, n_model = mesh_shape(n)
    batch = max(n_data, 2) if batch is None else batch
    arrs = example_inputs(N_LEVELS, batch, dev)
    r, s = example_rs(batch)

    def reference():
        circuit = CensusCircuit(N_LEVELS)
        ref = DeviceProver(circuit, synthetic_pk(circuit.cs), device=dev)
        planes = ref.prove_arrays(arrs, torch.as_tensor(r),
                                  torch.as_tensor(s))
        return [p.cpu().numpy() for p in planes]

    t0 = time.perf_counter()
    # the single-device prover runs while the ranks do
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        want = pool.submit(reference)
        results = launch.run(_rank, n, backend=backend, timeout_s=timeout_s,
                             args=(n_data, n_model, str(dev), arrs, r, s))
        want = want.result()
    got = [_lanes(results, i) for i in range(4)]

    def same(to_affine, i):
        return to_affine(torch.as_tensor(got[i])) == \
            to_affine(torch.as_tensor(want[i]))

    checks = {"pi_a": same(ec_lm.g1_plane_to_affine, 0),
              "pi_b": same(ec_lm.g2_plane_to_affine, 1),
              "pi_c": same(ec_lm.g1_plane_to_affine, 2),
              "publics": np.array_equal(got[3], want[3])}
    out = {"mesh": [n_data, n_model], "batch": batch, "device": str(dev),
           "backend": backend, "pi_a_shape": list(got[0].shape),
           "staged_through_host": any(res.get("staged_through_host")
                                      for res in results),
           "stretches": [res["stretches"] for res in results],
           "equal_to_single_device": checks,
           "seconds": time.perf_counter() - t0}
    if not all(checks.values()):
        raise AssertionError(f"dryrun_multichip: sharded != single-device: "
                             f"{checks}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    out = dryrun(a.ranks, a.device, a.backend, a.batch, a.timeout)
    import json
    print(json.dumps({"dryrun_multichip": "OK", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

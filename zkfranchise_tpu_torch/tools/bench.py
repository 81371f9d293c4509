"""Benchmark of the port: batched zkCensus Groth16 proving on one card.

    python3 -m zkfranchise_tpu_torch.tools.bench

The counterpart of the JAX package's ``bench.py``, with its settings:
BENCH_NLEVELS (16), BENCH_BATCH (128) and BENCH_ITERS (3).  The key is
the committed ``proving_key.pkl`` of ``artifacts/zkCensus/dev/<nlevels>``
if there is one, else its ``proving_key.zkey`` (through
``utils.zkey_compat``), else a dev setup; the inputs are
``mock_batch(nlevels, batch, seed=7)``.  The prover's step is captured as
one CUDA graph (``groth16.device.FusedStep``); one ``prove_batch``
through it warms up and one sampled proof is verified.  The seconds per
stage come from the eager ``prove_arrays(stage_seconds=)``, since a graph
has no stages.  The timed loop replays the graph ITERS times, each with r
and s drawn from seeds 2, 3, ... and synchronised, with no ``finalize``;
the same loop over the eager ``prove_arrays`` goes on a ``#`` line.

The last line of standard output is one JSON object: ``metric``,
``value`` (proofs/s of the replayed step), ``unit``, ``verified``,
``msm_mpoints_per_s`` and ``device``.  The stage file
(``bench_stages[_<nlevels>].json``) and the cached key go under
``zkfranchise_tpu_torch/build/bench/``; nothing is written elsewhere.
Runs on the card and raises without one.  ``measure`` is the measuring
part, for a caller that already holds a prover (``chip_smoke.py``).
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import torch

from .. import inputs as inp
from ..groth16 import setup as gsetup
from ..groth16 import verify as gverify
from ..groth16.device import DeviceProver, FusedStep, draw_rs
from ..models.census import CensusCircuit
from ..utils import devices, serialize, zkey_compat

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent
OUT_DIR = PKG / "build" / "bench"


def settings() -> tuple[int, int, int]:
    """(nlevels, batch, iters) from BENCH_NLEVELS, BENCH_BATCH and
    BENCH_ITERS, defaults 16, 128 and 3."""
    return (int(os.environ.get("BENCH_NLEVELS", "16")),
            int(os.environ.get("BENCH_BATCH", "128")),
            int(os.environ.get("BENCH_ITERS", "3")))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def get_setup(circuit: CensusCircuit):
    """-> (ProvingKey, VerifyingKey) for the circuit's nlevels: the
    committed pkl, else the committed zkey, else a dev setup; the last two
    are cached under build/bench/."""
    nl = circuit.n_levels
    d = ROOT / "artifacts" / "zkCensus" / "dev" / str(nl)
    vk_path = d / "verification_key.json"
    cached_pk = OUT_DIR / f"proving_key_{nl}.pkl"
    cached_vk = OUT_DIR / f"verification_key_{nl}.json"
    for pk_path, vk_file in ((d / "proving_key.pkl", vk_path),
                             (cached_pk, cached_vk)):
        if pk_path.exists() and vk_file.exists():
            return (gsetup.ProvingKey.load(pk_path),
                    gverify.VerifyingKey(json.loads(vk_file.read_text())))
    t0 = time.perf_counter()
    zkey_path = d / "proving_key.zkey"
    if zkey_path.exists() and vk_path.exists():
        pk, _ = zkey_compat.pk_from_zkey(
            serialize.read_zkey(zkey_path.read_bytes()))
        vk_dict = json.loads(vk_path.read_text())
        log(f"zkey ingested in {time.perf_counter() - t0:.1f}s")
    else:
        pk, vk = gsetup.dev_setup(circuit.cs)
        vk_dict = vk.to_dict()
        log(f"setup generated in {time.perf_counter() - t0:.1f}s")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    pk.save(cached_pk)
    cached_vk.write_text(json.dumps(vk_dict, indent=1))
    return pk, gverify.VerifyingKey(vk_dict)


def bench_inputs(n_levels: int, batch: int, device=None) -> dict:
    """The benchmark's batch: batch_to_arrays(mock_batch(n_levels, batch,
    seed=7)), numpy int32 arrays (the tree hashing runs on `device`)."""
    return inp.batch_to_arrays(
        inp.mock_batch(n_levels, batch, seed=7, device=device), n_levels)


def prover_rs(seed: int, batch: int, device) -> tuple:
    """r and s as the JAX bench.py's prover_rs draws them, on `device`."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in draw_rs(seed, batch))


def measure(prover: DeviceProver, vk: gverify.VerifyingKey, arrs: dict,
            iters: int, step: FusedStep | None = None) -> dict:
    """Times `iters` graph replays of the prover's step (captured here at
    the batch of `arrs` unless `step` is given) and as many eager
    prove_arrays; writes the stage file under build/bench/ and returns the
    result line's dict."""
    dev = prover.device
    if dev.type != "cuda":
        raise RuntimeError(f"bench: measures on the card, not on {dev}")
    nl = prover.circuit.n_levels
    batch = arrs["address"].shape[-1]
    if step is None:
        t0 = time.perf_counter()
        step = prover.capture(batch, cut=prover.takes_cut(arrs))
        log(f"capture (warm-up, capture, instantiation): "
            f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    proofs, pubs = step.prove_batch(arrs, seed=1)
    log(f"first prove_batch through the graph: "
        f"{time.perf_counter() - t0:.2f}s")
    ok = gverify.verify(vk, proofs[0], pubs[0])
    log(f"sample proof verifies: {ok}")

    stages: dict = {}
    prover.prove_arrays(arrs, *prover_rs(3, batch, dev),
                        stage_seconds=stages)
    msm_keys = ("msm_a", "msm_b1", "msm_b2", "msm_c")
    msm_pts = (prover.a_tab.shape[0] + 2 * prover.b1_tab.shape[0]
               + prover.c_tab.shape[0]) * batch
    stages["msm_mpoints_per_s"] = msm_pts / sum(
        stages[k] for k in msm_keys) / 1e6
    log(f"stages: {json.dumps(stages)}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = "" if nl == 16 else f"_{nl}"
    (OUT_DIR / f"bench_stages{suffix}.json").write_text(json.dumps(
        {"nlevels": nl, "batch": batch, "device": torch.cuda.get_device_name(
            dev), **stages}, indent=1))

    def loop(fn) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(iters):
            fn(arrs, *prover_rs(2 + i, batch, dev))
            torch.cuda.synchronize(dev)
        return batch * iters / (time.perf_counter() - t0)

    eager = loop(prover.prove_arrays)
    log(f"eager prove_arrays: {eager:.3f} proofs/s")
    replay = loop(step)
    return {"metric": f"zkCensus proofs/sec nlevels={nl} single-GPU "
                      f"batch={batch}, CUDA graph replay",
            "value": replay, "unit": "proofs/s", "verified": bool(ok),
            "msm_mpoints_per_s": stages["msm_mpoints_per_s"],
            "device": torch.cuda.get_device_name(dev)}


def main() -> int:
    nl, batch, iters = settings()
    dev = devices.resolve(None)
    circuit = CensusCircuit(nl)
    pk, vk = get_setup(circuit)
    t0 = time.perf_counter()
    arrs = bench_inputs(nl, batch, dev)
    log(f"inputs generated in {time.perf_counter() - t0:.1f}s")
    prover = DeviceProver(circuit, pk, device=dev)
    result = measure(prover, vk, arrs, iters)
    print(json.dumps(result), flush=True)
    return 0 if result["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())

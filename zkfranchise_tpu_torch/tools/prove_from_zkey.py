"""Key the prover from a snarkjs .zkey file alone and prove a mock batch:
the deployment shape of the prover (the counterpart of the zkey branch of
the JAX package's bench.py, which is how the nlevels=160 dev
configuration runs, since artifacts/zkCensus/dev/160 ships only the zkey).

The zkey is read and ingested (A and B matrices from its coefficient
section, so the quotient takes its A/B-only branch), a DeviceProver is
built from it, ``mock_batch(nlevels, batch, seed)`` is proved twice (the
second run timed per stage), and sampled proofs are verified against the
verification key file; a proof under another voter's signals must be
rejected.  Prints one JSON line and ``VERDICT: PASS|FAIL``.

    python -m zkfranchise_tpu_torch.tools.prove_from_zkey \\
        --zkey artifacts/zkCensus/dev/160/proving_key.zkey \\
        --vk artifacts/zkCensus/dev/160/verification_key.json \\
        --nlevels 160 --batch 16 [--ordering native] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from .. import inputs as inp
from ..groth16 import verify as gverify
from ..groth16.device import DeviceProver
from ..models.census import CensusCircuit
from ..utils import devices, zkey_compat
from . import check, verdict


def prove_from_zkey(data: bytes, n_levels: int, batch: int, device=None,
                    ordering: str = "native", seed: int = 7,
                    prove_seed: int = 1, timed: bool = True):
    """-> (proofs, publics, the zkey's VerifyingKey, report dict).  With
    `timed`, a second prove_arrays-equivalent run records per-stage
    seconds and peak device memory."""
    dev = devices.resolve(device)
    seconds = {}

    def lap(name, t0):
        seconds[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    circuit = CensusCircuit(n_levels)
    lap("circuit", t0)
    t0 = time.perf_counter()
    pk, vk, arrays = zkey_compat.ingest_zkey(data, cs=circuit.cs,
                                             ordering=ordering)
    lap("zkey_ingest", t0)
    t0 = time.perf_counter()
    prover = DeviceProver(circuit, pk, arrays=arrays, device=dev)
    lap("prover_init", t0)
    t0 = time.perf_counter()
    arrs = inp.batch_to_arrays(
        inp.mock_batch(n_levels, batch, seed=seed, device=dev), n_levels)
    lap("mock_batch", t0)
    t0 = time.perf_counter()
    proofs, pubs = prover.prove_batch(arrs, seed=prove_seed)
    lap("first_prove_batch", t0)
    report = {"nlevels": n_levels, "batch": batch, "device": str(dev),
              "zkey_bytes": len(data), "wires": pk.n_vars,
              "domain": pk.domain, "has_c_matrix": "c" in arrays,
              "nnz": {k: int(arrays[k][0].shape[0]) for k in ("a", "b")},
              "seconds": seconds}
    if timed:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        again, _ = prover.prove_batch(arrs, seed=prove_seed)
        lap("second_prove_batch", t0)
        report["proofs_per_s"] = batch / seconds["second_prove_batch"]
        report["second_run_equal"] = [p.to_dict() for p in again] == \
            [p.to_dict() for p in proofs]
        if dev.type == "cuda":
            report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
            report["card"] = torch.cuda.get_device_name(dev)
    return proofs, pubs, vk, report


def main(zkey: str, vk: str, n_levels: int, batch: int, device=None,
         ordering: str = "native") -> int:
    t0 = time.perf_counter()
    data = pathlib.Path(zkey).read_bytes()
    read_s = time.perf_counter() - t0
    proofs, pubs, zvk, report = prove_from_zkey(data, n_levels, batch,
                                                device, ordering)
    report["seconds"]["read_file"] = read_s
    vk_file = gverify.VerifyingKey(json.loads(pathlib.Path(vk).read_text()))
    failed: list = []
    check(failed, "zkey's vk equals the verification key file",
          zvk.to_dict() == vk_file.to_dict())
    t0 = time.perf_counter()
    for i in sorted({0, batch // 2, batch - 1}):
        check(failed, f"voter {i} verifies",
              gverify.verify(vk_file, proofs[i], pubs[i]))
    if batch > 1:
        check(failed, "proof 0 under voter 1's signals is rejected",
              not gverify.verify(vk_file, proofs[0], pubs[1]))
    if "second_run_equal" in report:
        check(failed, "second run gives the same proofs",
              report["second_run_equal"])
    report["seconds"]["verify"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return verdict(failed)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--zkey", required=True)
    ap.add_argument("--vk", required=True)
    ap.add_argument("--nlevels", type=int, required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ordering", default="native",
                    choices=["native", "census-circom"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args()
    sys.exit(main(a.zkey, a.vk, a.nlevels, a.batch, a.device, a.ordering))

"""The port's ShardedProver on 4 gloo ranks on the CPU, mesh (data 2,
model 2), at nlevels=4 from the committed dev/4 key: each rank joins the
world through runtime.init_distributed from the ZKF_* environment
(parallel/launch.py), proves its lanes with prove_batch(seed), and the
proofs equal DeviceProver(device="cpu").prove_batch(seed) byte for byte
(that prover is held byte for byte to the JAX package by
test_torch_prover.py); they verify against the committed vk and a
cross-voter proof is rejected.

The batch is 2, one voter a data slice: at 4 voters the CPU run of the
single-device prover alone takes about five minutes."""
import concurrent.futures
import json
import pathlib

import pytest
import torch

from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.groth16.device import DeviceProver
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.parallel import jobs, launch

torch.set_num_threads(1)

NL, BATCH, SEED = 4, 2, 5
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)


@pytest.fixture(scope="module")
def run():
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, BATCH, seed=1, device="cpu"), NL)

    def single_device():
        pk = tsetup.ProvingKey.load(ART / "proving_key.pkl")
        prover = DeviceProver(CensusCircuit(NL), pk, device="cpu")
        return prover.prove_batch(arrs, seed=SEED)

    # the single-device prover runs while the ranks do
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        want = pool.submit(single_device)
        ranks = launch.run(jobs.prove_job, 4, backend="gloo", timeout_s=900,
                           args=(str(ART / "proving_key.pkl"), NL, arrs,
                                 SEED, 2, "cpu"))
        return ranks, want.result()


def test_sharded_proofs_equal_single_device(run):
    ranks, (want_proofs, want_pubs) = run
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 2}] * 4
    assert [(r["data_index"], r["model_index"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["dist_ntt"] and not r["staged_through_host"]
               for r in ranks)
    # each rank keeps a quarter... of the tables, padded to a multiple of 2
    assert all(r["table_rows"]["c"] * 2 == r["padded_rows"]["c"]
               for r in ranks)
    got = sorted((r["lane0"], r["proofs"], r["publics"]) for r in ranks
                 if "proofs" in r)
    assert [lane for lane, _, _ in got] == [0, 1]
    proofs = [p for _, ps, _ in got for p in ps]
    pubs = [p for _, _, ps in got for p in ps]
    assert proofs == [json.dumps(p.to_dict()) for p in want_proofs]
    assert pubs == want_pubs


def test_sharded_proofs_verify(run):
    ranks, _ = run
    vk = tverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    got = sorted((r["lane0"], r["proofs"][0], r["publics"][0])
                 for r in ranks if "proofs" in r)
    (_, p0, pub0), (_, p1, pub1) = got
    assert tverify.verify(vk, tverify.Proof.from_json(p0), pub0)
    assert tverify.verify(vk, tverify.Proof.from_json(p1), pub1)
    assert not tverify.verify(vk, tverify.Proof.from_json(p0), pub1)

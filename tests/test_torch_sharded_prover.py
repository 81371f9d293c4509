"""The port's ShardedProver on 4 gloo ranks on the CPU, mesh (data 2,
model 2), at nlevels=4 from the committed dev/4 key: each rank joins the
world through runtime.init_distributed from the ZKF_* environment
(parallel/launch.py), proves its lanes with prove_batch(seed), and the
proofs equal DeviceProver(device="cpu").prove_batch(seed) byte for byte
(that prover is held byte for byte to the JAX package by
test_torch_prover.py); they verify against the committed vk and a
cross-voter proof is rejected.

The same rank job holds what a segmented capture of the step rests on
(ShardedStep records it on the card): the collective schedule is fixed
from call to call and equal on every rank, the axes' collectives into
given buffers equal the allocating ones, and the eager step makes host
tensors only in the constant caches.  Off the card the capture raises.

The batch is 2, one voter a data slice: at 4 voters the CPU run of the
single-device prover alone takes about five minutes."""
import concurrent.futures
import functools
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
from zkfranchise_tpu_torch.parallel.mesh import make_mesh
from zkfranchise_tpu_torch.parallel.prove import (ShardedProver, ShardedStep,
                                                  local_input_spec)
from zkfranchise_tpu_torch.tools import CONSTANT_CACHES

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
        ranks = launch.run(functools.partial(jobs.prove_job, probes=True), 4,
                           backend="gloo", timeout_s=900,
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


def test_collective_schedule_is_fixed_and_the_same_on_every_rank(run):
    """The cuts of a segmented capture: 12 all_to_all (four for each of
    the three coset transforms) and 5 all_gather (the quotient, the four
    MSMs), all over 'model', in the same order on both calls and on every
    rank."""
    ranks, _ = run
    schedules = [r["probes"]["schedules"] for r in ranks]
    assert all(first == second for first, second in schedules)
    first = schedules[0][0]
    assert all(s[0] == first for s in schedules)
    assert len(first) == 17
    ops = [op for op, _, _, _ in first]
    assert ops == ["all_to_all"] * 12 + ["all_gather"] * 5
    assert {(axis, dtype) for _, axis, _, dtype in first} == \
        {("model", "torch.int32")}


def test_axis_collectives_into_given_buffers(run):
    ranks, _ = run
    for r in ranks:
        check = r["probes"]["out_buffers"]
        assert sorted(check) == ["data", "model"]
        for ops in check.values():
            for res in ops.values():
                assert res["equal"] and res["into_out"]
                allocating, given = res["stats"]
                assert allocating == given and allocating[0] == 1


def test_sharded_step_makes_host_tensors_only_in_constant_caches(run):
    """A host copy inside the step would break its capture on the card."""
    ranks, _ = run
    for r in ranks:
        made = r["probes"]["host_tensors"]
        assert {caller for _, caller in made} <= CONSTANT_CACHES, made


def test_sharded_capture_refuses_the_cpu():
    prover = ShardedProver(CensusCircuit(NL), tsetup.ProvingKey.load(
        ART / "proving_key.pkl"), make_mesh(device="cpu"))
    with pytest.raises(RuntimeError, match="on the card"):
        prover.capture(BATCH)
    with pytest.raises(RuntimeError, match="on the card"):
        ShardedStep(prover, BATCH)


def test_local_input_spec_cuts_the_voter_axis():
    spec = local_input_spec(NL, 4, 2)
    assert spec["censusSiblings"] == (NL + 1, 21, 2)
    assert spec["electionId"] == (2, 21, 2)
    assert spec["address"] == (21, 2)
    with pytest.raises(ValueError, match="does not split"):
        local_input_spec(NL, 3, 2)

"""The port's fused_step (the whole proving step as one function), its
capture as a CUDA graph (FusedStep), the step's input check and the bench
entry's inputs, against the JAX package on the CPU at nlevels=4.

One CPU run of the step at batch 1 takes about 110 s here (plain PyTorch
versions of the kernels, one thread), so the file proves once; the card
tests (tests/test_torch_cuda.py) hold the replayed graph against
prove_arrays."""
import json
import pathlib

import numpy as np
import pytest
import torch

import bench as jbench
from zkfranchise_tpu import inputs as jinputs
from zkfranchise_tpu.groth16 import prove as jprove
from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import CONSTANT_CACHES, host_tensors
from zkfranchise_tpu_torch.tools import bench as tbench

torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)
@pytest.fixture(scope="module")
def arrs():
    return tinputs.batch_to_arrays(tinputs.mock_batch(NL, 2, seed=1,
                                                      device="cpu"), NL)


@pytest.fixture(scope="module")
def prover():
    return tdevice.DeviceProver(
        CensusCircuit(NL), tsetup.ProvingKey.load(ART / "proving_key.pkl"),
        device="cpu")


@pytest.fixture(scope="module")
def fused(prover, arrs):
    """fused_step on voter 0 at batch 1, with r and s of
    prove_batch(seed=11) -> (planes, the host tensors it made)."""
    inputs = {k: torch.as_tensor(v[..., :1]) for k, v in arrs.items()}
    r, s = (torch.as_tensor(x) for x in tdevice.draw_rs(11, 1))
    made: list = []
    K.reset_launches()
    with host_tensors(made):
        planes = prover.fused_step(inputs, r, s)
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU: no kernels
    return planes, made


def test_fused_step_proof_byte_identical_to_host_prover(prover, arrs, fused):
    planes, _ = fused
    assert [tuple(p.shape) for p in planes] == [(63, 1), (126, 1), (63, 1),
                                                (8, 21, 1), (2,)]
    proofs, pubs = prover.finalize(*planes[:4])
    rng = np.random.default_rng(11)
    r = int.from_bytes(rng.bytes(31), "big") % lm.FR.p
    s = int.from_bytes(rng.bytes(31), "big") % lm.FR.p
    w = prover.circuit.witness({k: torch.as_tensor(v) for k, v in
                                arrs.items()})
    w0, w1 = (lm.lm_to_ints(lm.from_mont(w)[..., j:j + 1]) for j in range(2))
    host = jprove.prove_host(jsetup.ProvingKey.load(ART / "proving_key.pkl"),
                             JaxCircuit(NL).cs.constraints, w0, r, s)
    assert json.dumps(proofs[0].to_dict()) == json.dumps(host.to_dict())
    assert pubs[0] == w0[1:1 + prover.pk_meta[1]]
    vk = tverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    assert tverify.verify(vk, proofs[0], pubs[0])
    assert not tverify.verify(vk, proofs[0], w1[1:1 + prover.pk_meta[1]])


def test_fused_step_makes_host_tensors_only_in_constant_caches(fused):
    """A host copy inside the step would break its capture on the card;
    the caches are filled by the capture's warm-up run."""
    _, made = fused
    assert {caller for _, caller in made} <= CONSTANT_CACHES, made


def test_fused_step_refuses_the_cpu(prover):
    with pytest.raises(RuntimeError, match="on the card"):
        tdevice.FusedStep(prover, 1)
    with pytest.raises(RuntimeError, match="on the card"):
        prover.capture(2)


def test_input_spec_is_batch_to_arrays(arrs):
    spec = tdevice.input_spec(NL, 2)
    assert {k: v.shape for k, v in arrs.items()} == spec
    assert all(v.dtype == np.int32 for v in arrs.values())
    tdevice.check_step_inputs(spec, arrs, *tdevice.draw_rs(3, 2))
    tdevice.check_step_inputs(
        spec, {k: torch.as_tensor(v) for k, v in arrs.items()},
        *(torch.as_tensor(x) for x in tdevice.draw_rs(3, 2)))


def _bad_inputs(arrs, case):
    """(inputs, r, s) with one fault."""
    inputs = dict(arrs)
    r, s = tdevice.draw_rs(3, 2)
    if case == "missing_key":
        del inputs["sikRoot"]
    elif case == "extra_key":
        inputs["weight"] = arrs["voteWeight"]
    elif case == "batch":
        inputs["address"] = arrs["address"][..., :1]
    elif case == "siblings":
        inputs["censusSiblings"] = arrs["censusSiblings"][:-1]
    elif case == "dtype":
        inputs["password"] = arrs["password"].astype(np.int64)
    elif case == "tensor_dtype":
        inputs["nullifier"] = torch.as_tensor(arrs["nullifier"]).long()
    elif case == "r_shape":
        r = r[:, :1]
    elif case == "s_dtype":
        s = s.astype(np.uint32)
    return inputs, r, s


@pytest.mark.parametrize("case", ["missing_key", "extra_key", "batch",
                                  "siblings", "dtype", "tensor_dtype",
                                  "r_shape", "s_dtype"])
def test_check_step_inputs_raises(arrs, case):
    with pytest.raises(ValueError, match="step inputs"):
        tdevice.check_step_inputs(tdevice.input_spec(NL, 2),
                                  *_bad_inputs(arrs, case))


def test_draw_rs_is_prove_batch_draw():
    r, s = tdevice.draw_rs(5, 3)
    rng = np.random.default_rng(5)
    ints = [int.from_bytes(rng.bytes(31), "big") % lm.FR.p
            for _ in range(6)]
    assert r.dtype == np.int32 and r.shape == (21, 3)
    assert lm.lm_to_ints(r) == ints[:3] and lm.lm_to_ints(s) == ints[3:]


def test_bench_inputs_and_rs_equal_jax_bench(monkeypatch):
    got = tbench.bench_inputs(NL, 2, "cpu")
    want = jinputs.batch_to_arrays(jinputs.mock_batch(NL, 2, seed=7), NL)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    monkeypatch.setattr(jbench, "BATCH", 2)
    for seed in (2, 3, 4):
        jr, js = jbench.prover_rs(None, seed)
        tr, ts = tbench.prover_rs(seed, 2, "cpu")
        assert np.array_equal(np.asarray(jr), tr.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())


def test_bench_settings(monkeypatch):
    for k in ("BENCH_NLEVELS", "BENCH_BATCH", "BENCH_ITERS"):
        monkeypatch.delenv(k, raising=False)
    assert tbench.settings() == (16, 128, 3)
    monkeypatch.setenv("BENCH_NLEVELS", "4")
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_ITERS", "1")
    assert tbench.settings() == (4, 2, 1)


def test_bench_measure_refuses_the_cpu(prover, arrs):
    with pytest.raises(RuntimeError, match="on the card"):
        tbench.measure(prover, None, arrs, 1)


@pytest.mark.slow
def test_fused_step_planes_equal_jax_fused_step():
    """The port's fused_step against the JAX package's, on the inputs and
    synthetic key of __graft_entry__.entry() (nlevels=4, batch 2, r =
    [3, 5], s = [7, 11]): about 110 s for each package here."""
    import __graft_entry__ as graft
    from zkfranchise_tpu_torch.groth16 import qap
    from zkfranchise_tpu_torch.ops import ec

    jstep, (jarrs, jr, js) = graft.entry()
    want = jstep(jarrs, jr, js)
    circuit = CensusCircuit(NL)
    cs = circuit.cs
    m = cs.num_vars
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    g1, g2 = ec.G1_GEN, ec.G2_GEN
    pk = tsetup.ProvingKey(
        n_vars=m, n_public=cs.num_public, domain=n,
        alpha_g1=g1, beta_g1=g1, beta_g2=g2, delta_g1=g1, delta_g2=g2,
        a_g1=[g1] * m, b_g1=[g1] * m, b_g2=[g2] * m,
        k_g1=[g1] * (m - cs.num_public - 1), h_g1=[g1] * n)
    prover = tdevice.DeviceProver(circuit, pk, device="cpu")
    got = prover.fused_step(
        {k: torch.as_tensor(np.asarray(v)) for k, v in jarrs.items()},
        torch.as_tensor(lm.ints_to_lm([3, 5])),
        torch.as_tensor(lm.ints_to_lm([7, 11])))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))

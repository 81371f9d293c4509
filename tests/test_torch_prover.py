"""Port witness, proving-key tables and end-to-end proof against the JAX
package and its host prover at nlevels=4, batch 2."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from zkfranchise_tpu import inputs as jinputs
from zkfranchise_tpu.groth16 import device as jdevice
from zkfranchise_tpu.groth16 import prove as jprove
from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.groth16.device import DeviceProver
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)


@pytest.fixture(scope="module")
def batch():
    return tinputs.mock_batch(NL, 2, seed=1, device="cpu")


@pytest.fixture(scope="module")
def arrs(batch):
    return tinputs.batch_to_arrays(batch, NL)


@pytest.fixture(scope="module")
def circuit():
    return CensusCircuit(NL)


@pytest.fixture(scope="module")
def witness(circuit, arrs):
    return circuit.witness({k: torch.as_tensor(v) for k, v in arrs.items()})


@pytest.fixture(scope="module")
def pk():
    return tsetup.ProvingKey.load(ART / "proving_key.pkl")


def test_mock_batch_matches_jax(batch, arrs):
    want = jinputs.mock_batch(NL, 2, seed=1)
    assert [c.to_json() for c in batch] == [c.to_json() for c in want]
    jarrs = jinputs.batch_to_arrays(want, NL)
    assert all(np.array_equal(arrs[k], jarrs[k]) for k in jarrs)


def test_witness_matches_jax(circuit, arrs, witness):
    want = jax.jit(JaxCircuit(NL).witness)(arrs)
    assert np.array_equal(np.asarray(want), witness.numpy())
    plain = lm.from_mont(witness)
    for voter in range(2):
        w = lm.lm_to_ints(plain[..., voter:voter + 1])
        assert circuit.cs.check_satisfied(w) is None


def test_prover_tables_match_jax(circuit, pk):
    """The port carries the JAX prover's proving-key tables and R1CS
    arrays over unchanged."""
    tp = DeviceProver(circuit, pk, device="cpu")
    jp = jdevice.DeviceProver(JaxCircuit(NL),
                              jsetup.ProvingKey.load(ART / "proving_key.pkl"))
    for name in ("a_tab", "b1_tab", "b2_tab", "c_tab", "alpha", "beta1",
                 "beta2"):
        assert np.array_equal(np.asarray(getattr(jp, name)),
                              getattr(tp, name).numpy()), name
    assert np.array_equal(jp.b_nz, tp.b_nz)
    for k in ("a", "b", "c"):
        for x, y in zip(jp.arrays[k], tp.arrays[k]):
            assert np.array_equal(x, y)
    for k in ("num_constraints", "num_vars", "num_public"):
        assert jp.arrays[k] == tp.arrays[k]


def test_proofs_byte_identical_to_host_prover(circuit, pk, arrs, witness):
    """Voter 0 of the two-voter batch, proved alone (batch 1 keeps the
    CPU run of the plain versions inside the test budget)."""
    prover = DeviceProver(circuit, pk, device="cpu")
    K.reset_launches()
    proofs, pubs = prover.prove_batch({k: v[..., :1] for k, v in
                                       arrs.items()}, seed=11)
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU: no kernels
    # r and s drawn exactly as prove_batch draws them
    rng = np.random.default_rng(11)
    r = int.from_bytes(rng.bytes(31), "big") % lm.FR.p
    s = int.from_bytes(rng.bytes(31), "big") % lm.FR.p
    plain = lm.from_mont(witness)
    w0, w1 = (lm.lm_to_ints(plain[..., j:j + 1]) for j in range(2))
    host = jprove.prove_host(jsetup.ProvingKey.load(ART / "proving_key.pkl"),
                             JaxCircuit(NL).cs.constraints, w0, r, s)
    assert len(proofs) == 1
    assert json.dumps(proofs[0].to_dict()) == json.dumps(host.to_dict())
    assert pubs[0] == w0[1:1 + pk.n_public]
    vk = tverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    assert tverify.verify(vk, proofs[0], pubs[0])
    assert not tverify.verify(vk, proofs[0], w1[1:1 + pk.n_public])

"""A prover keyed ONLY from an ingested producer-ordered zkey (A and B
matrices from its coefficient section, the A/B-only quotient) proves on
the CPU at nlevels=4; the case the JAX package's test_zkey_compat.py marks
slow.  It goes through tools.prove_from_zkey, the entry point that keys a
prover from a zkey file.  A file of its own: the two proofs take about
three minutes."""
import json
import pathlib

import pytest
import torch

from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import prove_from_zkey as tool
from zkfranchise_tpu_torch.utils import serialize, zkey_compat

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)


def _batch(seed):
    return tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, 1, seed=seed, device="cpu"), NL)


def _publics(circuit, batch, n_public):
    w = circuit.witness({k: torch.as_tensor(v) for k, v in batch.items()})
    return lm.lm_to_ints(lm.from_mont(w))[1:1 + n_public]


@pytest.fixture(scope="module")
def producer_bytes():
    """The committed dev/4 key as zkey bytes in the census-circom
    producer ordering."""
    circuit = CensusCircuit(NL)
    pkl = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    vk_file = tverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    z = zkey_compat.zkey_from_pk(circuit.cs, pkl, vk_file)
    return serialize.write_zkey(zkey_compat.export_in_ordering(
        z, zkey_compat.census_circom_perm(circuit.cs)))


def test_ingested_producer_zkey_proves(producer_bytes):
    """The proof verifies under the zkey's vk, is rejected under another
    voter's signals, and is byte-identical to the proof of the pkl-keyed
    prover for the same seed."""
    K.reset_launches()
    proofs, pubs, vk, report = tool.prove_from_zkey(
        producer_bytes, NL, 1, "cpu", "census-circom", seed=3, prove_seed=11,
        timed=False)
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU: no kernels
    assert not report["has_c_matrix"]              # zkeys carry only A/B
    assert report["zkey_bytes"] == len(producer_bytes)
    assert tverify.verify(vk, proofs[0], pubs[0])
    circuit = CensusCircuit(NL)
    other = _publics(circuit, _batch(4), len(pubs[0]))
    assert other != pubs[0]
    assert not tverify.verify(vk, proofs[0], other)
    pkl = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    want, wpubs = tdevice.DeviceProver(
        circuit, pkl, device="cpu").prove_batch(_batch(3), seed=11)
    assert json.dumps(proofs[0].to_dict()) == json.dumps(want[0].to_dict())
    assert pubs == wpubs


def test_prove_from_zkey_defaults_to_the_card(tmp_path, producer_bytes):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    path = tmp_path / "key.zkey"
    path.write_bytes(producer_bytes)
    with pytest.raises(RuntimeError):
        tool.main(str(path), str(ART / "verification_key.json"), NL, 1)

"""One real run of the port's ProofStream on the CPU at nlevels=4: three
voters at batch_size=2 (slices 2, 1) through a DeviceProver, the written
proof.json files byte for byte against the JAX package's host prover for
the same witness, r and s.  A file of its own: the two slices take about
three minutes."""
import io
import json
import pathlib

import numpy as np
import torch

from zkfranchise_tpu.groth16 import prove as jprove
from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import prove as tprove
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.groth16.device import DeviceProver
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import lm
from zkfranchise_tpu_torch.stream import ProofStream
from zkfranchise_tpu_torch.utils.metrics import Metrics

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)
SEED = 5


def _draw(seed, count):
    """r and s as prove_batch draws them for a slice of `count` voters."""
    rng = np.random.default_rng(seed)
    r = [int.from_bytes(rng.bytes(31), "big") % lm.FR.p for _ in range(count)]
    s = [int.from_bytes(rng.bytes(31), "big") % lm.FR.p for _ in range(count)]
    return r, s


def test_real_stream_files_equal_host_prover(tmp_path):
    circuit = CensusCircuit(NL)
    pk = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    voters = tinputs.mock_batch(NL, 3, seed=2, device="cpu")
    prover = DeviceProver(circuit, pk, device="cpu")
    sink = io.StringIO()
    stream = ProofStream(prover, tmp_path, batch_size=2,
                         metrics=Metrics(sink))
    assert stream.run(voters, seed=SEED) == 3 and stream.cursor == 3
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    # a slice: one prove_batch record, and the stream's and the step's
    # spans with its base and batch, the step's inside prove_batch
    assert [(r["kind"], r.get("name", r.get("stage")), r["base"],
             r["batch"]) for r in records] == [
        (kind, name, base, size) for base, size in ((0, 2), (2, 1))
        for kind, name in (("span", "stream.arrays"), ("span", "step.enqueue"),
                           ("span", "step.wait"), ("span", "step.finalize"),
                           ("stage", "prove_batch"), ("span", "stream.files"))]
    stages = [r for r in records if r["kind"] == "stage"]
    assert [r["parent"] for r in records if r.get("name", "").startswith(
        "step.")] == [stages[0]["id"]] * 3 + [stages[1]["id"]] * 3

    arrs = tinputs.batch_to_arrays(voters, NL)
    plain = lm.from_mont(circuit.witness(
        {k: torch.as_tensor(v) for k, v in arrs.items()}))
    rs = {}
    for base, size in ((0, 2), (2, 1)):               # seed + base
        r, s = _draw(SEED + base, size)
        rs.update({base + i: (r[i], s[i]) for i in range(size)})
    jpk = jsetup.ProvingKey.load(ART / "proving_key.pkl")
    jcs = JaxCircuit(NL).cs
    vk_path = ART / "verification_key.json"
    for i in range(3):
        w = lm.lm_to_ints(plain[..., i:i + 1])
        d = tmp_path / f"proof_{i:08d}"
        host = jprove.prove_host(jpk, jcs.constraints, w, *rs[i])
        assert (d / "proof.json").read_text() == json.dumps(host.to_dict())
        assert (d / "signals.json").read_text() == \
            json.dumps([str(x) for x in w[1:1 + pk.n_public]])
        assert tverify.verify_files(str(vk_path), str(d / "proof.json"),
                                    str(d / "signals.json"))
        # the port's own host prover gives the same proof
        mine = tprove.prove_host(pk, circuit.cs.constraints, w, *rs[i])
        assert mine.to_dict() == host.to_dict()
    assert not tverify.verify_files(
        str(vk_path), str(tmp_path / "proof_00000000" / "proof.json"),
        str(tmp_path / "proof_00000001" / "signals.json"))

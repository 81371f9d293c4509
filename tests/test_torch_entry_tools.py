"""The port's compile_circuit tool against the committed dev/4 files and
the JAX package's functions, at nlevels=4 into a temporary directory.

scripts/compile_circuit.py itself is never run here: it writes into the
repo's artifacts/.  The port's tool must write only under its --out.
"""
import json
import pathlib

import pytest

from zkfranchise_tpu.groth16 import qap as jqap
from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.models.census import CensusCircuit as JCensusCircuit
from zkfranchise_tpu.utils import serialize as jser
from zkfranchise_tpu_torch.groth16 import ceremony
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.tools import compile_circuit

ROOT = pathlib.Path(__file__).resolve().parent.parent
ART = ROOT / "artifacts" / "zkCensus" / "dev" / "4"


def tree_state(root: pathlib.Path) -> dict:
    """path -> (size, mtime) of every file under root."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    out = tmp_path_factory.mktemp("compile")
    before = tree_state(ROOT / "artifacts")
    assert compile_circuit.main(["--out", str(out), "--nlevels", "4"]) == 0
    return out, before


def test_compile_circuit_writes_only_under_out(compiled):
    out, before = compiled
    assert tree_state(ROOT / "artifacts") == before
    assert sorted(tree_state(out)) == [
        "zkCensus/dev/4/proving_key.pkl", "zkCensus/dev/4/proving_key.zkey",
        "zkCensus/dev/4/verification_key.json",
        "zkCensus/dev/circuits-info.md"]
    manifest = (out / "zkCensus" / "dev" / "circuits-info.md").read_text()
    assert manifest.startswith("### dev 4\n")
    assert "- verification_key.json: `" in manifest


def test_compile_circuit_vk_bytes_equal_committed(compiled):
    got = (compiled[0] / "zkCensus/dev/4/verification_key.json").read_bytes()
    assert got == (ART / "verification_key.json").read_bytes()


def test_compile_circuit_pkl_fields_equal_committed(compiled):
    pk = tsetup.ProvingKey.load(compiled[0] / "zkCensus/dev/4/proving_key.pkl")
    want = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    for f in ceremony.PK_FIELDS + ("n_vars", "n_public", "domain"):
        assert getattr(pk, f) == getattr(want, f), f


def test_compile_circuit_zkey_bytes_equal_jax(compiled):
    """The zkey against JAX serialize.write_zkey of the same ZkeyData,
    built here from the JAX package's circuit, setup and binding rows."""
    cs = JCensusCircuit(4).cs
    pk, vk = jsetup.dev_setup(cs)
    rows = list(cs.constraints) + jqap.binding_rows(cs.num_public)
    coeffs = []
    for r, (a, b, _c) in enumerate(rows):
        coeffs += [(0, r, i, cf) for i, cf in a.items()]
        coeffs += [(1, r, i, cf) for i, cf in b.items()]
    z = jser.ZkeyData(
        n_vars=pk.n_vars, n_public=pk.n_public, domain=pk.domain,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        gamma_g2=vk.gamma_2, delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        ic=vk.ic, coeffs=coeffs, a_g1=pk.a_g1, b_g1=pk.b_g1,
        b_g2=pk.b_g2, c_g1=pk.k_g1, h_g1=pk.h_g1)
    got = (compiled[0] / "zkCensus/dev/4/proving_key.zkey").read_bytes()
    assert got == jser.write_zkey(z)
    assert json.loads((compiled[0] / "zkCensus/dev/4/verification_key.json")
                      .read_text()) == vk.to_dict()


def test_compile_circuit_requires_out():
    with pytest.raises(SystemExit):
        compile_circuit.main(["--nlevels", "4"])

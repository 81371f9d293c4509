"""Port host layer: verifier, proving-key loading, and the rule that the
port imports neither jax nor the JAX package."""
import ast
import json
import pathlib
import subprocess
import sys

from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify

ROOT = pathlib.Path(__file__).resolve().parent.parent
ART = ROOT / "artifacts" / "zkCensus" / "dev" / "4"
PORT = ROOT / "zkfranchise_tpu_torch"


def _load_json(name):
    return json.loads((ART / name).read_text())


def test_verify_committed_proof():
    vk = tverify.VerifyingKey(_load_json("verification_key.json"))
    proof = tverify.Proof(_load_json("proof.json"))
    signals = _load_json("signals.json")
    assert tverify.verify(vk, proof, signals)
    tampered = list(signals)
    tampered[2] = str(int(tampered[2]) + 1)
    assert not tverify.verify(vk, proof, tampered)


def test_proving_key_load_matches_jax():
    pk = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    pkj = jsetup.ProvingKey.load(ART / "proving_key.pkl")
    assert type(pk) is tsetup.ProvingKey
    for field in ("n_vars", "n_public", "domain", "alpha_g1", "beta_g1",
                  "beta_g2", "delta_g1", "delta_g2", "a_g1", "b_g1", "b_g2",
                  "k_g1", "h_g1"):
        assert getattr(pk, field) == getattr(pkj, field), field


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_port_imports_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'zkfranchise_tpu' not in sys.modules\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "zkfranchise_tpu"), \
                    f"{path}: imports {name}"

"""The plain reference against upstream's committed artifacts and
circomlibjs's published vectors."""
import ast
import json
import random
from pathlib import Path

from benchmark.reference import census, groth16, poseidon, smt

ROOT = Path(__file__).resolve().parents[2]
DEV4 = ROOT / "artifacts" / "zkCensus" / "dev" / "4"


def _load(name):
    return json.loads((DEV4 / name).read_text())


def test_poseidon_circomlibjs_vectors():
    # circomlibjs test/poseidon.js
    assert poseidon.hash_([1, 2]) == int(
        "7853200120776062878684798364095072458815029376092732009249414926327459813530")
    assert poseidon.hash_([1, 2, 3, 4]) == int(
        "18821383157269793795438455681495246036402687001665670618754263018637548127333")


def test_signals_equal_committed_dev4():
    signals, holds = census.signals(_load("inputs_example.json"))
    assert holds
    assert [str(x) for x in signals] == _load("signals.json")


def test_statement_fails_on_a_wrong_sibling():
    inputs = _load("inputs_example.json")
    inputs["censusSiblings"][1] = "12345"
    assert not census.signals(inputs)[1]


def test_verifier_accepts_dev4_proof():
    vk = groth16.VerifyingKey(_load("verification_key.json"))
    proof = groth16.parse_proof(_load("proof.json"))
    assert groth16.verify(vk, proof, _load("signals.json"))


def test_verifier_rejects_a_tampered_signal():
    vk = groth16.VerifyingKey(_load("verification_key.json"))
    proof = groth16.parse_proof(_load("proof.json"))
    signals = _load("signals.json")
    signals[2] = str(int(signals[2]) + 1)
    assert not groth16.verify(vk, proof, signals)


def test_batched_check_accepts_right_proofs_and_rejects_a_tampered_one():
    vk = groth16.VerifyingKey(_load("verification_key.json"))
    proof = groth16.parse_proof(_load("proof.json"))
    signals = _load("signals.json")
    tampered = signals[:]
    tampered[2] = str(int(tampered[2]) + 1)
    rng = random.Random(5)
    assert groth16.verify_batch(vk, [(proof, signals)] * 3, rng)
    assert not groth16.verify_batch(
        vk, [(proof, signals), (proof, tampered), (proof, signals)], rng)


def test_a_moved_point_is_not_well_formed():
    d = _load("proof.json")
    d["pi_c"][0] = str(int(d["pi_c"][0]) + 1)
    assert not groth16.well_formed(groth16.parse_proof(d))


def test_tree_build_and_root_check_agree():
    leaves = {k: 100 + k for k in (3, 5, 12, 7, 1 << 40, 9)}
    root, sibs = smt.build(leaves, 64)
    for k, v in leaves.items():
        padded = sibs[k] + [0] * (65 - len(sibs[k]))
        assert smt.root_from_path(k, v, padded) == root
    assert smt.root_from_path(3, 101, sibs[3] + [0] * 50) != root


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "zkfranchise_tpu",
                                  "zkfranchise_tpu_torch", "torch", "benchmark"}
        assert not found, (path.name, found)

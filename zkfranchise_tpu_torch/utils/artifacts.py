"""Artifact store: directory layout + sha256 manifest.

Mirrors artifacts/<name>/<env>/<nlevels>/ with the file names upstream
commits (circuit.wasm is replaced by the native witness pipeline;
proving_key.pkl / .zkey replace the snarkjs zkey) and the circuits-info.md
checksum manifest that upstream's circuit-compiler.sh appends.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

FILES = ("proving_key.pkl", "proving_key.zkey", "verification_key.json",
         "inputs_example.json", "proof.json", "signals.json")


def sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(env_dir: Path) -> Path:
    """Write per-nlevels artifact checksums to circuits-info.md, in the
    format of artifacts/zkCensus/dev/circuits-info.md."""
    manifest = env_dir / "circuits-info.md"
    lines = []
    for nl_dir in sorted(p for p in env_dir.iterdir() if p.is_dir()):
        lines.append(f"### {env_dir.name} {nl_dir.name}\n")
        for name in FILES:
            f = nl_dir / name
            if f.exists():
                lines.append(f"- {name}: `{sha256_file(f)}`\n")
        lines.append("\n")
    manifest.write_text("".join(lines))
    return manifest


def save_proof_artifacts(out_dir: Path, proof_dict: dict,
                         signals: list) -> None:
    """proof.json + signals.json in the snarkjs JSON shapes."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "proof.json", "w") as f:
        json.dump(proof_dict, f)
    with open(out_dir / "signals.json", "w") as f:
        json.dump([str(s) for s in signals], f)

"""The port's client_prove tool on the CPU at nlevels=4, batch 1, keyed
from the committed dev/4 files: every proof verifies and the three files
land in --out only.

examples/client_prove.py itself is never run here: it overwrites the
committed artifacts/zkCensus/dev/<nl>/proof.json and signals.json.  Those
committed files predate that script (they were added in an earlier
commit), so the tool's output is verified, not compared with them.
"""
import json
import pathlib

import pytest
import torch

from zkfranchise_tpu_torch.groth16 import verify as gverify
from zkfranchise_tpu_torch.tools import client_prove

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
ART = ROOT / "artifacts" / "zkCensus" / "dev" / "4"


def tree_state(root: pathlib.Path) -> dict:
    """path -> (size, mtime) of every file under root."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_client_prove_cpu_verifies_and_writes_only_under_out(tmp_path):
    out = tmp_path / "out"
    before = tree_state(ROOT / "artifacts")
    rc = client_prove.main(["--out", str(out), "--key-dir", str(ART),
                            "--nlevels", "4", "--batch", "1",
                            "--device", "cpu"])
    assert rc == 0
    assert tree_state(ROOT / "artifacts") == before
    assert sorted(p.name for p in out.iterdir()) == [
        "inputs_example.json", "proof.json", "signals.json"]
    assert gverify.verify_files(str(ART / "verification_key.json"),
                                str(out / "proof.json"),
                                str(out / "signals.json"))
    signals = json.loads((out / "signals.json").read_text())
    assert len(signals) == 8 and all(isinstance(s, str) for s in signals)


def test_client_prove_requires_out():
    with pytest.raises(SystemExit):
        client_prove.main(["--nlevels", "4"])

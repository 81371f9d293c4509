"""On the card: the comparison's control, planted in the program at a
cell's own size, comes out not correct, and the program as it is comes
out correct.  Skips without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _control(plant: str, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "tools" / "control.py"),
         "--workload", "nl160-backlog", "--seeds", str(seed), "--seconds",
         "3", "--plant", plant], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    got = _control("control", 2**31 + 3)
    assert not got["correct"]
    assert got["checks"]["rejected"]["value"] > 0


@pytest.mark.cuda
def test_program_is_correct_on_the_card(card):
    assert _control("none", 2**31 + 4)["correct"]

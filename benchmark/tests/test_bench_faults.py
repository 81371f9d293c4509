"""A whole run of the harness on the CPU -- voters from the seed, the
stream's window, the read-back and the comparison with the reference --
past its look for a card, with the program replaced by a stand-in that
proves with a trapdoor (bench_stub.py): right proofs come out correct,
and each fault a run of these cells can have, planted where the proof is
made, comes out not correct.  (The cells run on one card: no exchange
between cards to leave out.)"""
import subprocess
import sys
import time
from pathlib import Path

import pytest

import bench_stub
from benchmark.harness import cell, check, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)


def _cell(loop: str) -> spec.Cell:
    config = {"name": "stub-nl4-b2", "nlevels": 4, "batch_size": 2,
              "pool_voters": 6}
    traffic = {"name": "stub", "loop": loop, "rate_per_s": 12.0}
    like = "nl160-backlog" if loop == "closed" else "nl160-arrivals"
    metrics = [m for m in BENCH["end_to_end"] if spec.applies(m, like)]
    return spec.Cell("stub", 1, "stub-nl4-b2", config, "stub", traffic,
                     end_to_end=metrics)


def _run(loop, fault, seed=2**31 + 9, seconds=0.5):
    env = bench_stub.StubEnv(ROOT, BENCH, fault)
    return cell.execute(_cell(loop), seed, seconds, False, env,
                        time.perf_counter())[0]


def test_sample_meets_every_lane_of_every_slice_size():
    slices = [(0, 8), (8, 8), (16, 4), (20, 2), (22, 1)]
    chosen = check.sample(23, 2**31 + 1, slices)
    lanes = {(b, i - base) for base, b in slices for i in chosen
             if base <= i < base + b}
    assert lanes == {(b, j) for _, b in slices for j in range(b)}
    assert {0, 22} <= set(chosen)
    assert chosen == check.sample(23, 2**31 + 1, slices)


def test_right_proofs_are_correct_closed_loop():
    res = _run("closed", None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s"}
    assert list(res["checks"]) == list(check.LIMITS)
    assert list(res)[-1] == "checks"


def test_right_proofs_are_correct_open_loop():
    res = _run("open", None, seconds=1.0)
    assert res["correct"] and res["attempted"] == 12
    assert set(res["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("fault, caught_by", [
    ("stale", "signals_wrong"),          # the state returned unchanged
    ("half", "signals_wrong"),           # half of the batch left out
    ("altered", "malformed"),            # an answer altered where made
    ("unsound", "rejected"),             # the control: well formed, unsound
])
def test_a_planted_fault_is_not_correct(fault, caught_by):
    res = _run("closed", fault)
    assert not res["correct"]
    assert res["checks"][caught_by]["value"] > 0
    assert res["failed"] > 0


JAX_READER = """
import sys
sys.path.insert(0, {fake!r})
import jax


def read(run):
    return 1.0
"""

DRIVE = """
import sys, time
sys.path[:0] = [{root!r}, {tests!r}]
import bench_stub
import benchmark.run
from benchmark.harness import cell, spec
from test_bench_faults import _cell
bench = {{**spec.load(), "paths": [{bench_dir!r}]}}
c = _cell("closed")
c.end_to_end = [{{"name": {metric!r}, "unit": "s"}}]
rc = benchmark.run.report(*cell.execute(
    c, 7, 0.3, False, bench_stub.StubEnv(spec.ROOT, bench),
    time.perf_counter()))
print("exit", rc, file=sys.stderr)
"""


@pytest.mark.parametrize("imports_jax", [False, True])
def test_no_result_where_a_reader_loads_jax(tmp_path, imports_jax):
    """The look for JAX comes after every reader has run: a metric's reader
    that imports a module named jax leaves the run without a result."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    (tmp_path / "bench" / "metrics").mkdir(parents=True)
    reader = JAX_READER.format(fake=str(fake)) if imports_jax else \
        "def read(run):\n    return 1.0\n"
    (tmp_path / "bench" / "metrics" / "stub_metric.py").write_text(reader)
    code = DRIVE.format(root=str(ROOT), tests=str(Path(__file__).parent),
                        bench_dir=str(tmp_path / "bench"),
                        metric="stub_metric")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    if imports_jax:
        assert out.stdout.strip() == ""
        assert "exit 4" in out.stderr and "'jax'" in out.stderr
    else:
        assert '"correct": true' in out.stdout.strip().splitlines()[-1]
        assert "exit 0" in out.stderr

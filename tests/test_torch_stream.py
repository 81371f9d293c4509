"""The port's ProofStream (stream.py) with a stub prover, mirroring the JAX
package's stream tests (crash after two batches, resume, no-op third run,
the power-of-two tail ladder), and file by file against the JAX package's
ProofStream driven by the same stub.  (A real run on the CPU is in
test_torch_stream_prove.py.)"""
import io
import json

import pytest

from zkfranchise_tpu import inputs as jinputs
from zkfranchise_tpu.stream import ProofStream as JaxProofStream
from zkfranchise_tpu.utils.metrics import Metrics as JaxMetrics
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.stream import ProofStream, _prev_pow2
from zkfranchise_tpu_torch.utils.metrics import Metrics


class _StubProver:
    """Duck-typed stand-in for DeviceProver: ProofStream only touches
    .circuit.n_levels and .prove_batch.  Counts calls so the resume test
    can assert no batch is re-proved."""

    class _C:
        n_levels = 16

    circuit = _C()

    def __init__(self, fail_after_batches=None):
        self.calls = 0
        self.sizes = []
        self.seeds = []
        self.fail_after = fail_after_batches

    def prove_batch(self, arrs, seed=0):
        if self.fail_after is not None and self.calls >= self.fail_after:
            raise RuntimeError("injected crash")
        self.calls += 1
        B = arrs["address"].shape[-1]
        self.sizes.append(B)
        self.seeds.append(seed)
        first = int(arrs["address"][0, 0])
        proofs = [type("P", (), {"to_dict": lambda self, i=i: {
            "pi_a": [str(seed), str(i), str(first)]}})() for i in range(B)]
        pubs = [[seed, i] for i in range(B)]
        return proofs, pubs


def _tree(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def voters():
    return tinputs.mock_batch(16, 11, seed=6, device="cpu")


def test_stream_checkpoint_resume(tmp_path, voters):
    """Kill the stream mid-run; a fresh ProofStream must resume from the
    cursor without duplicating or losing proofs."""
    voters = voters[:7]
    out = tmp_path / "proofs"

    # first run crashes after 2 batches (batch_size=2 -> 4 proofs done)
    p1 = _StubProver(fail_after_batches=2)
    s1 = ProofStream(p1, out, batch_size=2, metrics=Metrics(io.StringIO()))
    with pytest.raises(RuntimeError):
        s1.run(voters)
    assert s1.cursor == 4 and p1.calls == 2

    # resume with a new process-equivalent: picks up at the cursor
    p2 = _StubProver()
    s2 = ProofStream(p2, out, batch_size=2, metrics=Metrics(io.StringIO()))
    produced = s2.run(voters, seed=3)
    assert produced == 3                       # voters 4..6 only
    assert p2.calls == 2 and p2.sizes == [2, 1]
    assert p2.seeds == [3 + 4, 3 + 6]          # seed + base
    assert s2.cursor == 7
    done = sorted(d.name for d in out.iterdir() if d.is_dir())
    assert done == [f"proof_{i:08d}" for i in range(7)]  # no dup/loss
    assert not (out / "stream_checkpoint.tmp").exists()  # atomic replace
    # a third run is a no-op
    p3 = _StubProver()
    assert ProofStream(p3, out, batch_size=2,
                       metrics=Metrics(io.StringIO())).run(voters) == 0
    assert p3.calls == 0


def test_stream_tail_ladder(tmp_path, voters):
    """The final partial batch runs as a pow2 ladder (11 @ batch 8 ->
    8 + 2 + 1), never padded by repetition: a 1-voter tail must not pay
    a full-batch MSM."""
    assert [_prev_pow2(n) for n in (1, 2, 3, 7, 8, 37, 44)] == \
        [1, 2, 2, 4, 8, 32, 32]
    p = _StubProver()
    sink = io.StringIO()
    s = ProofStream(p, tmp_path / "proofs", batch_size=8,
                    metrics=Metrics(sink))
    assert s.run(voters) == 11
    assert p.sizes == [8, 2, 1]
    assert s.cursor == 11
    done = sorted(d.name for d in (tmp_path / "proofs").iterdir()
                  if d.is_dir())
    assert done == [f"proof_{i:08d}" for i in range(11)]
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert [(r["base"], r["batch"]) for r in records
            if r["kind"] == "stage"] == [(0, 8), (8, 2), (10, 1)]
    assert [r["batch"] for r in records if r["kind"] == "stage"
            and r["stage"] == "prove_batch"] == [8, 2, 1]


# the card's two serving phases (chip_smoke.py): 300 voters at batch 128
# (phase stream) and config.Config()'s default deployment, 47 voters at
# batch 16 (phase stream160); a crash in place of the third batch, then the
# tail's ladder
CARD_STREAMS = {"batch128": (300, 128, [32, 8, 4]),
                "batch16": (47, 16, [8, 4, 2, 1])}


@pytest.mark.parametrize("case", CARD_STREAMS)
def test_stream_300_at_128_is_the_card_phase_ladder(tmp_path, voters, case):
    """The slices of a serving phase on the card: a crash in place of the
    third batch (cursor 2 x batch), then the tail's ladder (300 at 128:
    32, 8, 4; 47 at 16: 8, 4, 2, 1), each slice seeded with seed + base."""
    n, batch, tail = CARD_STREAMS[case]
    many = (voters * 28)[:n]
    out = tmp_path / "proofs"
    p1 = _StubProver(fail_after_batches=2)
    s1 = ProofStream(p1, out, batch_size=batch, metrics=Metrics(io.StringIO()))
    with pytest.raises(RuntimeError):
        s1.run(many, seed=1)
    assert s1.cursor == 2 * batch
    p2 = _StubProver()
    s2 = ProofStream(p2, out, batch_size=batch, metrics=Metrics(io.StringIO()))
    assert s2.run(many, seed=1) == sum(tail) == n - 2 * batch
    assert p1.sizes == [batch, batch] and p2.sizes == tail
    bases = [2 * batch + sum(tail[:i]) for i in range(len(tail))]
    assert p2.seeds == [1 + b for b in bases] and s2.cursor == n


# (voters, batch, slices before the crash, the resumed slices)
JAX_STREAMS = {"batch4": (11, 4, 1, [4, 2, 1]),
               "batch16": (47, 16, 2, [8, 4, 2, 1])}


@pytest.mark.parametrize("case", JAX_STREAMS)
def test_stream_files_and_cursor_match_jax(tmp_path, voters, case):
    """The same stub behind the JAX package's ProofStream and the port's,
    a crash and a resume each: the same files with the same bytes, the
    same cursors and the same slices (11 at 4, and the default
    deployment's 47 at 16 with the whole ladder 8, 4, 2, 1)."""
    n, batch, before, tail = JAX_STREAMS[case]
    jvoters = jinputs.mock_batch(16, 11, seed=6)
    assert [v.to_json() for v in voters] == [v.to_json() for v in jvoters]
    trees = []
    for cls, met, vs, name in (
            (JaxProofStream, JaxMetrics, (jvoters * 5)[:n], "jax"),
            (ProofStream, Metrics, (voters * 5)[:n], "torch")):
        out = tmp_path / name
        with pytest.raises(RuntimeError):
            cls(_StubProver(fail_after_batches=before), out,
                batch_size=batch, metrics=met(io.StringIO())).run(
                    vs, seed=9)
        stub = _StubProver()
        resumed = cls(stub, out, batch_size=batch,
                      metrics=met(io.StringIO()))
        assert resumed.cursor == before * batch
        assert resumed.run(vs, seed=9) == n - before * batch == sum(tail)
        assert resumed.cursor == n and stub.sizes == tail
        trees.append(_tree(out))
    assert trees[0] == trees[1]
    assert len(trees[0]) == 2 * n + 1
    assert json.loads(trees[1]["stream_checkpoint.json"]) == \
        {"cursor": n, "batch_size": batch}


def _step_stand_ins(monkeypatch):
    """A DeviceProver on the CPU, and a ReplayProver over it with a step of
    every size, whose step, replay and finalize are stand-ins: what runs
    of theirs is prove_batch, with its spans."""
    import torch

    from zkfranchise_tpu_torch.groth16.device import (DeviceProver, FusedStep,
                                                      ReplayProver)
    stub = _StubProver()

    def planes(inputs, r, s, cut=False):
        # the step's outputs: four planes, then the SMT levels each lane
        # of the two trees hashed (here one level a lane)
        lanes = 2 * inputs["address"].shape[-1]
        return (inputs["address"], r, s, inputs["address"],
                torch.ones(lanes, dtype=torch.int32))

    def finalize(pa, pb, pc, publics):
        return stub.prove_batch({"address": pa}, seed=int(pb[0, 0]))

    prover = object.__new__(DeviceProver)
    prover.device = torch.device("cpu")
    prover.circuit = _StubProver.circuit
    prover.cut, prover._msm_plans = None, {}      # no cut tables, no MSM
    prover.prove_arrays = planes
    prover.finalize = finalize
    monkeypatch.setattr(FusedStep, "__call__",
                        lambda self, inputs, r, s: planes(inputs, r, s))
    replay = object.__new__(ReplayProver)
    replay.prover, replay.circuit = prover, prover.circuit
    replay.device = prover.device
    replay.steps = {}
    for size in (1, 2, 4, 8):
        replay.steps[size, False] = step = object.__new__(FusedStep)
        step.prover, step.batch, step.cut = prover, size, False
    return {"eager": prover, "replay": replay}


STEP_SPANS = ["step.enqueue", "step.wait", "step.finalize"]


@pytest.mark.parametrize("path", ["eager", "replay"])
def test_stream_spans_of_each_slice(tmp_path, voters, monkeypatch, path):
    """Each slice writes one stage record, prove_batch, with its keys, and
    the spans stream.arrays, step.enqueue, step.wait, step.finalize and
    stream.files, all with the slice's base and batch; the step's spans
    name prove_batch as their parent (the eager prover's prove_batch and
    the captured step's, through the ReplayProver)."""
    prover = _step_stand_ins(monkeypatch)[path]
    sink = io.StringIO()
    s = ProofStream(prover, tmp_path / "proofs", batch_size=8,
                    metrics=Metrics(sink))
    assert s.run(voters) == 11
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert all(r["kind"] in ("stage", "span") for r in records)
    slices = [(0, 8), (8, 2), (10, 1)]
    for i, (base, batch) in enumerate(slices):
        mine = records[6 * i:6 * (i + 1)]
        assert [r.get("name", r.get("stage")) for r in mine] == \
            ["stream.arrays", *STEP_SPANS, "prove_batch", "stream.files"]
        arrays, enqueue, wait, finalize, stage, files = mine
        assert set(stage) == {"kind", "stage", "seconds", "base", "batch",
                              "id", "t0", "t1", "ts"}
        for r in mine:
            assert (r["base"], r["batch"]) == (base, batch)
        for r in (enqueue, wait, finalize):
            assert r["parent"] == stage["id"]
        assert (finalize["smt_hashed"], finalize["smt_levels"]) == \
            (2 * batch, 2 * 17 * batch)
        assert (finalize["msm_leaves"], finalize["msm_leaves_full"]) == (0, 0)
        assert "smt_hashed" not in enqueue and "smt_hashed" not in stage
        assert arrays["parent"] is None and files["parent"] is None
        assert arrays["t1"] <= stage["t0"] <= enqueue["t0"] and \
            finalize["t1"] <= stage["t1"] <= files["t0"]
    assert len(records) == 6 * len(slices)
    assert [r["batch"] for r in records if r["kind"] == "stage"] == [8, 2, 1]
    assert sorted(s.metrics.timers) == sorted(
        ["stream.arrays", "prove_batch", "stream.files", *STEP_SPANS])


@pytest.mark.parametrize("path", ["eager", "replay"])
def test_step_spans_outside_a_stream_keep_process_totals(voters, monkeypatch,
                                                         path):
    """prove_batch called outside a stream: its spans go to PROCESS's
    totals and write no record."""
    from zkfranchise_tpu_torch.utils import metrics

    def no_record(self, record):
        raise AssertionError(f"a record was written: {record}")

    prover = _step_stand_ins(monkeypatch)[path]
    monkeypatch.setattr(Metrics, "_emit", no_record)
    monkeypatch.setattr(metrics.PROCESS, "timers", {})
    proofs, _ = prover.prove_batch(tinputs.batch_to_arrays(voters[:2], 16))
    assert len(proofs) == 2
    assert list(metrics.PROCESS.timers) == STEP_SPANS


def test_only_host_spans_reach_the_profiler(tmp_path, voters, monkeypatch):
    """Under a CPU torch.profiler: ranges named stream.arrays and
    stream.files, and none named prove_batch or step.*, whose bodies
    hold the card's work."""
    from torch.profiler import ProfilerActivity, profile

    prover = _step_stand_ins(monkeypatch)["eager"]
    s = ProofStream(prover, tmp_path / "proofs", batch_size=8,
                    metrics=Metrics(io.StringIO()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert s.run(voters[:10]) == 10
    names = [e.name for e in prof.events()]
    assert names.count("stream.arrays") == names.count("stream.files") == 2
    assert not {"prove_batch", *STEP_SPANS} & set(names)

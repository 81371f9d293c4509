"""The port's stream on captured steps (groth16.device.ReplayProver: one
FusedStep per batch size, all in one memory pool) and the kernel build
key, on the CPU.

A CUDA graph needs the card, so here ReplayProver and FusedStep are held
to their refusals, and ReplayProver's bookkeeping runs over a stub step in
place of FusedStep: ProofStream at the card phases' ladders (300 voters at
batch 128, and the default deployment's 47 at batch 16; a crash in place
of the third batch, a resume) must capture each size once, in the order
the stream asks for them (128, 32, 8, 4; 16, 8, 4, 2, 1), into one pool,
and write the files a stream over the eager prover writes.  The card tests
(tests/test_torch_cuda.py) replay the real graphs.  The build key carries
``nvcc --version``: the JAX package's program cache
(zkfranchise_tpu/utils/progcache.py:30) keys its snapshots without the
backend's version; the port's library cache must not."""
import io
import pathlib
import subprocess

import pytest
import torch

from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.stream import ProofStream
from zkfranchise_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)


# ---------------------------------------------------------------------------
# the kernel build key
# ---------------------------------------------------------------------------

@pytest.fixture
def nvcc_reads(monkeypatch):
    """A stand-in nvcc whose --version prints `release[0]`; -> the list of
    commands run.  The version is read afresh in each test."""
    release = ["Cuda compilation tools, release 12.8, V12.8.93"]
    ran = []

    def run(cmd, **kwargs):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=release[0] + "\n",
                                           stderr="")

    monkeypatch.setattr(K, "_nvcc", lambda: "stand-in/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    K._nvcc_version.cache_clear()
    yield release, ran
    K._nvcc_version.cache_clear()


def test_library_path_keys_the_toolkit_version(nvcc_reads):
    release, ran = nvcc_reads
    flags = list(K.NVCC_FLAGS)
    sources = {src: src.read_bytes() for src in (*K.SOURCES, *K.HEADERS)}
    old = {src.stem: K.library_path(src) for src in K.SOURCES}
    # the same version gives the same paths, and is read once
    assert {src.stem: K.library_path(src) for src in K.SOURCES} == old
    assert ran == [["stand-in/bin/nvcc", "--version"]]
    # another toolkit: every library gets a new path, with no source or
    # flag changed
    release[0] = "Cuda compilation tools, release 12.9, V12.9.41"
    K._nvcc_version.cache_clear()
    new = {src.stem: K.library_path(src) for src in K.SOURCES}
    assert len(ran) == 2
    assert all(new[k] != old[k] for k in old)
    assert all(new[k].parent == old[k].parent == K.BUILD_DIR for k in old)
    assert all(new[k].name.startswith(f"lib{k}_") for k in old)
    assert K.NVCC_FLAGS == flags
    assert all(src.read_bytes() == b for src, b in sources.items())
    # and back: the first version's paths again
    release[0] = "Cuda compilation tools, release 12.8, V12.8.93"
    K._nvcc_version.cache_clear()
    assert {src.stem: K.library_path(src) for src in K.SOURCES} == old


def test_library_path_without_nvcc_raises(monkeypatch):
    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(K, "_nvcc", missing)
    K._nvcc_version.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            K.library_path(K.SOURCES[0])
        with pytest.raises(RuntimeError, match="nvcc not found"):
            K.build()
    finally:
        K._nvcc_version.cache_clear()


# ---------------------------------------------------------------------------
# ReplayProver and FusedStep off the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_prover():
    return tdevice.DeviceProver(
        CensusCircuit(NL), tsetup.ProvingKey.load(ART / "proving_key.pkl"),
        device="cpu")


def test_replay_prover_refuses_a_cpu_prover(cpu_prover):
    with pytest.raises(RuntimeError, match="on the card"):
        tdevice.ReplayProver(cpu_prover)


def test_fused_step_takes_a_pool_and_refuses_the_cpu(cpu_prover):
    token = object()
    with pytest.raises(RuntimeError, match="on the card"):
        tdevice.FusedStep(cpu_prover, 2, pool=token)
    with pytest.raises(RuntimeError, match="on the card"):
        cpu_prover.capture(2, probe=lambda stage: None)


# ---------------------------------------------------------------------------
# ReplayProver's captures behind ProofStream, over a stub step
# ---------------------------------------------------------------------------

def _proofs(arrs, seed, batch):
    """What both stub provers return for a slice: proofs that name the
    seed, the lane, the slice's first address limb and the batch."""
    first = int(arrs["address"][0, 0])
    proofs = [type("P", (), {"to_dict": lambda self, i=i: {
        "pi_a": [str(seed), str(i), str(first), str(batch)]}})()
        for i in range(batch)]
    return proofs, [[seed, i, batch] for i in range(batch)]


class _EagerStub:
    """A DeviceProver as ProofStream sees it; .device claims the card so
    that ReplayProver takes it."""

    class _C:
        n_levels = 16

    circuit = _C()
    device = torch.device("cuda")

    def prove_batch(self, arrs, seed=0):
        return _proofs(arrs, seed, arrs["address"].shape[-1])


class _StubStep:
    """FusedStep's place: records how it was made; its prove_batch takes
    only inputs of its own batch size."""

    made = []

    def __init__(self, prover, batch, *, pool=None, probe=None):
        self.prover, self.batch, self.pool = prover, batch, pool
        self.warmup_s = self.capture_s = self.instantiate_s = 0.0
        self.launches = {}
        _StubStep.made.append(self)
        if probe is not None:
            for stage in ("start", "warmup", "capture", "instantiate"):
                probe(stage)

    def prove_batch(self, inputs, seed=0):
        assert inputs["address"].shape[-1] == self.batch
        return _proofs(inputs, seed, self.batch)


class _Crashing:
    """Raises in place of slice number `fail_after`."""

    def __init__(self, prover, fail_after=None):
        self.prover, self.fail_after, self.calls = prover, fail_after, 0
        self.circuit, self.device = prover.circuit, prover.device

    def prove_batch(self, arrs, seed=0):
        if self.fail_after is not None and self.calls >= self.fail_after:
            raise RuntimeError("injected crash")
        self.calls += 1
        return self.prover.prove_batch(arrs, seed=seed)


def _serve(prover, out, voters, batch):
    """A card phase's stream at `batch`: crash in place of the third
    batch, resume, then a third run that proves nothing."""
    with pytest.raises(RuntimeError, match="injected crash"):
        ProofStream(_Crashing(prover, fail_after=2), out, batch_size=batch,
                    metrics=Metrics(io.StringIO())).run(voters, seed=1)
    resumed = ProofStream(_Crashing(prover), out, batch_size=batch,
                          metrics=Metrics(io.StringIO()))
    assert resumed.cursor == 2 * batch
    assert resumed.run(voters, seed=1) == len(voters) - 2 * batch
    assert ProofStream(_Crashing(prover), out, batch_size=batch,
                       metrics=Metrics(io.StringIO())).run(voters) == 0


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# chip_smoke.py's serving phases: (voters, batch, the sizes captured in
# order): phase stream, and phase stream160 (config.Config()'s defaults,
# the whole batch-16 ladder)
CARD_STREAMS = {"batch128": (300, 128, [128, 32, 8, 4]),
                "batch16": (47, 16, [16, 8, 4, 2, 1])}


@pytest.mark.parametrize("case", CARD_STREAMS)
def test_replay_stream_captures_each_size_once_in_one_pool(tmp_path,
                                                           monkeypatch,
                                                           case):
    n, batch, sizes = CARD_STREAMS[case]
    token = ("pool", 1)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: token)
    monkeypatch.setattr(tdevice, "FusedStep", _StubStep)
    _StubStep.made.clear()
    voters = (tinputs.mock_batch(16, 11, seed=6, device="cpu") * 28)[:n]
    eager = _EagerStub()
    probed = []
    replay = tdevice.ReplayProver(
        eager, probe=lambda batch, stage: probed.append((batch, stage)))
    assert (replay.circuit, replay.device) == (eager.circuit, eager.device)
    assert replay.pool is token

    _serve(replay, tmp_path / "graph", voters, batch)
    assert [s.batch for s in _StubStep.made] == sizes
    assert list(replay.steps) == sizes
    assert all(s.pool is token and s.prover is eager
               for s in _StubStep.made)
    assert replay.steps == {s.batch: s for s in _StubStep.made}
    assert probed == [(b, stage) for b in sizes
                      for stage in ("start", "warmup", "capture",
                                    "instantiate")]
    assert replay.step(sizes[1]) is replay.steps[sizes[1]]  # kept, not again
    assert len(_StubStep.made) == len(sizes)

    _serve(eager, tmp_path / "eager", voters, batch)
    graph, plain = _tree(tmp_path / "graph"), _tree(tmp_path / "eager")
    assert graph == plain and len(graph) == 2 * n + 1

"""Continuous proof stream with checkpoint/resume.

Production shape of the framework: a stream of voter-proof requests is
consumed in fixed-size batches through the prover on the card; finished
proofs are written as snarkjs-format artifacts; the batch cursor is
checkpointed so a restarted process resumes where it left off (the only
persistent state is the artifact directory itself).

The stream runs where its prover's tables live (``prover.device``) and
chooses no device of its own.
"""
from __future__ import annotations

import json
from pathlib import Path

from . import inputs as inp
from .groth16.device import DeviceProver
from .utils.metrics import Metrics, recording, span


class ProofStream:
    """Drives a prover over a list of CircuitInputs: a DeviceProver, or a
    ReplayProver over one (a captured step per batch size)."""

    def __init__(self, prover: DeviceProver, out_dir: str | Path,
                 batch_size: int = 16, metrics: Metrics | None = None):
        self.prover = prover
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.batch_size = batch_size
        self.metrics = metrics or Metrics()
        self._ckpt_path = self.out_dir / "stream_checkpoint.json"

    @property
    def cursor(self) -> int:
        if self._ckpt_path.exists():
            return json.loads(self._ckpt_path.read_text())["cursor"]
        return 0

    def _save_cursor(self, cursor: int) -> None:
        tmp = self._ckpt_path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"cursor": cursor,
                                   "batch_size": self.batch_size}))
        tmp.replace(self._ckpt_path)

    def run(self, voters: list, seed: int = 0) -> int:
        """Proves all voters from the checkpointed cursor onward.  The
        final partial batch is proven as a LADDER of power-of-two
        sub-batches (37 -> 32 + 4 + 1) instead of being padded to
        batch_size by repetition, so a 1-voter tail costs one 1-lane step
        and not a full-batch MSM.  On the card an eager step's cost falls
        far less than its batch (the host issues about 68,000 kernel
        launches a step at batch 128 and still about 13,000 at batch 4),
        so the ladder bounds the tail at log2(batch_size) short steps.
        Behind a ReplayProver each ladder size is captured as a CUDA graph
        on its first use and replayed with no host issue after that, so a
        process pays at most log2(batch_size) + 1 captures; a graph does
        not outlive its process.  Slice `base` is proven with seed + base,
        whatever the slicing, so a resumed run gives the proofs the
        uninterrupted run would have given.  The call's spans (each
        slice's stream.arrays, prove_batch, stream.files and the prover's
        own) record into the stream's Metrics.  Returns the number of
        proofs produced this call."""
        with recording(self.metrics):
            start = self.cursor
            produced = 0
            base = start
            n = len(voters)
            while base < n:
                size = self.batch_size
                if n - base < size:             # tail: pow2 ladder
                    size = _prev_pow2(n - base)
                produced += self._prove_slice(voters, base, size, seed)
                base += size
        return produced

    def _prove_slice(self, voters, base, size, seed) -> int:
        with span("stream.arrays", base=base, batch=size):
            arrs = inp.batch_to_arrays(voters[base:base + size],
                                       self.prover.circuit.n_levels)
        with self.metrics.stage("prove_batch", base=base, batch=size):
            proofs, pubs = self.prover.prove_batch(arrs, seed=seed + base)
        with span("stream.files", base=base, batch=size):
            for i in range(size):
                d = self.out_dir / f"proof_{base + i:08d}"
                d.mkdir(exist_ok=True)
                (d / "proof.json").write_text(json.dumps(proofs[i].to_dict()))
                (d / "signals.json").write_text(
                    json.dumps([str(x) for x in pubs[i]]))
            self._save_cursor(base + size)
        return size


def _prev_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)

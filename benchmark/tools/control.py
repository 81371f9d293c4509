"""The comparison's control, and the faults a run can have, planted in the
program on the card at a cell's own size: each must come out not correct.

    python3 benchmark/tools/control.py --workload nl160-backlog \
        --seeds 21,22,23 --seconds 5 --plant control,stale,half,altered

- ``control``: the quotient left out of the proof (quotient_stage returns
  zeros): the step a later change would be tempted to take, since the
  proofs stay well formed and carry the right signals; only the pairing
  check sees it.
- ``stale``: a captured step that returns its outputs unchanged after its
  first replay (the state left as it was).
- ``half``: half of every batch left out, its lanes proving the first
  half's voters again.
- ``altered``: every proof's C moved off its value where finalize makes
  it.
- ``none``: nothing planted (the program as it is).

One line of JSON a run: the planted fault, the seed, correct, and the
numbers compared with their limits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def plant(name: str) -> None:
    import torch
    from zkfranchise_tpu_torch.groth16 import device

    if name == "control":
        def no_quotient(arrays, n, w):
            return torch.zeros((n, w.shape[1], w.shape[2]), dtype=w.dtype,
                               device=w.device)
        device.quotient_stage = no_quotient
    elif name == "stale":
        replay = device.FusedStep.__call__

        def stale(self, inputs, r, s):
            if getattr(self, "replayed", False):
                return tuple(o.clone() for o in self.outputs)
            self.replayed = True
            return replay(self, inputs, r, s)
        device.FusedStep.__call__ = stale
    elif name == "half":
        replay = device.FusedStep.__call__

        def half(self, inputs, r, s):
            h = max(1, self.batch // 2)
            first = {k: torch.as_tensor(v)[..., :h] for k, v in
                     inputs.items()}
            inputs = {k: torch.cat([v] * 2, -1)[..., :self.batch]
                      for k, v in first.items()}
            return replay(self, inputs, r, s)
        device.FusedStep.__call__ = half
    elif name == "altered":
        finalize = device.DeviceProver.finalize

        def altered(self, pa, pb, pc, publics):
            pc = pc.clone()
            pc[0] += 1
            return finalize(self, pa, pb, pc, publics)
        device.DeviceProver.finalize = altered
    elif name != "none":
        raise ValueError(f"nothing to plant called {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--plant", required=True,
                    help="control, stale, half, altered or none; one run "
                         "a fault and seed, each in a process of its own")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.one:
        import subprocess
        status = 0
        for name in args.plant.split(","):
            for seed in args.seeds.split(","):
                p = subprocess.run(
                    [sys.executable, __file__, "--one", "--workload",
                     args.workload, "--seeds", seed, "--seconds",
                     str(args.seconds), "--plant", name],
                    capture_output=True, text=True)
                lines = p.stdout.strip().splitlines()
                print(lines[-1] if lines else json.dumps(
                    {"plant": name, "seed": seed, "rc": p.returncode,
                     "stderr": p.stderr[-1500:]}), flush=True)
                status |= p.returncode
        return status
    start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, spec
    bench = spec.load(ROOT)
    c = spec.cell(bench, args.workload, ROOT)
    plant(args.plant)
    result, _ = cell.execute(c, int(args.seeds), args.seconds, False,
                             cell.CudaEnv(ROOT, bench), start)
    print(json.dumps({"plant": args.plant, "workload": args.workload,
                      "seed": int(args.seeds), "correct": result["correct"],
                      "attempted": result["attempted"],
                      "failed": result["failed"],
                      "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

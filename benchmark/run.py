"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Standard output ends with one JSON
line: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, and with --trace 1 the
breakdown; its last key, "checks", holds each number compared with the
reference beside its limit, which are also the last lines of standard
error.  Exit codes: 2 without enough cards, 3 without the program beside
the benchmark, 4 if the process holds JAX or the JAX package when the
result is due, 1 on any other failure.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names, compared whole: the port's name begins with the
# JAX package's
FORBIDDEN = {"jax", "jaxlib", "flax", "zkfranchise_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    cache = ROOT / "benchmark" / ".cache"
    # every cache a build or a kernel compiler keeps, at fixed paths in the
    # checkout (the program builds its kernels in zkfranchise_tpu_torch/build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    from benchmark.harness import cell, spec

    bench = spec.load(ROOT)
    c = spec.cell(bench, args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import zkfranchise_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 3
    return report(*cell.execute(c, args.seed, args.seconds,
                                bool(args.trace), cell.CudaEnv(ROOT, bench),
                                PROCESS_START))


def report(result: dict, checks: list) -> int:
    """Prints the result, once everything the run imports is loaded: the
    window, the trace, the comparison and every metric's reader.  Prints
    none, and returns 4, if the process holds JAX or the JAX package."""
    found = {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN
    if found:
        print(f"the process holds {sorted(found)}: no result",
              file=sys.stderr, flush=True)
        return 4
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

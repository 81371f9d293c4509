"""The knee of an open-loop cell: the highest arrival rate at which the
queue left at the window's end stays under one batch.

    python3 benchmark/tools/sweep.py --workload nl160-arrivals \
        --rates 8,9,10 --seconds 30 --seed 31

One process: the cell's set-up once, then REPEATS windows a rate, each
on a fresh stream with the cell's arrivals (the same at every repeat, as
at every seed: the repeats differ by the run's own noise).  A line of JSON a window:
the voters due, the queue at the window's close (due by then and without
a proof by then), the drain, the median and 95th-percentile latency, and
the slices by size; then a line a rate with the median queue at the
close; then the knee: the highest rate at which that median, and the
median at every lower rate, is under one batch.  Nothing is compared with
the reference here.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# windows a rate: the knee is read from their median queue at the close,
# so that one window's noise does not move it
REPEATS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, spec

    bench = spec.load(ROOT)
    c = spec.cell(bench, args.workload, ROOT)
    if c.traffic["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open loop")
    t0 = time.perf_counter()
    prog, pool, _ = cell.prepare(c, args.seed, cell.CudaEnv(ROOT, bench), {})
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    batch = c.config["batch_size"]
    rates = [float(r) for r in args.rates.split(",")]
    median_queue = {}
    for rate in rates:
        queues = []
        for k in range(REPEATS):
            queues.append(window(prog, pool, batch, rate, args.seconds,
                                 args.seed + k))
        median_queue[rate] = statistics.median(queues)
        print(json.dumps({"rate_per_s": rate, "queues_at_close": queues,
                          "median_queue_at_close": median_queue[rate]}),
              flush=True)
    knee = None
    for rate in sorted(rates):
        if median_queue[rate] >= batch:
            break
        knee = rate
    print(json.dumps({"knee_per_s": knee, "batch": batch}), flush=True)
    return 0


def window(prog, pool: list, batch: int, rate: float, seconds: float,
           seed: int) -> int:
    """One window at `rate`; prints its line, -> the queue at its close."""
    from benchmark.harness import cell, check, traffic
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    os.sync()
    out_dir = Path(tempfile.mkdtemp(prefix="zkbench-sweep-"))
    sink = cell.Sink()
    try:
        stream = ProofStream(prog.prover, out_dir, batch_size=batch,
                             metrics=Metrics(sink))
        due = traffic.schedule({"rate_per_s": rate}, seconds)
        w = traffic.open_loop(stream, pool, due, seconds, seed)
        done = {i: f[2] / 1e9 - w.wall_start for i, f in
                check.read_back(out_dir, len(due)).items()}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    queue = sum(1 for i, d in enumerate(due)
                if done.get(i, float("inf")) > seconds)
    lat = [1e3 * (done[i] - d) for i, d in enumerate(due) if i in done]
    by_size: dict = {}
    for r in sink.records:
        if r["kind"] == "stage":
            by_size[r["batch"]] = by_size.get(r["batch"], 0) + 1
    print(json.dumps({
        "rate_per_s": rate, "seed": seed, "due": len(due),
        "proven": len(done), "queue_at_close": queue,
        "under_one_batch": queue < batch, "drain_s": w.left - seconds,
        "latency_p50_ms": cell.percentile(lat, 50) if lat else None,
        "latency_p95_ms": cell.percentile(lat, 95) if lat else None,
        "slices_by_size": by_size}), flush=True)
    return queue


if __name__ == "__main__":
    sys.exit(main())

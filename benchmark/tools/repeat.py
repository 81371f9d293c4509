"""Run cells several times, each run a process of its own as the check
runs them, and report each metric's spread.

    python3 benchmark/tools/repeat.py --workload nl160-backlog \
        --seeds 11,12,13,14,15,16 [--sets 2] [--seconds 30] [--trace 0] \
        [--out benchmark/.out/repeat.jsonl]

Each set runs every seed once, in order; a second set repeats the same
seeds.  Per metric and set: the median and the spread, the distance
between the first and the third quartile (statistics.quantiles, n=4) as a
share of the median.  Every result line, with the end of its standard
error, is appended to --out.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_once(workload: str, seed: int, seconds: float, trace: int,
             timeout: float) -> dict:
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    line = out.strip().splitlines()[-1] if out.strip() else ""
    try:
        result = json.loads(line)
    except ValueError:
        result = None
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "rc": rc, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": err[-3000:]}


def spread(values: list) -> tuple:
    med = statistics.median(values)
    if len(values) < 2:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="one cell, or several separated by commas")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", default="benchmark/.out/repeat.jsonl")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    status = 0
    for workload in args.workload.split(","):
        by_set: list = []
        for k in range(args.sets):
            runs = []
            for seed in seeds:
                r = run_once(workload, seed, args.seconds, args.trace,
                             args.timeout)
                r["set"] = k
                with out.open("a") as f:
                    f.write(json.dumps(r) + "\n")
                res = r["result"] or {}
                print(json.dumps({"workload": workload, "set": k,
                                  "seed": seed, "rc": r["rc"],
                                  "wall_s": round(r["wall_s"], 1),
                                  "correct": res.get("correct"),
                                  "attempted": res.get("attempted"),
                                  "failed": res.get("failed"),
                                  "metrics": {n: m["value"] for n, m in
                                              res.get("metrics", {}).items()},
                                  "peak": res.get("device", {}).get(
                                      "memory_peak_bytes"),
                                  "spans": {k: round(v, 3) for k, v in
                                            res.get("spans", {}).items()},
                                  "window": res.get("window")}),
                      flush=True)
                if r["rc"] != 0 or not res.get("correct"):
                    status = 1
                    print(r["stderr_tail"][-1500:], flush=True)
                runs.append(res)
            by_set.append(runs)
        names = sorted({n for runs in by_set for r in runs
                        for n in r.get("metrics", {})})
        for name in names:
            sets = []
            for runs in by_set:
                vals = [r["metrics"][name]["value"] for r in runs
                        if name in r.get("metrics", {})]
                if vals:
                    med, spr = spread(vals)
                    sets.append({"median": med, "spread": spr,
                                 "values": vals})
            print(json.dumps({"workload": workload, "metric": name,
                              "sets": sets}), flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())

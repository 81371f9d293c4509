"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

The order is fixed.  Set-up (counted in ``setup_s`` from the process's
start): the program on the card (program.setup) while a spawned process
makes the voters from the seed; then one slice of every captured size,
untimed, so that nothing is built or touched for the first time inside
the window.  The window: the traffic mix's loop over ``ProofStream.run``.
Then, in this order: the device's peak memory is read; a traced run
profiles its stretch (trace.py) and reduces it; the program is freed;
every voter attempted is compared with the reference (check.py); and the
metrics are read.  run.py searches the process for JAX after all of it,
just before it prints the result.
"""
from __future__ import annotations

import gc
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path

from ..reference import groth16
from . import check, program, spec, trace, traffic, voters, work


@dataclass
class Run:
    """What a metric's reader reads (metrics/<name>.py: read(run))."""
    cell: spec.Cell
    seed: int
    setup_s: float
    spans: dict
    window: traffic.Window
    records: list                  # the stream's Metrics records, in order
    attempted: int
    failed: set
    done: dict                     # voter: seconds after the window start
    reading: trace.Reading | None = None
    roofline: float | None = None
    batch: int = 0

    def slices(self) -> list:
        return prove_batches(self.records)


def prove_batches(records: list) -> list:
    """The stream's prove_batch records, one a slice."""
    return [r for r in records
            if r["kind"] == "stage" and r["stage"] == "prove_batch"]


class Sink:
    """A file-like Metrics sink that keeps the records."""

    def __init__(self):
        self.records: list = []

    def write(self, text: str) -> None:
        for line in text.splitlines():
            if line.strip():
                self.records.append(json.loads(line))

    def flush(self) -> None:
        pass


class Marked:
    """The prover behind ProofStream with each prove_batch marked for the
    profiler (traced runs only)."""

    def __init__(self, prover):
        self.inner = prover
        self.circuit, self.device = prover.circuit, prover.device

    def prove_batch(self, inputs, seed=0):
        from torch.profiler import record_function
        with record_function("bench.prove_batch"):
            return self.inner.prove_batch(inputs, seed=seed)


class CudaEnv:
    """The card: the program set up on it, its memory and its name."""

    def __init__(self, root: Path, bench: dict):
        self.root, self.bench = root, bench
        self.cache = spec.bench_dir(bench, root) / ".cache" / "keys"

    def setup(self, cell: spec.Cell, sizes: list, spans: dict):
        return program.setup(self.root, cell.config, sizes, self.vk(cell),
                             self.cache, spans)

    def vk(self, cell: spec.Cell) -> dict:
        return json.loads((self.root / cell.config["key"]["vk"]).read_text())

    def device(self, chips: int) -> dict:
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}

    def card(self) -> dict:
        """The card's power limit and highest SM clock, and its SMs."""
        import torch
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, check=True).stdout
        limit, mhz = (float(x) for x in out.split(","))
        return {"power_limit_w": limit, "sm_max_mhz": mhz,
                "sms": torch.cuda.get_device_properties(0)
                .multi_processor_count}

    def free(self, prog) -> None:
        import torch
        prog.prover = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sizes(cell: spec.Cell) -> list:
    """The batch sizes the cell's traffic proves: a backlog only full
    batches, an open loop the whole power-of-two ladder."""
    batch = cell.config["batch_size"]
    if cell.traffic["loop"] == "closed":
        return [batch]
    return [batch >> i for i in range(batch.bit_length())]


def _pool(cell: spec.Cell, seed: int):
    """Starts the voters' generation in a spawned process of its own, at a
    lower priority than the program's set-up beside it."""
    ex = ProcessPoolExecutor(max_workers=1,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=os.nice, initargs=(10,))
    return ex, ex.submit(voters.pool, cell.config["nlevels"],
                         cell.config["pool_voters"], seed)


def prepare(cell: spec.Cell, seed: int, env, spans: dict) -> tuple:
    """Set-up: the program (env.setup) while a spawned process makes the
    voters; then one untimed slice of every size the traffic proves.
    -> (program, the voters as the program's CircuitInputs, their
    reference signals)."""
    from zkfranchise_tpu_torch import inputs as inp

    ex, pool_future = _pool(cell, seed)
    try:
        prog = env.setup(cell, sizes(cell), spans)
        with program.span(spans, "voters_wait"):
            pool_inputs, pool_signals = pool_future.result()
    finally:
        ex.shutdown(wait=True)
    pool = [inp.CircuitInputs(**d) for d in pool_inputs]
    with program.span(spans, "warm"):
        for size in sizes(cell):
            prog.prover.prove_batch(
                inp.batch_to_arrays(pool[:size], cell.config["nlevels"]),
                seed=seed)
    return prog, pool, pool_signals


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, env,
            start: float) -> tuple:
    """-> (the result dict, [(check, value, limit)]).  `start`: the
    perf_counter reading at the process's start."""
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    spans: dict = {}
    prog, pool, pool_signals = prepare(cell, seed, env, spans)
    batch = cell.config["batch_size"]
    sink = Sink()
    out_dir = Path(tempfile.mkdtemp(prefix="zkbench-"))
    try:
        stream = ProofStream(prog.prover, out_dir, batch_size=batch,
                             metrics=Metrics(sink))
        # set-up's objects (the voters, the key's tables) are never garbage:
        # keep the collector from walking them inside the window
        gc.collect()
        gc.freeze()
        # and let no earlier write-back of files land in the window
        os.sync()
        if cell.traffic["loop"] == "closed":
            w = traffic.closed_loop(stream, pool, batch, seconds, seed)
            attempted = w.handed
        else:
            due = traffic.schedule(cell.traffic, seconds)
            w = traffic.open_loop(stream, pool, due, seconds, seed)
            attempted = len(due)
        setup_s = w.start - start
        cursor = stream.cursor
        device = env.device(cell.chips)
        card = env.card()
        reading = roofline = detail = None
        if traced:
            reading, roofline, detail = profile(cell, prog, pool, seed,
                                                card, spans)
            device.update(busy_s=reading.busy_s, window_s=reading.window_s)
        stream = None
        env.free(prog)
        vk = groth16.VerifyingKey(env.vk(cell))
        slices = [(r["base"], r["batch"])
                  for r in prove_batches(sink.records)]
        numbers, failed, done_ns = check.compare(
            out_dir, attempted, cursor, slices, pool_signals, vk, seed)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        # the proofs' files written back and removed now, not in the next
        # run's window
        os.sync()
    run = Run(cell=cell, seed=seed, setup_s=setup_s, spans=spans, window=w,
              records=sink.records, attempted=attempted, failed=failed,
              done={i: ns / 1e9 - w.wall_start for i, ns in done_ns.items()},
              reading=reading, roofline=roofline, batch=batch)
    checks = [(k, numbers[k], check.LIMITS[k]) for k in check.LIMITS]
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": attempted, "failed": len(failed),
        "metrics": metrics(run, cell.per_layer if traced else
                           cell.end_to_end, env.bench, env.root,
                           required=not traced),
        "device": device, "card": card, "spans": spans,
        "window": window_summary(run)}
    if reading is not None:
        result["breakdown"] = {"device_ops": reading.device_ops,
                               "idle_gaps": reading.idle_gaps}
        result["kernels"] = detail
        out = spec.bench_dir(env.bench, env.root) / ".out"
        out.mkdir(exist_ok=True)
        (out / f"{cell.name}.{seed}.kernels.json").write_text(
            json.dumps(detail, indent=1))
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks


def profile(cell: spec.Cell, prog, pool: list, seed: int, card: dict,
            spans: dict) -> tuple:
    """A traced run's profiled stretch, after the measured window so that
    the window runs as in any other run: the same traffic on a stream of
    its own (trace.py says which calls are profiled).  -> (the trace's
    reading, the kernels' roofline share, its detail)."""
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    batch = cell.config["batch_size"]
    sink = Sink()
    out_dir = Path(tempfile.mkdtemp(prefix="zkbench-trace-"))
    try:
        stream = ProofStream(Marked(prog.prover), out_dir, batch_size=batch,
                             metrics=Metrics(sink))
        loop = cell.traffic["loop"]
        tracer = trace.Tracer(loop, program.counters, lambda: sink.records)
        tracer.warm()
        if loop == "closed":
            traffic.closed_loop(stream, pool, batch, float("inf"), seed,
                                tracer.hook, max_calls=len(trace.CLOSED_CALLS))
        else:
            traffic.open_loop(
                stream, pool, traffic.schedule(cell.traffic, trace.STRETCH_S),
                trace.STRETCH_S, seed, tracer.hook)
        tracer.finish()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    spans["trace_stop"] = tracer.stop_s
    t0 = time.perf_counter()
    reading = trace.reduce(trace.events(tracer.prof))
    (before, i0), (after, i1) = tracer.before, tracer.after
    reading.slices = [r["batch"] for r in sink.records[i0:i1]
                      if r["kind"] == "stage"]
    reading.eager = work.counted_launches(
        program.counted_since(after, before), batch, prog.domain)
    roofline, detail = trace.roofline(
        reading, {s: work.counted_launches(c, s, prog.domain)
                  for s, c in prog.captured.items()},
        card["sms"], card["sm_max_mhz"], prog.domain)
    spans["trace_read"] = time.perf_counter() - t0
    return reading, roofline, detail


def metrics(run: Run, entries: list, bench: dict, root: Path,
            required: bool) -> dict:
    """The entries' values, each from its reader; with `required` (the
    end-to-end metrics) a reader that finds nothing is an error."""
    out = {}
    for m in entries:
        value = spec.reader(bench, m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        elif required:
            raise RuntimeError(f"{m['name']}: nothing to read in this run")
    return out


def window_summary(run: Run) -> dict:
    """What the window did: slices by size, the mean seconds of a slice
    (prove_batch) and of a call of run, and the stream's host seconds
    outside prove_batch."""
    slices = run.slices()
    calls = run.window.calls
    by_size: dict = {}
    for r in slices:
        by_size[r["batch"]] = by_size.get(r["batch"], 0) + 1
    inside = sum(r["seconds"] for r in slices)
    return {"slices": by_size, "calls": len(calls),
            "slice_s_mean": inside / len(slices) if slices else None,
            "call_s_mean": sum(t1 - t0 for t0, t1, _ in calls) / len(calls)
            if calls else None,
            "stream_host_s": sum(t1 - t0 for t0, t1, _ in calls) - inside}


# -- helpers the readers share ----------------------------------------------

def percentile(values: list, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    the closest ranks (statistics.quantiles, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q) - 1]


def latencies_ms(run: Run) -> list:
    """Every due voter's wait, from its due time to the writing of its
    proof; a voter without a right proof waits until the stream was left
    (the end of the drain)."""
    out = []
    for i, due in enumerate(run.window.due):
        done = run.done.get(i) if i not in run.failed else None
        out.append(1e3 * ((done if done is not None else run.window.left)
                          - due))
    return out


def rate(run: Run) -> float | None:
    """Proofs written in a closed loop's window over its elapsed time."""
    w = run.window
    if w.loop != "closed":
        return None
    return sum(made for _, _, made in w.calls) / (w.end - w.start)


def host_ms_per_proof(run: Run) -> float | None:
    """ProofStream.run's time outside prove_batch, per proof (a closed
    loop)."""
    calls = run.window.calls
    proofs = sum(made for _, _, made in calls)
    if run.window.loop != "closed" or not proofs:
        return None
    outside = sum(t1 - t0 for t0, t1, _ in calls) - \
        sum(r["seconds"] for r in run.slices())
    return 1e3 * outside / proofs


def full_slice_ms(run: Run) -> float | None:
    """The mean prove_batch record of a full slice (a closed loop)."""
    full = [r["seconds"] for r in run.slices() if r["batch"] == run.batch]
    if run.window.loop != "closed" or not full:
        return None
    return 1e3 * sum(full) / len(full)


def idle_pct(run: Run, loop: str) -> float | None:
    """The traced stretch's share with no operation on the card."""
    r = run.reading
    if run.window.loop != loop or r is None or not r.window_s:
        return None
    return 100 * (1 - r.busy_s / r.window_s)


def slice_starts(run: Run) -> list:
    """(start s after the window's start, base, batch) of every slice."""
    return [(r["ts"] - r["seconds"] - run.window.wall_start, r["base"],
             r["batch"]) for r in run.slices()]

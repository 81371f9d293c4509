"""What the per-layer metrics read of the program's own spans: the
window's span records (the stream's Metrics, through the benchmark's
Sink) and the process's totals outside any stream
(``zkfranchise_tpu_torch.utils.metrics.PROCESS``, where the key's ingest
records).  A program that records no such span gives None."""
from __future__ import annotations


def mean_ms(run, name: str, loop: str, full: bool = False) -> float | None:
    """The mean of the window's spans named `name`, in ms; with `full`,
    only those of full slices.  None outside a `loop` loop ("closed" or
    "open") or where the window holds no such span."""
    if run.window.loop != loop:
        return None
    times = [r["t1"] - r["t0"] for r in run.records
             if r["kind"] == "span" and r["name"] == name
             and (not full or r["batch"] == run.batch)]
    return 1e3 * sum(times) / len(times) if times else None


def process_s(name: str) -> float | None:
    """The process's seconds in spans named `name` outside any stream, or
    None."""
    from zkfranchise_tpu_torch.utils import metrics
    process = getattr(metrics, "PROCESS", None)
    return None if process is None else process.timers.get(name)

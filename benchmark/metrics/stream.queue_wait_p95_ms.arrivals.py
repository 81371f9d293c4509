"""stream.queue_wait_p95_ms.arrivals: the 95th percentile, over the due
voters, of the time from a voter's due time to the start of the
prove_batch of its slice (the stream's Metrics record)."""
from benchmark.harness import cell


def read(run):
    due = run.window.due
    if run.window.loop != "open" or not due:
        return None
    waits = [1e3 * (start - due[i])
             for start, base, size in cell.slice_starts(run)
             for i in range(base, base + size) if i < len(due)]
    return cell.percentile(waits, 95) if waits else None

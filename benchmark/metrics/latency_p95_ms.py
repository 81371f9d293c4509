"""latency_p95_ms: the 95th percentile of every due voter's wait, from
its due time to the writing of its proof (a voter without a right proof
waits until the stream was left)."""
from benchmark.harness import cell


def read(run):
    if run.window.loop != "open" or not run.window.due:
        return None
    return cell.percentile(cell.latencies_ms(run), 95)

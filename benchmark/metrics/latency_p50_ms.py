"""latency_p50_ms: the median of every due voter's wait, as for
latency_p95_ms."""
from benchmark.harness import cell


def read(run):
    if run.window.loop != "open" or not run.window.due:
        return None
    return cell.percentile(cell.latencies_ms(run), 50)

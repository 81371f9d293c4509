"""step.slice_ms.arrivals: the mean prove_batch record over the slices of
an open loop, every size of the ladder."""


def read(run):
    times = [r["seconds"] for r in run.slices()]
    if run.window.loop != "open" or not times:
        return None
    return 1e3 * sum(times) / len(times)

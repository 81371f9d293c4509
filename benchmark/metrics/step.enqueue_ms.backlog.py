"""step.enqueue_ms.backlog: the mean of the program's step.enqueue span over
the window's full slices: r and s drawn, the inputs checked and copied
into the captured step's buffers, the graph's replay issued and its
outputs cloned, until the host returns."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "step.enqueue", "closed", full=True)

"""step.enqueue_ms.arrivals: the mean of the program's step.enqueue span over
every slice of the window, every size of the ladder."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "step.enqueue", "open")

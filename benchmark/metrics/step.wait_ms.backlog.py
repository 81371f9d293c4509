"""step.wait_ms.backlog: the mean of the program's step.wait span over the
window's full slices: the host waiting for the card to finish the
slice's replay."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "step.wait", "closed", full=True)

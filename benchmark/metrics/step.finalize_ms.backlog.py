"""step.finalize_ms.backlog: the mean of the program's step.finalize span over
the window's full slices: the planes out of Montgomery form, the
read-backs, the affine points, the integers and the strings."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "step.finalize", "closed", full=True)

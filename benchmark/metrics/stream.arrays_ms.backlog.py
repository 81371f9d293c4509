"""stream.arrays_ms.backlog: the mean of the program's stream.arrays span
(batch_to_arrays: a slice's voters as int32 limb arrays, in numpy) over
the window's full slices."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "stream.arrays", "closed", full=True)

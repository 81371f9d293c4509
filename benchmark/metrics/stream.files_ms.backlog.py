"""stream.files_ms.backlog: the mean of the program's stream.files span (a
slice's proof and signal files and the cursor) over the window's full
slices."""
from benchmark.harness import spans


def read(run):
    return spans.mean_ms(run, "stream.files", "closed", full=True)

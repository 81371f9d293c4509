"""step.slice_ms.backlog: the mean prove_batch record of a full slice
(the captured step's replay and finalize)."""
from benchmark.harness import cell


def read(run):
    return cell.full_slice_ms(run)

"""proofs_per_s: proofs written in a backlog's window over its whole
elapsed time, from the start of the first call of ProofStream.run to the
end of the call that closed the window."""
from benchmark.harness import cell


def read(run):
    return cell.rate(run)

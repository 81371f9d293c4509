"""stream.host_ms_per_proof.backlog: ProofStream.run's time outside the
program's prove_batch (its Metrics records), per proof: batch_to_arrays,
the files and the cursor."""
from benchmark.harness import cell


def read(run):
    return cell.host_ms_per_proof(run)

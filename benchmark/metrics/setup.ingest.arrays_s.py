"""setup.ingest.arrays_s: the program's ingest.arrays_from_zkey span in
set-up: the sparse A and B arrays from the key's coefficient section,
and the parsed key's release after that, its last use."""
from benchmark.harness import spans


def read(run):
    return spans.process_s("ingest.arrays_from_zkey")

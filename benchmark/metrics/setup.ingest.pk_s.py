"""setup.ingest.pk_s: the program's ingest.pk_from_zkey span in set-up:
the parsed key's tables as a ProvingKey and its VerifyingKey."""
from benchmark.harness import spans


def read(run):
    return spans.process_s("ingest.pk_from_zkey")

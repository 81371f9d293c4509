"""setup.ingest.read_zkey_s: the program's ingest.read_zkey span in set-up:
serialize.read_zkey parsing the key's bytes (host Python)."""
from benchmark.harness import spans


def read(run):
    return spans.process_s("ingest.read_zkey")

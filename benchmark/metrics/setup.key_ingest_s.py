"""setup.key_ingest_s: the benchmark's span around the program's
zkey_compat.ingest_zkey of the key's bytes (read_zkey, pk_from_zkey,
arrays_from_zkey: host Python)."""


def read(run):
    return run.spans.get("key_ingest")

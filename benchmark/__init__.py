"""The benchmark of zkfranchise_tpu_torch, the PyTorch and CUDA census
prover: one command (``python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``) runs one cell of ``BENCHMARK.json`` on
the card and prints one JSON line.  Configurations, traffic mixes and
metrics are files found by the names that ``BENCHMARK.json`` gives them:
``configs/<name>.json``, ``traffic/<name>.json`` (with
``traffic/<name>/<configuration>.json`` beside it where a mix takes a
number per configuration) and ``metrics/<name>.py``.  The yardstick, the
plain reference of the census statement and of Groth16, is
``reference/``."""

"""setup_s: the process's start to the window's start -- kernels loaded,
the circuit built, the key read and ingested, the prover, the voters, the
captured steps and one untimed slice of every captured size."""


def read(run):
    return run.setup_s

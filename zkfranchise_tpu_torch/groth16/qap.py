"""QAP construction shared by setup and prover.

The R1CS rows are extended with one binding row per public signal
(including the constant-1 wire): row nc+i is <w_i> * 0 = 0.  These rows are
trivially satisfied but give every public wire a nonzero A-polynomial, which
the pairing equation then binds to the claimed public signals.  Without
them, the deliberately-unconstrained voteHash public inputs
(upstream circuit/census.circom:54-57) would be malleable — snarkjs
does the same in its groth16 setup.
"""
from __future__ import annotations

from ..ops import ff

P = ff.P_FR


def binding_rows(num_public: int):
    """Rows appended after the circuit constraints: for i in 0..num_public,
    A = {i: 1}, B = {}, C = {}."""
    return [({i: 1}, {}, {}) for i in range(num_public + 1)]


def domain_size(num_constraints: int, num_public: int) -> int:
    n_eff = num_constraints + num_public + 1
    n = 1
    while n < n_eff:
        n *= 2
    return n


def eval_witness_rows(constraints, num_public: int, w: list[int], n: int):
    """az/bz/cz vectors of length n (domain size) over the extended rows."""
    az = [0] * n
    bz = [0] * n
    cz = [0] * n
    for r, (a, b, c) in enumerate(constraints):
        az[r] = sum(cf * w[i] for i, cf in a.items()) % P
        bz[r] = sum(cf * w[i] for i, cf in b.items()) % P
        cz[r] = sum(cf * w[i] for i, cf in c.items()) % P
    nc = len(constraints)
    for i in range(num_public + 1):
        az[nc + i] = w[i] % P
    return az, bz, cz

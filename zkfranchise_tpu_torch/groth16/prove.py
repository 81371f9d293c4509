"""Groth16 prover: host reference implementation.

The math that upstream delegates to go-rapidsnark and snarkjs
groth16.fullProve: witness -> az/bz/cz, quotient-polynomial evaluations
via coset NTT, four G1 MSMs + one G2 MSM, r/s blinding.  This host path
(Python integers, the native host library for the MSMs when it is built)
is the correctness oracle; the prover in groth16/device.py runs the same
pipeline through the NTT and MSM kernels on the card and gives the same
proof for the same witness, r and s.
"""
from __future__ import annotations

import secrets

from ..ops import ec, ff
from ..utils import native
from . import poly, qap
from .setup import ProvingKey
from .verify import Proof

P = ff.P_FR


def pippenger_host(scalars: list[int], points: list, group=ec.G1):
    """Host MSM: native C++ Pippenger when built, Python fallback.  The
    curve is picked by the group's KIND (coordinates in Fq or in Fq2), so
    any G1 group object takes the G1 path, not only ``ec.G1`` itself."""
    if isinstance(group.fzero, tuple):
        return native.g2_msm(scalars, points)
    return native.g1_msm(scalars, points)


def prove_host(pk: ProvingKey, constraints, witness: list[int],
               r: int | None = None, s: int | None = None) -> Proof:
    """constraints: the circuit's R1CS rows (binding rows are appended
    internally, mirroring setup).  witness: plain ints, len n_vars."""
    assert len(witness) == pk.n_vars
    r = secrets.randbelow(P) if r is None else r % P
    s = secrets.randbelow(P) if s is None else s % P
    n = pk.domain

    az, bz, cz = qap.eval_witness_rows(constraints, pk.n_public, witness, n)
    a_cos = poly.coset_evals_from_domain_evals(az)
    b_cos = poly.coset_evals_from_domain_evals(bz)
    c_cos = poly.coset_evals_from_domain_evals(cz)
    q = [(a_cos[j] * b_cos[j] - c_cos[j]) % P for j in range(n)]

    g1 = ec.G1
    g2 = ec.G2
    pi_a = g1.add(pk.alpha_g1, pippenger_host(witness, pk.a_g1))
    pi_a = g1.add(pi_a, g1.mul(r, pk.delta_g1))

    pi_b1 = g1.add(pk.beta_g1, pippenger_host(witness, pk.b_g1))
    pi_b1 = g1.add(pi_b1, g1.mul(s, pk.delta_g1))

    pi_b = g2.add(pk.beta_g2, pippenger_host(witness, pk.b_g2, group=g2))
    pi_b = g2.add(pi_b, g2.mul(s, pk.delta_g2))

    priv = witness[pk.n_public + 1:]
    pi_c = pippenger_host(priv, pk.k_g1)
    pi_c = g1.add(pi_c, pippenger_host(q, pk.h_g1))
    pi_c = g1.add(pi_c, g1.mul(s, pi_a))
    pi_c = g1.add(pi_c, g1.mul(r, pi_b1))
    pi_c = g1.add(pi_c, g1.neg(g1.mul(r * s % P, pk.delta_g1)))

    return Proof({
        "pi_a": [str(pi_a[0]), str(pi_a[1]), "1"],
        "pi_b": [[str(pi_b[0][0]), str(pi_b[0][1])],
                 [str(pi_b[1][0]), str(pi_b[1][1])], ["1", "0"]],
        "pi_c": [str(pi_c[0]), str(pi_c[1]), "1"],
    })

"""Host polynomial/NTT utilities over BN254 Fr (radix-2, power-of-two domains).

Golden reference for the device NTT kernels in ops/ntt.py, and the engine of
the host prover.  BN254 Fr has 2-adicity 28 (r - 1 = 2^28 * odd), plenty for
every zkCensus domain (2^13 at nlevels=4 up to 2^17 at nlevels=160).
"""
from __future__ import annotations

import functools

from ..ops import ff

P = ff.P_FR
TWO_ADICITY = 28

# multiplicative generator of Fr* (smallest; 5 generates the full group)
FR_GENERATOR = 5
# coset shift for the quotient-polynomial evaluation domain
COSET_SHIFT = FR_GENERATOR


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity."""
    assert 0 <= log_n <= TWO_ADICITY
    base = pow(FR_GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - log_n):
        base = base * base % P
    return base


def _bit_reverse(vec: list[int]) -> list[int]:
    n = len(vec)
    logn = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        j = int(bin(i)[2:].zfill(logn)[::-1], 2)
        out[j] = vec[i]
    return out


def ntt(vec: list[int], inverse: bool = False) -> list[int]:
    """In-order radix-2 NTT: evals v[j] = sum_i a_i w^{ij} (forward) over the
    2^k domain; inverse recovers coefficients."""
    n = len(vec)
    assert n & (n - 1) == 0
    logn = n.bit_length() - 1
    w = root_of_unity(logn)
    if inverse:
        w = ff.inv_mod(w, P)
    a = _bit_reverse(vec)
    size = 2
    while size <= n:
        step = pow(w, n // size, P)
        half = size // 2
        for start in range(0, n, size):
            tw = 1
            for k in range(half):
                lo = a[start + k]
                hi = a[start + k + half] * tw % P
                a[start + k] = (lo + hi) % P
                a[start + k + half] = (lo - hi) % P
                tw = tw * step % P
        size *= 2
    if inverse:
        ninv = ff.inv_mod(n, P)
        a = [x * ninv % P for x in a]
    return a


def coset_evals_from_domain_evals(evals: list[int]) -> list[int]:
    """Domain evals of a degree<n polynomial -> evals on the coset s*w^j."""
    coefs = ntt(evals, inverse=True)
    shifted = [c * pow(COSET_SHIFT, i, P) % P for i, c in enumerate(coefs)]
    return ntt(shifted)


def lagrange_evals_at(tau: int, n: int, shift: int = 1) -> list[int]:
    """L_j(tau) for the (optionally coset-shifted) domain {shift * w^j}:
    L_j(tau) = (tau^n - shift^n) * x_j / (n * shift^n * (tau - x_j))."""
    logn = n.bit_length() - 1
    w = root_of_unity(logn)
    sn = pow(shift, n, P)
    zn = (pow(tau, n, P) - sn) % P
    xs = []
    x = shift % P
    for _ in range(n):
        xs.append(x)
        x = x * w % P
    denoms = [(n * sn % P) * ((tau - xj) % P) % P for xj in xs]
    inv_denoms = ff.batch_inv(denoms, P)
    return [zn * xj % P * d % P for xj, d in zip(xs, inv_denoms)]

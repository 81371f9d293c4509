"""Host-side (pure Python bigint) finite-field reference for BN254.

This module is the golden reference every device kernel is tested against.
It also serves the host-only paths (trusted setup, pairing verifier) where
arbitrary-precision Python ints are the right tool.

Field constants match the reference implementation:
  * Fr modulus r: upstream internal/helpers.go:15 and
    upstream ts_inputs/src/ff.ts:1 (BN254 scalar field).
  * Fq modulus q: BN254 base field (used by snarkjs/go-rapidsnark internally
    for all G1/G2/pairing arithmetic consumed at
    upstream zk_census_test.go:89,122).
"""
from __future__ import annotations

# BN254 scalar field modulus (order of G1/G2; the circuit's native field).
P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field modulus (coordinates of curve points).
P_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# BN254 curve parameter u (for pairing loop counts).
BN_U = 4965661367192848881


def fr(x: int) -> int:
    return x % P_FR


def fq(x: int) -> int:
    return x % P_FQ


def big_to_ff(x: int, p: int = P_FR) -> int:
    """Semantics of BigToFF (upstream internal/helpers.go:17-26):
    if x == p -> 0; if 0 <= x < p -> x; else x mod p."""
    if x == p:
        return 0
    if 0 <= x < p:
        return x
    return x % p


def inv_mod(a: int, p: int) -> int:
    if a % p == 0:
        raise ZeroDivisionError("inverse of zero")
    # extended Euclid: about ten times faster than a^(p-2) on these
    # sizes, and the host oracle inverts once per affine addition
    return pow(a, -1, p)


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks square root; returns None if a is not a QR."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    # p % 4 == 3 fast path (true for BN254 Fq).
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
        return r
    # generic Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def batch_inv(xs: list[int], p: int) -> list[int]:
    """Montgomery batch inversion. Zero entries map to zero."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % p
    inv = inv_mod(prefix[n], p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if xs[i] == 0:
            out[i] = 0
        else:
            out[i] = prefix[i] * inv % p
            inv = inv * xs[i] % p
    return out

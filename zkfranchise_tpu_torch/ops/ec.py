"""Host-side BN254 (alt_bn128) elliptic-curve arithmetic: G1, G2 over Fq2.

Pure-Python reference for the curve groups underlying Groth16 — the math
the reference delegates to go-rapidsnark / snarkjs
(upstream zk_census_test.go:89,122).  Used by the trusted setup,
the verifier, and as the golden oracle for the device MSM kernels.

Curve: E(Fq):  y^2 = x^3 + 3,  generator (1, 2), prime order r.
Twist: E'(Fq2): y^2 = x^3 + 3/(9+u)  (D-type), Fq2 = Fq[u]/(u^2+1).
Points are affine tuples; None is the identity.
"""
from __future__ import annotations

from . import ff

Q = ff.P_FQ
R_ORDER = ff.P_FR

G1_GEN = (1, 2)

# Standard alt_bn128 G2 generator (matches vk_gamma_2 in the reference
# verification key — snarkjs fixes gamma = 1 so vk_gamma_2 is the generator:
# upstream artifacts/zkCensus/dev/160/verification_key.json).
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    return ((a[0] * b[0] - a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = ff.inv_mod(norm, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)

# Twist coefficient b' = 3 / (9 + u)
B2 = fq2_mul((3, 0), fq2_inv((9, 1)))


# ---------------------------------------------------------------------------
# generic affine group ops, parameterized by field ops
# ---------------------------------------------------------------------------

class _Group:
    def __init__(self, add, sub, mul, inv, sqr, scalar, zero, one, b):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.finv, self.fsqr, self.fscalar = inv, sqr, scalar
        self.fzero, self.fone, self.b = zero, one, b

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.fsub(self.fsqr(y),
                         self.fadd(self.fmul(self.fsqr(x), x), self.b)) \
            == self.fzero

    def add(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if a[0] == b[0]:
            if self.fadd(a[1], b[1]) == self.fzero:
                return None
            return self.double(a)
        lam = self.fmul(self.fsub(b[1], a[1]),
                        self.finv(self.fsub(b[0], a[0])))
        x = self.fsub(self.fsub(self.fsqr(lam), a[0]), b[0])
        y = self.fsub(self.fmul(lam, self.fsub(a[0], x)), a[1])
        return (x, y)

    def double(self, a):
        if a is None:
            return None
        lam = self.fmul(self.fscalar(self.fsqr(a[0]), 3),
                        self.finv(self.fscalar(a[1], 2)))
        x = self.fsub(self.fsqr(lam), self.fscalar(a[0], 2))
        y = self.fsub(self.fmul(lam, self.fsub(a[0], x)), a[1])
        return (x, y)

    def neg(self, a):
        if a is None:
            return None
        return (a[0], self.fsub(self.fzero, a[1]))

    def mul(self, k: int, a):
        k %= R_ORDER
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, a)
            a = self.double(a)
            k >>= 1
        return acc


def _fq_ops():
    return _Group(
        add=lambda a, b: (a + b) % Q,
        sub=lambda a, b: (a - b) % Q,
        mul=lambda a, b: a * b % Q,
        inv=lambda a: ff.inv_mod(a, Q),
        sqr=lambda a: a * a % Q,
        scalar=lambda a, k: a * k % Q,
        zero=0, one=1, b=3,
    )


G1 = _fq_ops()
G2 = _Group(
    add=fq2_add, sub=fq2_sub, mul=fq2_mul, inv=fq2_inv, sqr=fq2_sqr,
    scalar=fq2_scalar, zero=FQ2_ZERO, one=FQ2_ONE, b=B2,
)


def _mul_nored(k: int, a, group):
    """double-and-add WITHOUT reducing k mod r — required for order
    checks, where G.mul's `k %= r` would turn [r]P into [0]P."""
    acc = None
    while k:
        if k & 1:
            acc = group.add(acc, a)
        a = group.double(a)
        k >>= 1
    return acc


def in_subgroup_g2(pt) -> bool:
    """True iff pt is in the order-r subgroup of the twist.  BN254's
    twist E'(Fq2) has a large cofactor (order = r * c2, c2 ~ p), so
    on-curve does NOT imply order r; rogue points outside the r-torsion
    must not reach the pairing.  gnark-crypto enforces this on G2
    deserialization (reference call path
    upstream zk_census_test.go:118)."""
    if pt is None:
        return True
    return _mul_nored(R_ORDER, pt, G2) is None


def fq2_sqrt(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) (q = 3 mod 4), or None.
    Complex-method: via the norm a0^2 + a1^2."""
    def sqrt_fq(x):
        r = pow(x % Q, (Q + 1) // 4, Q)
        return r if r * r % Q == x % Q else None

    a0, a1 = a[0] % Q, a[1] % Q
    if a1 == 0:
        r = sqrt_fq(a0)
        if r is not None:
            return (r, 0)
        r = sqrt_fq(-a0 % Q)
        return None if r is None else (0, r)
    s = sqrt_fq((a0 * a0 + a1 * a1) % Q)
    if s is None:
        return None
    inv2 = ff.inv_mod(2, Q)
    delta = (a0 + s) * inv2 % Q
    x0 = sqrt_fq(delta)
    if x0 is None:
        x0 = sqrt_fq((a0 - s) * inv2 % Q)
        if x0 is None:
            return None
    x1 = a1 * ff.inv_mod(2 * x0 % Q, Q) % Q
    out = (x0, x1)
    return out if fq2_sqr(out) == (a0, a1) else None


def rogue_g2_point():
    """An on-twist point OUTSIDE the order-r subgroup (for negative
    tests of the subgroup check): try-and-increment over x = (i, 1)."""
    for i in range(1, 1000):
        x = (i, 1)
        y = fq2_sqrt(fq2_add(fq2_mul(fq2_sqr(x), x), B2))
        if y is None:
            continue
        pt = (x, y)
        assert G2.is_on_curve(pt)
        if not in_subgroup_g2(pt):
            return pt
    raise AssertionError("no rogue point found (cofactor 1?)")


def g1_mul(k: int):
    return G1.mul(k, G1_GEN)


def g2_mul(k: int):
    return G2.mul(k, G2_GEN)


def msm_host(scalars: list[int], points: list, group=G1):
    """Naive host MSM (oracle for the device Pippenger kernels)."""
    acc = None
    for s, p in zip(scalars, points):
        if s % R_ORDER:
            acc = group.add(acc, group.mul(s, p))
    return acc

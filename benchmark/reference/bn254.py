"""BN254 (alt_bn128): G1 over Fq, G2 over Fq2, and the optimal-ate pairing.

Curve E(Fq): y^2 = x^3 + 3.  Twist E'(Fq2): y^2 = x^3 + 3/(9+u), Fq2 =
Fq[u]/(u^2 + 1).  Points are affine tuples, None the identity.  Fq12 =
Fq[w]/(w^12 - 18 w^6 + 82), so u = w^6 - 9; a G2 point maps into E(Fq12)
by (x, y) -> (x w^2, y w^3).  The Miller loop runs over 6u + 2 with two
Frobenius line corrections; the final exponent (q^12 - 1)/r splits as
(q^6 - 1)(q^2 + 1) times (q^4 - q^2 + 1)/r.
"""
from __future__ import annotations

from .field import BN_U, P_FQ as Q, P_FR as R, inv

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    ninv = inv((a[0] * a[0] + a[1] * a[1]) % Q, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


# ---------------------------------------------------------------------------
# affine groups
# ---------------------------------------------------------------------------


class Group:
    """Affine short-Weierstrass arithmetic over a field given by its
    operations."""

    def __init__(self, add, sub, mul, finv, scalar, zero, b):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.finv, self.fscalar, self.fzero, self.b = finv, scalar, zero, b

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.fsub(self.fmul(y, y), self.fadd(
            self.fmul(self.fmul(x, x), x), self.b)) == self.fzero

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
        x = self.fsub(self.fsub(self.fmul(lam, lam), a[0]), b[0])
        return (x, self.fsub(self.fmul(lam, self.fsub(a[0], x)), a[1]))

    def double(self, a):
        if a is None:
            return None
        lam = self.fmul(self.fscalar(self.fmul(a[0], a[0]), 3),
                        self.finv(self.fscalar(a[1], 2)))
        x = self.fsub(self.fmul(lam, lam), self.fscalar(a[0], 2))
        return (x, self.fsub(self.fmul(lam, self.fsub(a[0], x)), a[1]))

    def neg(self, a):
        return None if a is None else (a[0], self.fsub(self.fzero, a[1]))

    def mul(self, k: int, a):
        """k * a by double-and-add, k NOT reduced mod r (so r * a is the
        identity only for a of order r)."""
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, a)
            a = self.double(a)
            k >>= 1
        return acc


G1 = Group(add=lambda a, b: (a + b) % Q, sub=lambda a, b: (a - b) % Q,
           mul=lambda a, b: a * b % Q, finv=lambda a: inv(a, Q),
           scalar=lambda a, k: a * k % Q, zero=0, b=3)
G2 = Group(add=fq2_add, sub=fq2_sub, mul=fq2_mul, finv=fq2_inv,
           scalar=fq2_scalar, zero=(0, 0),
           b=fq2_mul((3, 0), fq2_inv((9, 1))))


def in_g2_subgroup(pt) -> bool:
    """The twist has a large cofactor: on-curve is not enough, the point
    must have order r (gnark-crypto checks this on deserialisation)."""
    return pt is None or G2.mul(R, pt) is None


# ---------------------------------------------------------------------------
# Fq12 and the pairing
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = 6 * BN_U + 2


def fq12_one():
    return [1] + [0] * 11


def fq12_add(a, b):
    return [(x + y) % Q for x, y in zip(a, b)]


def fq12_sub(a, b):
    return [(x - y) % Q for x, y in zip(a, b)]


def fq12_scalar(a, k):
    return [x * k % Q for x in a]


def fq12_neg(a):
    return [(-x) % Q for x in a]


def fq12_mul(a, b):
    t = [0] * 23
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                if y:
                    t[i + j] += x * y
    for d in range(22, 11, -1):             # w^12 = 18 w^6 - 82
        c = t[d]
        if c:
            t[d] = 0
            t[d - 6] += 18 * c
            t[d - 12] -= 82 * c
    return [x % Q for x in t[:12]]


def fq12_inv(a):
    """Inverse by the extended Euclidean algorithm over Fq[w]."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [82, 0, 0, 0, 0, 0, Q - 18, 0, 0, 0, 0, 0, 1]

    def deg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i]:
                return i
        return 0

    def rounded_div(aa, bb):
        da, db = deg(aa), deg(bb)
        temp, o = list(aa), [0] * len(aa)
        binv = inv(bb[db], Q)
        for i in range(da - db, -1, -1):
            o[i] = (o[i] + temp[db + i] * binv) % Q
            for c in range(db + 1):
                temp[c + i] = (temp[c + i] - o[i] * bb[c]) % Q
        return o[:deg(o) + 1]

    while deg(low):
        r = rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm, new = list(hm), list(high)
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                new[i + j] = (new[i + j] - low[i] * r[j]) % Q
        high, low, hm, lm = low, new, lm, nm
    linv = inv(low[0], Q)
    return [x * linv % Q for x in lm[:12]]


def fq12_pow(a, e: int):
    result, base = fq12_one(), a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        e >>= 1
    return result


def _embed_fq2(x2):
    out = [0] * 12
    out[0], out[6] = (x2[0] - 9 * x2[1]) % Q, x2[1] % Q
    return out


def _twist(pt):
    x, y = pt
    w2, w3 = [0] * 12, [0] * 12
    w2[2] = w3[3] = 1
    return (fq12_mul(_embed_fq2(x), w2), fq12_mul(_embed_fq2(y), w3))


def _embed_g1(pt):
    return ([pt[0] % Q] + [0] * 11, [pt[1] % Q] + [0] * 11)


def _double12(pt):
    x, y = pt
    lam = fq12_mul(fq12_scalar(fq12_mul(x, x), 3),
                   fq12_inv(fq12_scalar(y, 2)))
    nx = fq12_sub(fq12_mul(lam, lam), fq12_scalar(x, 2))
    return (nx, fq12_sub(fq12_mul(lam, fq12_sub(x, nx)), y))


def _add12(a, b):
    if a[0] == b[0]:
        return _double12(a) if a[1] == b[1] else None
    lam = fq12_mul(fq12_sub(b[1], a[1]), fq12_inv(fq12_sub(b[0], a[0])))
    nx = fq12_sub(fq12_sub(fq12_mul(lam, lam), a[0]), b[0])
    return (nx, fq12_sub(fq12_mul(lam, fq12_sub(a[0], nx)), a[1]))


def _line(p1, p2, t):
    """The line through p1 and p2 (the tangent if equal) at t."""
    (x1, y1), (x2, y2), (xt, yt) = p1, p2, t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    elif y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3),
                     fq12_inv(fq12_scalar(y1, 2)))
    else:
        return fq12_sub(xt, x1)
    return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))


_W_QK: dict = {}


def _frobenius(a, k: int = 1):
    """a^(q^k): the coefficients are fixed, w goes to w^(q^k)."""
    if k not in _W_QK:
        wqk = fq12_pow([0, 1] + [0] * 10, Q ** k)
        pows = [fq12_one()]
        for _ in range(11):
            pows.append(fq12_mul(pows[-1], wqk))
        _W_QK[k] = pows
    out = [0] * 12
    for c, wpow in zip(a, _W_QK[k]):
        if c:
            out = fq12_add(out, fq12_scalar(wpow, c))
    return out


def miller_loop(p_g1, q_g2):
    """The Miller loop of e(P, Q) (no final exponentiation); 1 if either
    is the identity."""
    if p_g1 is None or q_g2 is None:
        return fq12_one()
    q, p = _twist(q_g2), _embed_g1(p_g1)
    r, f = q, fq12_one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = fq12_mul(fq12_mul(f, f), _line(r, r, p))
        r = _double12(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = fq12_mul(f, _line(r, q, p))
            r = _add12(r, q)
    q1 = (_frobenius(q[0]), _frobenius(q[1]))
    nq2 = (_frobenius(q1[0]), fq12_neg(_frobenius(q1[1])))
    f = fq12_mul(f, _line(r, q1, p))
    r = _add12(r, q1)
    return fq12_mul(f, _line(r, nq2, p))


_HARD_EXP, _rem = divmod(Q ** 4 - Q ** 2 + 1, R)
assert _rem == 0
del _rem


def final_exponentiate(f):
    if not any(f):
        return [0] * 12
    f = fq12_mul(_frobenius(f, 6), fq12_inv(f))
    f = fq12_mul(_frobenius(f, 2), f)
    return fq12_pow(f, _HARD_EXP)


def product_is_one(loops: list) -> bool:
    """Whether the product of Miller-loop values is 1 after the final
    exponentiation: prod e(P_i, Q_i) == 1."""
    f = fq12_one()
    for m in loops:
        f = fq12_mul(f, m)
    return final_exponentiate(f) == fq12_one()

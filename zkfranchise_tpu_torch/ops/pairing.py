"""BN254 optimal-ate pairing (host-side) for Groth16 verification.

Replaces the pairing check the reference delegates to go-rapidsnark's
verifier / snarkjs (upstream zk_census_test.go:118-122).  The
verifier consumes the reference verification_key.json / proof.json /
signals.json formats verbatim; the committed reference proof is the golden
test vector for this module.

Construction (standard for alt_bn128): Fq12 as Fq[w]/(w^12 - 18 w^6 + 82)
— so u = w^6 - 9 generates the Fq2 subfield — with G2 points mapped into
E(Fq12) via the twist (x, y) -> (x' w^2, y' w^3).  Miller loop over
6u+2 = 29793968203157093288, two Frobenius line corrections, then final
exponentiation by (q^12 - 1)/r, split as (q^6 - 1)(q^2 + 1) (Frobenius
maps and one inversion) times (q^4 - q^2 + 1)/r (a square-and-multiply
over 762 bits in place of 3,048).
"""
from __future__ import annotations

from . import ec, ff

Q = ff.P_FQ
ATE_LOOP_COUNT = 6 * ff.BN_U + 2  # 29793968203157093288

# Fq12 = Fq[w] / (w^12 - 18 w^6 + 82); elements are 12-coeff lists.
_MOD_W6 = 18
_MOD_CONST = -82


def fq12_one():
    return [1] + [0] * 11


def fq12_zero():
    return [0] * 12


def fq12_add(a, b):
    return [(x + y) % Q for x, y in zip(a, b)]


def fq12_sub(a, b):
    return [(x - y) % Q for x, y in zip(a, b)]


def fq12_scalar(a, k):
    return [x * k % Q for x in a]


def fq12_mul(a, b):
    t = [0] * 23
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                if y:
                    t[i + j] += x * y
    # reduce degrees 22..12 with w^12 = 18 w^6 - 82
    for d in range(22, 11, -1):
        c = t[d]
        if c:
            t[d] = 0
            t[d - 6] += c * _MOD_W6
            t[d - 12] += c * _MOD_CONST
    return [x % Q for x in t[:12]]


def fq12_neg(a):
    return [(-x) % Q for x in a]


def fq12_inv(a):
    """Inverse via extended Euclid on polynomials over Fq."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    # modulus polynomial w^12 - 18 w^6 + 82, coeffs mod Q
    high = [82 % Q, 0, 0, 0, 0, 0, (-18) % Q, 0, 0, 0, 0, 0, 1]

    def deg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i]:
                return i
        return 0

    def poly_rounded_div(aa, bb):
        dega, degb = deg(aa), deg(bb)
        temp = list(aa)
        o = [0] * len(aa)
        binv = ff.inv_mod(bb[degb], Q)
        for i in range(dega - degb, -1, -1):
            o[i] = (o[i] + temp[degb + i] * binv) % Q
            for c in range(degb + 1):
                temp[c + i] = (temp[c + i] - o[i] * bb[c]) % Q
        return [x % Q for x in o[:deg(o) + 1]]

    while deg(low):
        r = poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = list(hm)
        new = list(high)
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                new[i + j] = (new[i + j] - low[i] * r[j]) % Q
        high, low, hm, lm = low, new, lm, nm
    linv = ff.inv_mod(low[0], Q)
    return [x * linv % Q for x in lm[:12]]


def fq12_pow(a, e: int):
    result = fq12_one()
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        e >>= 1
    return result


# -- embedding / twist -------------------------------------------------------

def embed_fq(x: int):
    out = fq12_zero()
    out[0] = x % Q
    return out


def embed_fq2(x2) -> list:
    """(a + b u) -> (a - 9b) + b w^6."""
    a, b = x2
    out = fq12_zero()
    out[0] = (a - 9 * b) % Q
    out[6] = b % Q
    return out


def twist_g2(pt):
    """Affine G2 point over Fq2 -> point on E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    w2 = fq12_zero(); w2[2] = 1
    w3 = fq12_zero(); w3[3] = 1
    return (fq12_mul(embed_fq2(x), w2), fq12_mul(embed_fq2(y), w3))


def embed_g1(pt):
    if pt is None:
        return None
    return (embed_fq(pt[0]), embed_fq(pt[1]))


# -- curve ops over Fq12 -----------------------------------------------------

def _double(pt):
    x, y = pt
    lam = fq12_mul(fq12_scalar(fq12_mul(x, x), 3),
                   fq12_inv(fq12_scalar(y, 2)))
    nx = fq12_sub(fq12_mul(lam, lam), fq12_scalar(x, 2))
    ny = fq12_sub(fq12_mul(lam, fq12_sub(x, nx)), y)
    return (nx, ny)


def _add(a, b):
    if a[0] == b[0]:
        if a[1] == b[1]:
            return _double(a)
        return None
    lam = fq12_mul(fq12_sub(b[1], a[1]), fq12_inv(fq12_sub(b[0], a[0])))
    nx = fq12_sub(fq12_sub(fq12_mul(lam, lam), a[0]), b[0])
    ny = fq12_sub(fq12_mul(lam, fq12_sub(a[0], nx)), a[1])
    return (nx, ny)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (or tangent if equal) at point t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3),
                     fq12_inv(fq12_scalar(y1, 2)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


FINAL_EXP = (Q ** 12 - 1) // ff.P_FR


def miller_loop(q_tw, p_emb):
    """Miller loop for twisted Q and embedded P; no final exponentiation."""
    if q_tw is None or p_emb is None:
        return fq12_one()
    r = q_tw
    f = fq12_one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = fq12_mul(fq12_mul(f, f), _linefunc(r, r, p_emb))
        r = _double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = fq12_mul(f, _linefunc(r, q_tw, p_emb))
            r = _add(r, q_tw)
    # Frobenius corrections: Q1 = pi_q(Q), nQ2 = -pi_q(Q1)
    q1 = (frobenius(q_tw[0]), frobenius(q_tw[1]))
    nq2 = (frobenius(q1[0]), fq12_neg(frobenius(q1[1])))
    f = fq12_mul(f, _linefunc(r, q1, p_emb))
    r = _add(r, q1)
    f = fq12_mul(f, _linefunc(r, nq2, p_emb))
    return f


# the hard part of the final exponent: r divides q^4 - q^2 + 1 (the 12th
# cyclotomic polynomial at q), so FINAL_EXP = (q^6-1)(q^2+1) * _HARD_EXP
_HARD_EXP, _rem = divmod(Q ** 4 - Q ** 2 + 1, ff.P_FR)
assert _rem == 0 and (Q ** 6 - 1) * (Q ** 2 + 1) * _HARD_EXP == FINAL_EXP
del _rem


def _w_pow_q(k: int = 1):
    """[w^(q^k)^i for i < 12] as Fq12 elements (cached per k)."""
    if k not in _W_QK:
        wqk = fq12_pow([0, 1] + [0] * 10, Q ** k)
        pows = [fq12_one()]
        for _ in range(11):
            pows.append(fq12_mul(pows[-1], wqk))
        _W_QK[k] = pows
    return _W_QK[k]


_W_QK: dict = {}


def frobenius(a, k: int = 1):
    """x -> x^(q^k) on Fq12: coefficients are Fq (fixed by Frobenius), so
    substitute w -> w^(q^k) in sum c_i w^i."""
    out = fq12_zero()
    for c, wpow in zip(a, _w_pow_q(k)):
        if c:
            out = fq12_add(out, fq12_scalar(wpow, c))
    return out


def final_exponentiate(f):
    """f^((q^12 - 1)/r): f^(q^6 - 1) = f^(q^6) / f, then ^(q^2 + 1), then
    the hard part by square-and-multiply."""
    if not any(f):
        return fq12_zero()
    f = fq12_mul(frobenius(f, 6), fq12_inv(f))
    f = fq12_mul(frobenius(f, 2), f)
    return fq12_pow(f, _HARD_EXP)


def pairing(p_g1, q_g2):
    """e(P, Q) for P in G1 (affine Fq pair), Q in G2 (affine Fq2 pair)."""
    return final_exponentiate(miller_loop(twist_g2(q_g2), embed_g1(p_g1)))


def multi_pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = fq12_one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(twist_g2(q), embed_g1(p)))
    return final_exponentiate(f) == fq12_one()

"""Affine point planes and the batch-affine fold for the MSM sum tree.

Every affine coordinate here is the EXACT canonical Montgomery
representative (value < p, exact 13-bit limbs), and the point at infinity
is an explicit 0/1 mask row carried with the plane:

    G1 affine: rows [0:21) x | [21:42) y | row 42 inf mask   (43 rows)
    G2 affine: [0:42) x (re,im) | [42:84) y | row 84 inf     (85 rows)

Canonical coordinates make the exceptional-case tests of ``fold_affine``
pure limb comparisons: equal x is all limbs equal; opposite y is
norm_exact(y1 + y2) == p per component (y == 0 cannot occur for real
points, G1 and G2 have prime order; all-zero pairs count as opposite,
which arises only on masked lanes).  Every case of a complete addition
(add, double, P + (-P) = infinity, infinity operands) is handled exactly.

``fold_affine`` is one level of a sum tree in affine coordinates: the
division of the chord or tangent slope is shared by all lanes of a row
through a Montgomery batch inversion (``batch_inv``: its own kernels,
``fold_mul_levels`` up, the top with the Fermat chain, the walk down),
one Fermat chain per level; over Fq2
the inverse reduces to one Fq batch inversion of the norm.  The prover's
MSM takes the projective tree (``fold_padd_aa``, ``fold_padd``); times of
both trees on the card at the same width are in PERF.md.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ff, lm
from .cuda import lm_kernels as K

NL = lm.N_LIMBS
FQ = lm.FQ
G1_AROWS = 2 * NL + 1        # 43
G2_AROWS = 4 * NL + 1        # 85
AROWS = {"g1": G1_AROWS, "g2": G2_AROWS}
_R = 1 << lm.R_BITS
_Q = ff.P_FQ


# ---------------------------------------------------------------------------
# tables / conversions
# ---------------------------------------------------------------------------

def _affine_rows(points: list, coords: int, flat) -> np.ndarray:
    """(N, coords * 21 + 1) int32 rows: each point's `coords` coordinates
    (flat(pt) lists them) in Montgomery form, then the infinity flag; all
    coordinates cut into limbs in one lm.ints_to_limb_rows call."""
    vals = []
    for pt in points:
        vals.extend((0,) * coords if pt is None else flat(pt))
    limbs = lm.ints_to_limb_rows([v * _R % _Q for v in vals])
    out = np.zeros((len(points), coords * NL + 1), np.int32)
    out[:, :coords * NL] = limbs.reshape(len(points), coords * NL)
    out[:, coords * NL] = [pt is None for pt in points]
    return out


def g1_affine_table(points: list) -> np.ndarray:
    """Affine host points [(x, y) | None] -> (N, 43) int32 rows."""
    return _affine_rows(points, 2, lambda pt: pt)


def g2_affine_table(points: list) -> np.ndarray:
    return _affine_rows(points, 4, lambda pt: (*pt[0], *pt[1]))


def affine_table(points: list, kind: str) -> np.ndarray:
    return g1_affine_table(points) if kind == "g1" \
        else g2_affine_table(points)


def identity_rows(kind: str, n: int) -> np.ndarray:
    out = np.zeros((n, AROWS[kind]), np.int32)
    out[:, AROWS[kind] - 1] = 1
    return out


def _split(a: torch.Tensor, kind: str):
    k = 1 if kind == "g1" else 2
    return (a[..., :k * NL, :], a[..., k * NL:2 * k * NL, :],
            a[..., 2 * k * NL:, :])


def to_projective(a: torch.Tensor, kind: str) -> torch.Tensor:
    """Affine plane -> packed projective plane (ec_lm layout).
    Infinity lanes map to (0 : 1 : 0)."""
    x, y, inf = _split(a, kind)
    one = lm.const(FQ.one_mont, a.device).expand(*y.shape[:-2], NL,
                                                 y.shape[-1])
    onek = one if kind == "g1" else torch.cat([one, torch.zeros_like(one)],
                                              -2)
    m = (inf == 1)
    zero = torch.zeros((), dtype=lm.DTYPE, device=a.device)
    z = torch.where(m, zero, onek)
    y = torch.where(m, onek, y)
    x = torch.where(m, zero, x)
    return torch.cat([x, y, z], -2)


def _canon(a: torch.Tensor) -> torch.Tensor:
    """Montgomery-form redundant rep (value < 2^258) -> EXACT canonical
    representative: multiply by one_mont (same residue, tight), resolve
    carries, conditional subtract."""
    t = lm.mont_mul(a, lm.const(FQ.one_mont, a.device), FQ)
    return lm.cond_sub_p(lm.norm_exact(t), FQ)


def _canon_k(a: torch.Tensor, k: int) -> torch.Tensor:
    """Per-Fq-component canonicalization of a k-component plane."""
    if k == 1:
        return _canon(a)
    sh = (*a.shape[:-2], k, NL, a.shape[-1])
    return _canon(a.reshape(sh)).reshape(a.shape)


def neg_affine(a: torch.Tensor, kind: str) -> torch.Tensor:
    """-P: y -> p - y, output exact canonical (0 stays 0 via _canon)."""
    x, y, inf = _split(a, kind)
    k = 1 if kind == "g1" else 2
    d = lm.const(FQ.sub_d, a.device)
    dk = d if k == 1 else torch.cat([d, d], -2)
    ny = _canon_k(lm.weak_norm(dk - y), k)
    return torch.cat([x, ny, inf], -2)


# ---------------------------------------------------------------------------
# exact tests on canonical planes
# ---------------------------------------------------------------------------

def _eq_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exact canonical planes -> (..., 1, T) bool: all limbs equal."""
    return (a == b).all(dim=-2, keepdim=True)


def _is_neg_pair(y1: torch.Tensor, y2: torch.Tensor, k: int) -> torch.Tensor:
    """y2 == -y1 mod p per component, for exact canonical y.  All-zero
    component pairs count as opposite (only masked lanes)."""
    p_col = lm.const(FQ.p_limbs, y1.device)
    s = lm.norm_exact(y1 + y2)
    out = None
    for i in range(k):
        rows = slice(i * NL, (i + 1) * NL)
        zero = ((y1[..., rows, :] == 0) &
                (y2[..., rows, :] == 0)).all(dim=-2, keepdim=True)
        isp = (s[..., rows, :] == p_col).all(dim=-2, keepdim=True)
        o = isp | zero
        out = o if out is None else (out & o)
    return out


# ---------------------------------------------------------------------------
# Fq2 helpers (products through the mont_mul kernel)
# ---------------------------------------------------------------------------

def _fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 42, T) x (..., 42, T) -> (..., 42, T); re < 2^256 (the tight
    sub_d1 constant: same budget rules as ec_lm._mul_stack_fq2)."""
    a0, a1 = a[..., :NL, :], a[..., NL:, :]
    b0, b1 = b[..., :NL, :], b[..., NL:, :]
    v = K.mont_mul(torch.stack([a0, a1, a0, a1], -3),
                   torch.stack([b0, b1, b1, b0], -3), FQ)
    re = lm.weak_norm(v[..., 0, :, :] +
                      (lm.const(FQ.sub_d1, a.device) - v[..., 1, :, :]))
    im = lm.weak_norm(v[..., 2, :, :] + v[..., 3, :, :])
    return torch.cat([re, im], -2)


def _fq2_sub_n(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = lm.const(FQ.sub_d, a.device)
    return lm.weak_norm(a + (torch.cat([d, d], -2) - b))


# ---------------------------------------------------------------------------
# batch-affine fold: out[j] = x[j] (+) x[j + m/2]
# ---------------------------------------------------------------------------

def fold_affine(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(B, arows, m) affine planes (exact canonical coords) ->
    (B, arows, m/2) affine, exact canonical.  Complete."""
    k = 1 if kind == "g1" else 2
    dev = x.device
    h = x.shape[-1] // 2
    x1, y1, i1 = _split(x[..., :h], kind)
    x2, y2, i2 = _split(x[..., h:], kind)

    eq_x = _eq_rows(x1, x2)
    opp = _is_neg_pair(y1, y2, k)
    inf1, inf2 = (i1 == 1), (i2 == 1)
    either_inf = inf1 | inf2
    dbl = eq_x & ~opp & ~either_inf
    degen = either_inf | (eq_x & opp)

    one = lm.const(FQ.one_mont, dev)
    one1 = one.expand(*y1.shape[:-2], NL, y1.shape[-1])
    if k == 1:
        def sub_c(u, v):
            return lm.sub_n(u, v, FQ)

        def mul(u, v):
            return K.mont_mul(u, v, FQ)
        one_k = one1
    else:
        sub_c, mul = _fq2_sub_n, _fq2_mul
        one_k = torch.cat([one1, torch.zeros_like(one1)], -2)

    sqr = mul(x1, x1)
    num = torch.where(dbl, lm.weak_norm(sqr + sqr + sqr), sub_c(y2, y1))
    den = torch.where(dbl, lm.weak_norm(y1 + y1), sub_c(x2, x1))
    den = torch.where(degen, one_k, den)

    if k == 1:
        dinv = K.batch_inv(den, FQ)
    else:
        d0, d1 = den[..., :NL, :], den[..., NL:, :]
        nrm = lm.weak_norm(K.mont_mul(d0, d0, FQ) + K.mont_mul(d1, d1, FQ))
        nrm = torch.where(degen, one, nrm)
        ninv = K.batch_inv(nrm, FQ)
        dinv = torch.cat([K.mont_mul(d0, ninv, FQ),
                          lm.neg_n(K.mont_mul(d1, ninv, FQ), FQ)], -2)

    lam = mul(num, dinv)
    lam2 = mul(lam, lam)
    x3 = _canon_k(sub_c(sub_c(lam2, x1), x2), k)
    y3 = _canon_k(sub_c(mul(lam, sub_c(x1, x3)), y1), k)

    out_i = (inf1 & inf2) | (eq_x & opp & ~either_inf)
    zero = torch.zeros((), dtype=lm.DTYPE, device=dev)
    out_x = torch.where(out_i, zero,
                        torch.where(inf1, x2, torch.where(inf2, x1, x3)))
    out_y = torch.where(out_i, zero,
                        torch.where(inf1, y2, torch.where(inf2, y1, y3)))
    return torch.cat([out_x, out_y, out_i.to(lm.DTYPE)], -2)

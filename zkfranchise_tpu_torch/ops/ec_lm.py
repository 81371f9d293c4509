"""Limb-major EC arithmetic for BN254 G1/G2 (packed plane layout), PyTorch.

Points are homogeneous projective (X:Y:Z), coordinates in Montgomery form
over the 21x13 limb core (ops/lm.py):

  * G1 point plane: (..., 63, T) int32 — rows [0:21) X, [21:42) Y,
    [42:63) Z; T elements on the last axis.
  * G2 point plane: (..., 126, T) — each Fq2 coordinate is two stacked
    21-row Fq values (re, im).

The complete addition formulas (Renes-Costello-Batina 2015, Algorithm 7,
a = 0) are branch-free, so one function covers add, double and identity.
The functions here are the PLAIN versions of the CUDA kernels in
ops/cuda/lm_kernels.py (padd, fold_padd, fold_padd_aa); the kernels repeat
this arithmetic step for step, so both give the same limbs.  Host oracle:
ops/ec.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ec, ff, lm

NL = lm.N_LIMBS                       # 21
G1_ROWS = 3 * NL                      # 63
G2_ROWS = 6 * NL                      # 126
ROWS = {"g1": G1_ROWS, "g2": G2_ROWS}

_R = 1 << lm.R_BITS
_Q = ff.P_FQ
FQ = lm.FQ


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

def _mont_col(x: int) -> np.ndarray:
    return lm.int_to_limbs(x * _R % _Q)[:, None].astype(np.int32)


@functools.lru_cache(maxsize=None)
def b3_g1() -> np.ndarray:
    return _mont_col(9)               # 3*b, b = 3


@functools.lru_cache(maxsize=None)
def b3_g2() -> np.ndarray:
    """(42, 1): Fq2 3*b' for the twist, stacked (re, im)."""
    b3 = ec.fq2_scalar(ec.B2, 3)
    return np.concatenate([_mont_col(b3[0]), _mont_col(b3[1])], axis=0)


EC_CONST_ROWS = lm.N_CONST_ROWS + 3          # 6 field rows + b3g1 + b3g2


@functools.lru_cache(maxsize=None)
def pack_ec_consts() -> np.ndarray:
    """(9*21, 1) = (189, 1) int32 constant block for the EC kernels: the
    six Fq field rows of lm.pack_consts, then b3_g1 and b3_g2 (re, im)."""
    return np.concatenate([lm.pack_consts(FQ), b3_g1(), b3_g2()],
                          axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# Fq / Fq2 product rounds on stacked plane slices
# ---------------------------------------------------------------------------

def _c(arr, like):
    return lm.const(arr, like.device)


def _mul_stack_fq(lhs, rhs):
    """lhs/rhs: lists of (..., 21, T) -> list of products (one call)."""
    v = lm.mont_mul_ref(torch.stack(lhs, -3), torch.stack(rhs, -3), FQ)
    return list(v.unbind(-3))


def _mul_stack_fq2(lhs, rhs):
    """lhs/rhs: lists of (..., 42, T) Fq2 planes -> list of Fq2 products.
    Schoolbook with LAZY REDUCTION: 4 wide products but only 2 Montgomery
    reductions per Fq2 product:

      re = reduce( a0*b0 + a1*(D2 - b1) )        (D2 - b1 = -b1 mod p)
      im = reduce( a0*b1 + a1*b0 )

    Operands are < 2^258.6, so the negation uses sub_d2; the raw wide
    columns are weak-normalized before the pairwise sums (two raw wides
    would overflow int32)."""
    a = torch.stack(lhs, -3)
    b = torch.stack(rhs, -3)
    a0, a1 = a[..., :NL, :], a[..., NL:, :]
    b0, b1 = b[..., :NL, :], b[..., NL:, :]
    nb1 = lm.weak_norm(_c(FQ.sub_d2, b1) - b1)
    big_l = torch.stack([a0, a1, a0, a1], -3)
    big_r = torch.stack([b0, nb1, b1, b0], -3)
    w = lm.weak_norm(lm.wide_mul(big_l, big_r), 2)
    re = lm.mont_reduce(w[..., 0, :, :] + w[..., 1, :, :], FQ)
    im = lm.mont_reduce(w[..., 2, :, :] + w[..., 3, :, :], FQ)
    return list(torch.cat([re, im], -2).unbind(-3))


def _fq_sub_n(a, b):
    return lm.weak_norm(a + (_c(FQ.sub_d, a) - b))


def _fq2_sub_n(a, b):
    d = _c(FQ.sub_d, a)
    return lm.weak_norm(a + (torch.cat([d, d], -2) - b))


# ---------------------------------------------------------------------------
# complete addition (RCB15 Algorithm 7, a = 0)
# ---------------------------------------------------------------------------

def _round3_fq(t3, t4, y3b, t1, z3, x3):
    """Round 3 over Fq with lazy reduction: x3 = t3*t1 - t4*y3b,
    y3 = y3b*x3 + t1*z3, z3 = z3*t4 + x3*t3 as 6 wide products and 3
    reductions.  The subtraction negates before the product against
    sub_d2."""
    wn = lm.weak_norm
    ny3b = wn(_c(FQ.sub_d2, y3b) - y3b)
    L = torch.stack([t3, t4, y3b, t1, z3, x3], -3)
    R = torch.stack([t1, ny3b, x3, z3, t4, t3], -3)
    w = wn(lm.wide_mul(L, R), 2)
    x3o = lm.mont_reduce(w[..., 0, :, :] + w[..., 1, :, :], FQ)
    y3o = lm.mont_reduce(w[..., 2, :, :] + w[..., 3, :, :], FQ)
    z3o = lm.mont_reduce(w[..., 4, :, :] + w[..., 5, :, :], FQ)
    return x3o, y3o, z3o


def _round3_fq2(t3, t4, y3b, t1, z3, x3):
    """Round 3 over Fq2, fully lazy: 24 wide Fq products and SIX
    reductions (one per output component); signs fold into sub_d2
    negations before the products."""
    wn = lm.weak_norm
    d2 = _c(FQ.sub_d2, t3)

    def sp(v):
        return v[..., :NL, :], v[..., NL:, :]

    def n2(v):
        return wn(d2 - v)

    L, R = [], []
    for a, b, c, d, minus in (
            (t3, t1, t4, y3b, True),     # x3o = A*B - C*D
            (y3b, x3, t1, z3, False),    # y3o = A*B + C*D
            (z3, t4, x3, t3, False)):    # z3o = A*B + C*D
        a0, a1 = sp(a)
        b0, b1 = sp(b)
        c0, c1 = sp(c)
        d0, d1 = sp(d)
        L += [a0, a1, c0, c1]
        R += [b0, n2(b1)] + ([n2(d0), d1] if minus else [d0, n2(d1)])
        L += [a0, a1, c0, c1]
        R += [b1, b0] + ([n2(d1), n2(d0)] if minus else [d1, d0])
    w = wn(lm.wide_mul(torch.stack(L, -3), torch.stack(R, -3)), 2)
    outs = []
    for i in range(3):
        o = i * 8
        re = lm.mont_reduce(w[..., o + 0, :, :] + w[..., o + 1, :, :] +
                            w[..., o + 2, :, :] + w[..., o + 3, :, :], FQ)
        im = lm.mont_reduce(w[..., o + 4, :, :] + w[..., o + 5, :, :] +
                            w[..., o + 6, :, :] + w[..., o + 7, :, :], FQ)
        outs.append(torch.cat([re, im], -2))
    return tuple(outs)


def _padd(x1, y1, z1, x2, y2, z2, k, b3):
    """RCB15 Algorithm 7 (a = 0) in three batched product rounds; k = 1
    for Fq coordinates, 2 for Fq2.  Every sum or difference is
    weak-normalized before it enters a product or a spread subtraction."""
    wn = lm.weak_norm
    mul_stack = _mul_stack_fq if k == 1 else _mul_stack_fq2
    fsub_n = _fq_sub_n if k == 1 else _fq2_sub_n
    # round 1: 6 independent products
    lhs = [x1, y1, z1, wn(x1 + y1), wn(y1 + z1), wn(x1 + z1)]
    rhs = [x2, y2, z2, wn(x2 + y2), wn(y2 + z2), wn(x2 + z2)]
    t0, t1, t2, pa, pb, pc = mul_stack(lhs, rhs)
    t3 = fsub_n(pa, wn(t0 + t1))                    # X1Y2 + X2Y1
    t4 = fsub_n(pb, wn(t1 + t2))                    # Y1Z2 + Y2Z1
    y3 = fsub_n(pc, wn(t0 + t2))                    # X1Z2 + X2Z1
    x3 = wn(t0 + t0 + t0)                           # 3*X1X2
    # round 2: the two b3 scalings
    b3b = b3.expand(t2.shape)
    t2b, y3b = mul_stack([t2, y3], [b3b, b3b])
    z3 = wn(t1 + t2b)
    t1 = fsub_n(t1, t2b)
    # round 3: 6 products, lazily reduced
    rnd3 = _round3_fq if k == 1 else _round3_fq2
    return rnd3(t3, t4, y3b, t1, z3, x3)


def _padd_aa(x1, y1, x2, y2, k, b3):
    """RCB15 Algorithm 7 (a = 0) for Z1 = Z2 = 1 (two AFFINE inputs): 10
    products instead of 12.  Identity inputs are not covered (the caller
    selects on the mask rows); doubling and P + (-P) are exact."""
    wn = lm.weak_norm
    mul_stack = _mul_stack_fq if k == 1 else _mul_stack_fq2
    fsub_n = _fq_sub_n if k == 1 else _fq2_sub_n
    t0, t1, pa = mul_stack([x1, y1, wn(x1 + y1)], [x2, y2, wn(x2 + y2)])
    t3 = fsub_n(pa, wn(t0 + t1))                    # X1Y2 + X2Y1
    t4 = wn(y1 + y2)                                # Y1Z2 + Y2Z1
    y3 = wn(x1 + x2)                                # X1Z2 + X2Z1
    x3 = wn(t0 + t0 + t0)
    b3b = b3.expand(t1.shape)
    (y3b,) = mul_stack([y3], [b3b])
    z3 = wn(t1 + b3b)                               # Z1Z2 = 1: t2b = b3
    t1 = fsub_n(t1, b3b)
    rnd3 = _round3_fq if k == 1 else _round3_fq2
    return rnd3(t3, t4, y3b, t1, z3, x3)


def _one_k(like: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k*21, T) Montgomery one of Fq (k = 1) or Fq2 (k = 2)."""
    one = _c(FQ.one_mont, like).expand(*like.shape[:-2], NL, like.shape[-1])
    return one if k == 1 else torch.cat([one, torch.zeros_like(one)], -2)


def padd_aa(p, q, kind):
    """p, q: (..., arows, T) AFFINE planes (ec_affine layout: exact
    canonical coords + inf mask row) -> (..., rows, T) PROJECTIVE plane.
    Complete: identity lanes are resolved by mask selection."""
    k = 1 if kind == "g1" else 2
    b3 = _c(b3_g1() if k == 1 else b3_g2(), p)
    x1, y1, i1 = p[..., :k * NL, :], p[..., k * NL:2 * k * NL, :], \
        p[..., 2 * k * NL:, :]
    x2, y2, i2 = q[..., :k * NL, :], q[..., k * NL:2 * k * NL, :], \
        q[..., 2 * k * NL:, :]
    x3, y3, z3 = _padd_aa(x1, y1, x2, y2, k, b3)
    onek = _one_k(y1, k)
    inf1, inf2 = (i1 == 1), (i2 == 1)
    both = inf1 & inf2
    zero = torch.zeros((), dtype=lm.DTYPE, device=p.device)
    xo = torch.where(both, zero,
                     torch.where(inf1, x2, torch.where(inf2, x1, x3)))
    yo = torch.where(both, onek,
                     torch.where(inf1, y2, torch.where(inf2, y1, y3)))
    zo = torch.where(both, zero, torch.where(inf1 | inf2, onek, z3))
    return torch.cat([xo, yo, zo], -2)


def padd_g1(p, q):
    """p, q: (..., 63, T) -> (..., 63, T); complete (identity and
    doubling).  Outputs normalized (limbs <= 2^13 + eps)."""
    x3, y3, z3 = _padd(p[..., :NL, :], p[..., NL:2 * NL, :],
                       p[..., 2 * NL:, :], q[..., :NL, :],
                       q[..., NL:2 * NL, :], q[..., 2 * NL:, :],
                       1, _c(b3_g1(), p))
    return torch.cat([x3, y3, z3], -2)


def padd_g2(p, q):
    """p, q: (..., 126, T) -> (..., 126, T)."""
    x3, y3, z3 = _padd(p[..., :2 * NL, :], p[..., 2 * NL:4 * NL, :],
                       p[..., 4 * NL:, :], q[..., :2 * NL, :],
                       q[..., 2 * NL:4 * NL, :], q[..., 4 * NL:, :],
                       2, _c(b3_g2(), p))
    return torch.cat([x3, y3, z3], -2)


# ---------------------------------------------------------------------------
# identities
# ---------------------------------------------------------------------------

def g1_identity_plane(batch, T) -> np.ndarray:
    out = np.zeros((*batch, G1_ROWS, T), np.int32)
    out[..., NL:2 * NL, :] = FQ.one_mont
    return out


def g2_identity_plane(batch, T) -> np.ndarray:
    out = np.zeros((*batch, G2_ROWS, T), np.int32)
    out[..., 2 * NL:3 * NL, :] = FQ.one_mont
    return out


def identity_plane(kind: str, batch, T, device) -> torch.Tensor:
    """(*batch, rows, T) identity points (0 : 1 : 0) on `device`."""
    ident = _identity_col(kind, str(device))
    return ident.expand(*batch, ident.shape[0], T)


@functools.lru_cache(maxsize=None)
def _identity_col(kind: str, device: str) -> torch.Tensor:
    col = g1_identity_plane((), 1) if kind == "g1" else \
        g2_identity_plane((), 1)
    return torch.as_tensor(col, device=device)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def g1_table(points: list) -> np.ndarray:
    """Affine host points [(x, y) | None] -> (N, 63) int32 rows in
    Montgomery projective form."""
    out = np.zeros((len(points), G1_ROWS), np.int32)
    for j, pt in enumerate(points):
        if pt is None:
            out[j, NL:2 * NL] = FQ.one_mont[:, 0]
        else:
            out[j, :NL] = lm.int_to_limbs(pt[0] * _R % _Q)
            out[j, NL:2 * NL] = lm.int_to_limbs(pt[1] * _R % _Q)
            out[j, 2 * NL:] = lm.int_to_limbs(_R % _Q)
    return out


def g2_table(points: list) -> np.ndarray:
    out = np.zeros((len(points), G2_ROWS), np.int32)
    one = lm.int_to_limbs(_R % _Q)
    for j, pt in enumerate(points):
        if pt is None:
            out[j, 2 * NL:3 * NL] = one
        else:
            (x0, x1), (y0, y1) = pt[0], pt[1]
            out[j, 0 * NL:1 * NL] = lm.int_to_limbs(x0 * _R % _Q)
            out[j, 1 * NL:2 * NL] = lm.int_to_limbs(x1 * _R % _Q)
            out[j, 2 * NL:3 * NL] = lm.int_to_limbs(y0 * _R % _Q)
            out[j, 3 * NL:4 * NL] = lm.int_to_limbs(y1 * _R % _Q)
            out[j, 4 * NL:5 * NL] = one
    return out


def _coords_to_ints(plane, n_coords: int) -> list:
    return [lm.lm_to_ints(lm.from_mont(plane[..., i * NL:(i + 1) * NL, :],
                                       FQ)) for i in range(n_coords)]


def g1_plane_to_affine(plane) -> list:
    """(..., 63, T) plane -> list of affine (x, y) | None."""
    x, y, z = _coords_to_ints(plane, 3)
    out = []
    for xi, yi, zi in zip(x, y, z):
        if zi == 0:
            out.append(None)
        else:
            zinv = ff.inv_mod(zi, _Q)
            out.append((xi * zinv % _Q, yi * zinv % _Q))
    return out


def g2_plane_to_affine(plane) -> list:
    c = _coords_to_ints(plane, 6)
    out = []
    for k in range(len(c[0])):
        zt = (c[4][k], c[5][k])
        if zt == (0, 0):
            out.append(None)
            continue
        zinv = ec.fq2_inv(zt)
        out.append((ec.fq2_mul((c[0][k], c[1][k]), zinv),
                    ec.fq2_mul((c[2][k], c[3][k]), zinv)))
    return out

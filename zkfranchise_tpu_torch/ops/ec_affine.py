"""Affine point planes for the MSM sum-tree upsweep (main-path parts).

Every affine coordinate here is the EXACT canonical Montgomery
representative (value < p, exact 13-bit limbs), and the point at infinity
is an explicit 0/1 mask row carried with the plane:

    G1 affine: rows [0:21) x | [21:42) y | row 42 inf mask   (43 rows)
    G2 affine: [0:42) x (re,im) | [42:84) y | row 84 inf     (85 rows)

The batch-affine fold (the JAX package's ``fold_affine``, built on the
``fold_mul``/``inv``/``batch_inv`` kernels) is not on the prover's path
and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ff, lm

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

def g1_affine_table(points: list) -> np.ndarray:
    """Affine host points [(x, y) | None] -> (N, 43) int32 rows."""
    out = np.zeros((len(points), G1_AROWS), np.int32)
    for j, pt in enumerate(points):
        if pt is None:
            out[j, 2 * NL] = 1
        else:
            out[j, :NL] = lm.int_to_limbs(pt[0] * _R % _Q)
            out[j, NL:2 * NL] = lm.int_to_limbs(pt[1] * _R % _Q)
    return out


def g2_affine_table(points: list) -> np.ndarray:
    out = np.zeros((len(points), G2_AROWS), np.int32)
    for j, pt in enumerate(points):
        if pt is None:
            out[j, 4 * NL] = 1
        else:
            (x0, x1), (y0, y1) = pt
            for k, v in enumerate((x0, x1, y0, y1)):
                out[j, k * NL:(k + 1) * NL] = lm.int_to_limbs(v * _R % _Q)
    return out


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

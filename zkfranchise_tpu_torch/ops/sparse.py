"""Batched sparse matrix-vector products over Fr for R1CS evaluation.

The witness is ``(m, 21, T)`` (wires on the leading axis, the voter batch
T last).  az/bz/cz for the whole batch are one row gather over the column
indices, one Montgomery product per nonzero (kernel mont_mul, the
``(nnz, 21, 1)`` coefficients read with lane stride 0), and a
leading-axis segment sum by ``index_add_`` — exact in int32 (row fan-in
< 2^9, normalized limbs < 2^13+2, so per-limb sums stay < 2^22; integer
atomics give the same sum in any order).  Two weak-normalize rounds land
the rows back at mul-safe limbs.

Coefficients arrive in R-form (c*R mod p) from
models.r1cs.ConstraintSystem.export_arrays, so mont_mul(cR, wR) = c*w*R
lands c*w directly in Montgomery form.
"""
from __future__ import annotations

import torch

from . import lm
from .lm import FR

MAX_NNZ_CHUNK = 1 << 17


def spmv(rows: torch.Tensor, cols: torch.Tensor, coeffs_mont: torch.Tensor,
         n_rows: int, w_mont: torch.Tensor,
         mul=lm.mont_mul) -> torch.Tensor:
    """rows/cols: (nnz,) int64; coeffs_mont: (nnz, 21, 1) int32 R-form
    coefficients; w_mont: (m, 21, T) Montgomery witness, all on one
    device.  Returns (n_rows, 21, T) Montgomery row values.

    More than 2*MAX_NNZ_CHUNK nonzeros stream in MAX_NNZ_CHUNK-entry
    chunks, bounding the (nnz, 21, T) gather.  Chunk padding uses zero
    coefficients (they add nothing to row 0); the accumulator is
    re-weak-normalized per chunk.  mul: the Montgomery product
    (lm.mont_mul_ref gives the plain version on either device)."""
    nnz = int(rows.shape[0])
    T = w_mont.shape[-1]
    if nnz <= 2 * MAX_NNZ_CHUNK:
        prods = mul(coeffs_mont, w_mont[cols], FR)
        seg = w_mont.new_zeros((n_rows, lm.N_LIMBS, T)).index_add_(
            0, rows, prods)
        return lm.weak_norm(seg, 2)

    c = MAX_NNZ_CHUNK
    k = (nnz + c - 1) // c
    pad = k * c - nnz
    R = torch.cat([rows, rows.new_zeros(pad)]).reshape(k, c)
    C = torch.cat([cols, cols.new_zeros(pad)]).reshape(k, c)
    F = torch.cat([coeffs_mont, coeffs_mont.new_zeros(
        (pad, lm.N_LIMBS, 1))]).reshape(k, c, lm.N_LIMBS, 1)
    acc = w_mont.new_zeros((n_rows, lm.N_LIMBS, T))
    for i in range(k):
        prods = mul(F[i], w_mont[C[i]], FR)
        seg = torch.zeros_like(acc).index_add_(0, R[i], prods)
        acc = lm.weak_norm(acc + seg, 2)
    return acc

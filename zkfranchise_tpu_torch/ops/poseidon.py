"""Vectorized Poseidon permutation over BN254 Fr (limb-major core).

A field element is an int32 plane ``(..., 21, T)``; a hash call takes
``(..., k, 21, T)`` (k inputs stacked on a leading axis) and returns
``(..., 21, T)``.  On the card a whole permutation is one launch of the
CUDA kernel (ops/cuda/lm_kernels.py permutation); on the CPU its plain
version runs, round by round, on the helpers below.

Constants come from poseidon_constants.py (Grain-LFSR regenerated,
matching circomlib).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ff, lm
from .lm import FR
from .poseidon_constants import N_ROUNDS_F, N_ROUNDS_P, constants


@functools.lru_cache(maxsize=None)
def _tables(t: int):
    """Round-constant and MDS tables in Montgomery limb-major form:
    c_mont (rounds, t, 21, 1), m_mont (t, t, 21, 1)."""
    c, m = constants(t)
    r = FR.r_mod_p
    p = ff.P_FR
    n_rounds = N_ROUNDS_F + N_ROUNDS_P[t - 2]
    c_mont = np.stack(
        [lm.ints_to_lm([c[ri * t + i] * r % p for i in range(t)]).T
         for ri in range(n_rounds)], axis=0)[..., None]
    m_mont = np.stack(
        [lm.ints_to_lm([m[i][j] * r % p for j in range(t)]).T
         for i in range(t)], axis=0)[..., None]
    return c_mont.astype(np.int32), m_mont.astype(np.int32)


def tables(t: int, device):
    """(c_mont, m_mont) of width t as tensors on `device`."""
    c_mont, m_mont = _tables(t)
    return lm.const(c_mont, device), lm.const(m_mont, device)


def sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = lm.mont_mul(x, x, FR)
    x4 = lm.mont_mul(x2, x2, FR)
    return lm.mont_mul(x4, x, FR)


def mix(state: torch.Tensor, m_mont: torch.Tensor) -> torch.Tensor:
    """state: (..., t, 21, T); m_mont: (t, t, 21, 1).
    new[i] = sum_j M[i][j] * s[j]; the lazy sum reaches t*(2^13+eps) per
    limb, and one weak round re-normalizes."""
    prods = lm.mont_mul(m_mont, state.unsqueeze(-4), FR)
    return lm.weak_norm(prods.sum(dim=-3, dtype=lm.DTYPE))


def permutation(state: torch.Tensor, t: int) -> torch.Tensor:
    """Full Poseidon permutation on state (..., t, 21, T), Montgomery: the
    plain version on the CPU, one launch of the CUDA kernel on the card
    (ops/cuda/lm_kernels.permutation)."""
    from .cuda import lm_kernels
    return lm_kernels.permutation(state, t)


def poseidon_mont(inputs: torch.Tensor) -> torch.Tensor:
    """Poseidon hash of k field elements: inputs (..., k, 21, T) Montgomery
    form -> (..., 21, T) Montgomery form."""
    zero = torch.zeros_like(inputs[..., :1, :, :])
    state = torch.cat([zero, inputs], -3)
    return permutation(state, inputs.shape[-3] + 1)[..., 0, :, :]

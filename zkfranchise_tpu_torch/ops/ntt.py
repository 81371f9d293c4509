"""NTT over BN254 Fr on the limb-major core (element-major layout).

Arrays are ``(n, 21, T)``: the transform length n on the leading axis
(cheap row gathers), limbs next, and T independent transforms (the voter
batch) last.

Radix-2 Cooley-Tukey, decimation in time.  All data movement is static:
one row gather per stage whose indices are precomputed on the host with
the previous stage's inverse permutation composed in (so the initial
bit reversal is free).  The butterfly is one mont_mul over n/2 rows (the
(n/2, 21, 1) twiddles), a lazy add and a spread-constant subtract: one
level is ``ntt_level``, which runs the plain version ``ntt_level_ref`` on
a CPU tensor and one kernel launch on a CUDA tensor
(ops/cuda/lm_kernels.ntt_level).  Host oracle: groth16/poly.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..groth16 import poly
from . import ff, lm
from .lm import FR

P = ff.P_FR


def _bitrev(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    br = np.zeros(n, dtype=np.int64)
    for i in range(n):
        br[i] = int(bin(i)[2:].zfill(log_n)[::-1] or "0", 2)
    return br


def _col(x: int) -> np.ndarray:
    return lm.int_to_limbs(x)[:, None].astype(np.int32)


class NTTPlan:
    """Precomputed gathers + twiddle tables for a 2^log_n transform.

    For each stage s the DIT schedule pairs work indices
    (b*size + j, b*size + half + j); `gather[s]` maps those (lo then hi,
    concatenated) to physical row positions of the PREVIOUS stage's
    output, so each stage is exactly one gather.  `final` restores
    natural order after the last stage."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        n = 1 << log_n
        self.n = n
        r = FR.r_mod_p
        w = poly.root_of_unity(log_n)
        winv = ff.inv_mod(w, P)

        def schedule(root):
            gathers, tws = [], []
            pos = _bitrev(n)          # pos[w] = physical slot of work idx w
            for s in range(log_n):
                size = 2 << s
                half = size // 2
                blocks = n // size
                j = np.tile(np.arange(half, dtype=np.int64), blocks)
                base = np.repeat(np.arange(blocks, dtype=np.int64) * size,
                                 half)
                lo_w = base + j
                hi_w = lo_w + half
                gathers.append(np.concatenate([pos[lo_w], pos[hi_w]]))
                step = pow(root, n // size, P)
                tw = np.asarray(lm.ints_to_lm(
                    [pow(step, int(k), P) * r % P for k in range(half)]),
                    np.int32).T[:, :, None]              # (half, 21, 1)
                tws.append(np.tile(tw, (blocks, 1, 1)))
                new_pos = np.empty(n, dtype=np.int64)
                new_pos[lo_w] = np.arange(half * blocks)
                new_pos[hi_w] = half * blocks + np.arange(half * blocks)
                pos = new_pos
            return gathers, tws, pos

        self.fwd_g, self.fwd_tw, self.fwd_final = schedule(w)
        self.inv_g, self.inv_tw, self.inv_final = schedule(winv)
        self.n_inv_mont = _col(ff.inv_mod(n, P) * r % P)
        s = poly.COSET_SHIFT
        self.shift_pows = np.asarray(lm.ints_to_lm(
            [pow(s, i, P) * r % P for i in range(n)]),
            np.int32).T[:, :, None]                      # (n, 21, 1)

    @functools.lru_cache(maxsize=None)
    def on(self, device: str) -> dict:
        """The plan's tables as tensors on `device`."""
        t = functools.partial(torch.as_tensor, device=device)
        return {
            "fwd": ([t(g) for g in self.fwd_g], [t(w) for w in self.fwd_tw],
                    t(self.fwd_final)),
            "inv": ([t(g) for g in self.inv_g], [t(w) for w in self.inv_tw],
                    t(self.inv_final)),
            "n_inv_mont": t(self.n_inv_mont),
            "shift_pows": t(self.shift_pows),
        }


@functools.lru_cache(maxsize=None)
def plan(log_n: int) -> NTTPlan:
    return NTTPlan(log_n)


def ntt_level_ref(x: torch.Tensor, g: torch.Tensor, tw: torch.Tensor,
                  mul=lm.mont_mul) -> torch.Tensor:
    """Plain version of one butterfly level: x (n, 21, T), the level's
    gather g (n,) and twiddles tw (n/2, 21, 1) -> weak_norm(lo + hi) over
    sub_n(lo, hi), lo = x[g[:n/2]], hi = x[g[n/2:]] * tw.  The product is
    `mul`: lm.mont_mul (the plain version on the CPU, the general kernel
    on the card, as each level ran before it had its own kernel), or
    lm.mont_mul_ref for plain PyTorch on either device."""
    h = x.shape[0] // 2
    paired = x[g]
    lo = paired[:h]
    hi = mul(paired[h:], tw, FR)
    return torch.cat([lm.weak_norm(lo + hi), lm.sub_n(lo, hi, FR)], 0)


def ntt_level(x: torch.Tensor, g: torch.Tensor,
              tw: torch.Tensor) -> torch.Tensor:
    """One butterfly level: the plain version on the CPU, one kernel
    launch on the card (ops/cuda/lm_kernels.ntt_level)."""
    from .cuda import lm_kernels
    return lm_kernels.ntt_level(x, g, tw)


def _transform(x: torch.Tensor, gathers, tws, final) -> torch.Tensor:
    """x: (n, 21, T) Montgomery form, natural order in and out."""
    for g, tw in zip(gathers, tws):
        x = ntt_level(x, g, tw)
    return x[final]


def _tables(x: torch.Tensor) -> dict:
    n = x.shape[0]
    pl = plan(n.bit_length() - 1)
    assert pl.n == n
    return pl.on(str(x.device))


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward/inverse NTT on (n, 21, T) Montgomery-form tensors."""
    tabs = _tables(x)
    if not inverse:
        return _transform(x, *tabs["fwd"])
    y = _transform(x, *tabs["inv"])
    return lm.mont_mul(y, tabs["n_inv_mont"], FR)


def coset_evals_from_domain_evals(x: torch.Tensor) -> torch.Tensor:
    """Domain evals of a deg<n polynomial -> evals on the coset s*w^j."""
    coefs = ntt(x, inverse=True)
    return ntt(lm.mont_mul(coefs, _tables(x)["shift_pows"], FR))

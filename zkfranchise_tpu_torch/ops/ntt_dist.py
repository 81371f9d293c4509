"""Domain-sharded (distributed) NTT: the four-step decomposition over one
mesh axis with all_to_all stage exchanges.

The transform domain (the leading row axis of ``(n, 21, T)`` planes) is
split across the nm members of an axis.  Each member does n/nm of the
butterfly work; the cross-member stages are one dense nm-point transform
and two all_to_all transposes per transform (the four-step / Bailey
algorithm):

  inverse, contiguous-in -> strided-out  (w = omega^{-1}, n = nm*b):
    X[k2*nm + k1] = sum_{j2} w^{j2 k1} Y[k1][j2] * wb^{j2 k2},
    Y[k1][j2]     = (1/nm) sum_{j1} wm^{j1 k1} x[j1*b + j2]
  forward, strided-in -> contiguous-out (w = omega):
    X[k1*b + k2]  = sum_{j1} wm^{j1 k1} (w^{j1 k2} Z[j1][k2]),
    Z[j1][k2]     = NTT_b over j2 of z[j2*nm + j1]

  (wm = w^b has order nm; wb = w^nm has order b; "strided" layout: member
  c holds rows {k : k = q*nm + c}, ordered by q.)

The functions take an AXIS object (parallel/mesh.py ``Axis``): its
``size``, this rank's ``index`` in it, and ``all_to_all``, which splits
the leading dimension into ``size`` chunks, sends chunk i to member i and
concatenates what it receives in member order (``jax.lax.all_to_all``
with split_axis = concat_axis = 0).  Products go through
``lm_kernels.mont_mul`` and butterfly levels through ``ntt.ntt_level``,
so on the card they launch ``zk_mont_mul`` and ``zk_ntt_level``.

The tables equal the JAX package's ``DistNTTPlan``; a rank keeps only its
own slice of them on its device (``DistNTTPlan.on``).  Oracle: ops/ntt.py
on the gathered plane.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..groth16 import poly
from . import ff, lm, ntt
from .cuda import lm_kernels as K
from .lm import FR

P = ff.P_FR


def _mont_cols(vals) -> np.ndarray:
    """list of ints -> (len, 21, 1) int32 Montgomery-form limb planes."""
    r = FR.r_mod_p
    return np.asarray(lm.ints_to_lm([v * r % P for v in vals]),
                      np.int32).T[:, :, None]


class DistNTTPlan:
    """Host tables for an n = nm * b transform sharded nm ways.

    The tables hold every member's slice on a leading nm axis, as the JAX
    package's plan does; ``on(device, index)`` puts one member's slices on
    its device, once."""

    def __init__(self, log_n: int, nm: int):
        n = 1 << log_n
        if n % nm or nm & (nm - 1):
            raise ValueError(f"DistNTTPlan: nm = {nm} must be a power of two "
                             f"dividing n = {n}")
        b = n // nm
        if b % nm:
            raise ValueError(f"DistNTTPlan: four-step needs nm^2 <= n "
                             f"(nm = {nm}, n = {n})")
        self.n, self.nm, self.b = n, nm, b
        self.log_b = b.bit_length() - 1
        w = poly.root_of_unity(log_n)
        wi = ff.inv_mod(w, P)
        nm_inv = ff.inv_mod(nm, P)

        # inner dense transforms: wm^{j1*k1} (order-nm root)
        wm_f = pow(w, b, P)
        wm_i = pow(wi, b, P)
        self.m_fwd = _mont_cols(
            [pow(wm_f, j1 * k1, P) for k1 in range(nm) for j1 in range(nm)]
        ).reshape(nm, nm, lm.N_LIMBS, 1)
        # inverse combine folds the 1/nm scale in
        self.m_inv = _mont_cols(
            [pow(wm_i, j1 * k1, P) * nm_inv % P
             for k1 in range(nm) for j1 in range(nm)]
        ).reshape(nm, nm, lm.N_LIMBS, 1)

        # inverse step twiddle, member j2a: [k1, j2b] -> wi^{j2*k1},
        # j2 = j2a*(b/nm) + j2b
        c = b // nm
        self.tw_inv = _mont_cols(
            [pow(wi, (j2a * c + j2b) * k1, P)
             for j2a in range(nm) for k1 in range(nm) for j2b in range(c)]
        ).reshape(nm, nm, c, lm.N_LIMBS, 1)

        # forward step twiddle, member j1: [k2] -> w^{j1*k2}
        self.tw_fwd = _mont_cols(
            [pow(w, j1 * k2, P) for j1 in range(nm) for k2 in range(b)]
        ).reshape(nm, b, lm.N_LIMBS, 1)

        # coset shift tables in STRIDED layout, member c0: [q] -> s^{q*nm+c0}
        s = poly.COSET_SHIFT
        sinv = ff.inv_mod(s, P)
        self.shift_strided = _mont_cols(
            [pow(s, q * nm + c0, P)
             for c0 in range(nm) for q in range(b)]
        ).reshape(nm, b, lm.N_LIMBS, 1)
        self.shift_inv_strided = _mont_cols(
            [pow(sinv, q * nm + c0, P)
             for c0 in range(nm) for q in range(b)]
        ).reshape(nm, b, lm.N_LIMBS, 1)

        self.local_plan = ntt.plan(self.log_b)

    @functools.lru_cache(maxsize=None)
    def on(self, device: str, index: int) -> dict:
        """Member `index`'s tables as tensors on `device`, and the local
        length-b transform's: built on the first call, then cached."""
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return {"m_fwd": t(self.m_fwd), "m_inv": t(self.m_inv),
                "tw_inv": t(self.tw_inv[index]),
                "tw_fwd": t(self.tw_fwd[index]),
                "shift": t(self.shift_strided[index]),
                "local": self.local_plan.on(device)}


@functools.lru_cache(maxsize=None)
def plan(log_n: int, nm: int) -> DistNTTPlan:
    return DistNTTPlan(log_n, nm)


def _tables(x: torch.Tensor, axis, p: DistNTTPlan) -> dict:
    if axis.size != p.nm or x.shape[0] != p.b:
        raise ValueError(f"ntt_dist: a plan for nm = {p.nm}, b = {p.b} "
                         f"given axis size {axis.size}, {x.shape[0]} rows")
    return p.on(str(x.device), axis.index)


def _combine(m_tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense nm-point transform over the leading axis.
    m_tab: (nm, nm, 21, 1); x: (nm, rows, 21, T) -> (nm, rows, 21, T)."""
    nm = x.shape[0]
    outs = []
    for k1 in range(nm):
        acc = None
        for j1 in range(nm):
            term = K.mont_mul(m_tab[k1, j1], x[j1], FR)
            acc = term if acc is None else acc + term
        outs.append(lm.weak_norm(acc, 2))
    return torch.stack(outs, 0)


def intt_dist(x_local: torch.Tensor, axis, p: DistNTTPlan) -> torch.Tensor:
    """Inverse NTT, contiguous-sharded input -> strided-sharded output.
    x_local: (b, 21, T) Montgomery (member c holds rows [c*b, (c+1)*b));
    returns (b, 21, T): member c holds coefficients {q*nm + c}."""
    tabs = _tables(x_local, axis, p)
    nm, b = p.nm, p.b
    T = x_local.shape[-1]
    # split j2 -> (j2a, j2b); transpose: member j2a gets all j1
    xs = x_local.reshape(nm, b // nm, lm.N_LIMBS, T)
    xt = axis.all_to_all(xs)
    y = _combine(tabs["m_inv"], xt)                  # [k1, j2b]
    y = K.mont_mul(y, tabs["tw_inv"], FR)            # (nm, c, 21, 1)
    # transpose back: member k1 gets all (j2a, j2b) = all j2
    z = axis.all_to_all(y).reshape(b, lm.N_LIMBS, T)
    # local length-b inverse transform (and its own 1/b scale)
    lp = tabs["local"]
    out = ntt._transform(z, *lp["inv"])
    return K.mont_mul(out, lp["n_inv_mont"], FR)


def ntt_dist(z_local: torch.Tensor, axis, p: DistNTTPlan) -> torch.Tensor:
    """Forward NTT, strided-sharded input -> contiguous-sharded output.
    z_local: (b, 21, T): member c holds rows {q*nm + c} (q-ordered);
    returns (b, 21, T): member c holds evals [c*b, (c+1)*b)."""
    tabs = _tables(z_local, axis, p)
    nm, b = p.nm, p.b
    T = z_local.shape[-1]
    zt = ntt._transform(z_local, *tabs["local"]["fwd"])
    zt = K.mont_mul(zt, tabs["tw_fwd"], FR)          # (b, 21, 1)
    # split k2 -> (k2a, k2b); transpose: member k2a gets all j1
    xt = axis.all_to_all(zt.reshape(nm, b // nm, lm.N_LIMBS, T))
    y = _combine(tabs["m_fwd"], xt)                  # [k1, k2b]
    # transpose: member k1 gets all (k2a, k2b) = all k2
    return axis.all_to_all(y).reshape(b, lm.N_LIMBS, T)


def coset_evals_dist(x_local: torch.Tensor, axis,
                     p: DistNTTPlan) -> torch.Tensor:
    """Sharded ntt.coset_evals_from_domain_evals: contiguous-sharded
    domain evals -> contiguous-sharded coset evals.  Two distributed
    transforms and one strided shift product."""
    coefs = intt_dist(x_local, axis, p)              # strided coefficients
    sh = _tables(x_local, axis, p)["shift"]          # (b, 21, 1)
    return ntt_dist(K.mont_mul(coefs, sh, FR), axis, p)


def unstride(gathered: torch.Tensor, nm: int) -> torch.Tensor:
    """(nm, b, ...) gather of a STRIDED sharding -> (n, ...) natural order
    (row q*nm + c comes from shard c position q)."""
    return gathered.transpose(0, 1).reshape(
        gathered.shape[0] * gathered.shape[1], *gathered.shape[2:])

"""Batches of EC scalings, adds and sums on lane planes: the trusted setup's
card route (groth16/ceremony.py, groth16/contribute.py).

These are the plane counterparts of the native batch functions the JAX
package's ceremony calls (utils/native.py: g1/g2_scale_batch,
g1/g2_add_batch, g1/g2_segsum).  A point set is a projective plane of
shape (rows, N) (ops/ec_lm.py: 63 rows for G1, 126 for G2), one point a
lane.  All of it is plain PyTorch around two kernels:

  * ``K.scalar_mul`` (the double-and-add ladder, every bit in one launch)
    for every scaling, with a scalar per lane or one for all lanes;
  * ``K.padd`` (the complete RCB15 add, so doublings, P + (-P) and the
    identity are exact) for the EC-NTT butterflies and the segmented sums.

A CPU plane goes to the plain versions through the kernels' own dispatch
and a CUDA plane to the kernels; nothing here falls back from one to the
other.  Host points enter through ``to_plane`` (ec_lm.g1_table /
g2_table, once a table) and leave through ``to_affine``
(ec_lm.g*_plane_to_affine, whose from_mont is a mont_mul launch on the
card); the identity is None on the host and (0 : 1 : 0) on a plane.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ec_lm, ff, msm_lm
from .cuda import lm_kernels as K

P = ff.P_FR
SCALAR_BYTES = 32


# ---------------------------------------------------------------------------
# scalars and host conversions
# ---------------------------------------------------------------------------

def scalar_bits(scalars, nbits: int | None = None) -> np.ndarray:
    """Python ints in [0, 2^256) -> (nbits, T) int32 0/1, least significant
    bit first, one column a scalar: the 32-byte little-endian forms
    unpacked at once.  nbits defaults to the longest scalar's length (at
    least 1): the ladder's leading zero bits leave its sum unchanged."""
    T = len(scalars)
    raw = np.frombuffer(b"".join(int(s).to_bytes(SCALAR_BYTES, "little")
                                 for s in scalars),
                        np.uint8).reshape(T, SCALAR_BYTES)
    bits = np.unpackbits(raw, axis=1, bitorder="little")
    if nbits is None:
        cols = np.flatnonzero(bits.any(axis=0))
        nbits = int(cols[-1]) + 1 if cols.size else 1
    return np.ascontiguousarray(bits[:, :nbits].T, dtype=np.int32)


def shared_bits(scalar: int) -> np.ndarray:
    """One scalar for all lanes -> (nbits,) int32 0/1, LSB first."""
    return scalar_bits([scalar])[:, 0].copy()


def to_plane(points: list, kind: str, device) -> torch.Tensor:
    """Affine host points [(x, y) | None] -> (rows, N) projective plane."""
    tab = ec_lm.g1_table(points) if kind == "g1" else ec_lm.g2_table(points)
    return torch.as_tensor(np.ascontiguousarray(tab.T), device=device)


def to_affine(plane: torch.Tensor, kind: str) -> list:
    """(rows, N) plane -> affine host points, None for the identity."""
    return ec_lm.g1_plane_to_affine(plane) if kind == "g1" else \
        ec_lm.g2_plane_to_affine(plane)


def _identities(kind: str, T: int, device) -> torch.Tensor:
    """A writable (rows, T) plane of identities (0 : 1 : 0)."""
    return ec_lm.identity_plane(kind, (), T, device).clone()


neg_plane = msm_lm._neg_plane


# ---------------------------------------------------------------------------
# scalings
# ---------------------------------------------------------------------------

def scale_plane(plane: torch.Tensor, scalars, kind: str) -> torch.Tensor:
    """k_t * P_t for every lane t: `scalars` a list of Python ints, one a
    lane, or one int for all lanes (the shared form of K.scalar_mul)."""
    if isinstance(scalars, int):
        bits = shared_bits(scalars % P)
    else:
        if len(scalars) != plane.shape[-1]:
            raise ValueError(f"scale_plane: {len(scalars)} scalars for "
                             f"{plane.shape[-1]} lanes")
        bits = scalar_bits([s % P for s in scalars])
    bits_t = torch.as_tensor(bits, device=plane.device)
    return K.scalar_mul(plane.contiguous(), bits_t, kind)


# ---------------------------------------------------------------------------
# the EC-NTT
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bitrev_index(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(msm_lm._bitrev(n), device=device)


@functools.lru_cache(maxsize=4)
def _twiddle_bits(n: int, root: int, device: str) -> tuple:
    """Bit planes of every stage's twiddles, built once for each (n,
    root): stage s (butterfly size 2^s, half h) gives lane b*h + j the
    scalar step^j, step = root^(n / 2^s) -> ((nbits, n/2) int32, ...)."""
    out = []
    size = 2
    while size <= n:
        half = size // 2
        step = pow(root, n // size, P)
        tw = [1] * half
        for j in range(1, half):
            tw[j] = tw[j - 1] * step % P
        bits = torch.as_tensor(scalar_bits(tw), device=device)
        out.append(bits.repeat(1, n // size).contiguous())
        size *= 2
    return tuple(out)


def ec_ntt_plane(plane: torch.Tensor, root: int, kind: str) -> torch.Tensor:
    """out_r = sum_j root^(r j) P_j over the lanes of a (rows, n) plane, n a
    power of two: the radix-2 EC-NTT of the JAX package's
    ceremony._ec_ntt.  One bit-reversal gather, then per stage one
    per-lane scalar_mul of the high halves by their twiddles and two
    padds, lo + t and lo + (-t)."""
    rows, n = plane.shape
    if n & (n - 1):
        raise ValueError(f"ec_ntt_plane: {n} lanes is not a power of two")
    x = plane.index_select(1, _bitrev_index(n, str(plane.device)))
    for s, bits in enumerate(_twiddle_bits(n, root % P, str(plane.device))):
        half = 1 << s
        v = x.view(rows, n // (2 * half), 2, half)
        lo = v[:, :, 0, :].reshape(rows, n // 2)
        hi = v[:, :, 1, :].reshape(rows, n // 2)
        t = K.scalar_mul(hi, bits, kind)
        new_lo = K.padd(lo, t, kind)
        new_hi = K.padd(lo, neg_plane(t, kind), kind)
        x = torch.stack([new_lo.view(rows, -1, half),
                         new_hi.view(rows, -1, half)], 2).reshape(rows, n)
    return x


# ---------------------------------------------------------------------------
# segmented sums
# ---------------------------------------------------------------------------

def segsum_plan(ids) -> tuple:
    """The rounds of a segmented pairwise sum, worked out once on the host.

    Lanes are kept in groups by id; in each round every group of length
    L > 1 adds its lanes in pairs (0, 1), (2, 3), ... and carries an odd
    last lane, so it becomes ceil(L / 2) lanes: ceil(log2 longest)
    rounds, and len(ids) - (number of ids) adds in all (a segmented scan
    would add every lane in every round).

    -> (rounds, order, seg): each round (a, b, c) gives the next state as
    cat(padd(x[a], x[b]), x[c]) of the current one; `order` lists the
    final lanes by id and `seg` their ids (ascending, unique)."""
    ids = np.asarray(ids, dtype=np.int64)
    order = np.argsort(ids, kind="stable")       # lane indices, by id
    seg = ids[order]
    rounds = []
    while True:
        first = np.searchsorted(seg, seg, side="left")
        pos = np.arange(seg.size) - first
        pair_next = np.append(seg[1:] == seg[:-1], False)
        even = pos % 2 == 0
        a = np.flatnonzero(even & pair_next)
        if not a.size:
            return rounds, order, seg
        c = np.flatnonzero(even & ~pair_next)
        rounds.append((order[a], order[a + 1], order[c]))
        new_seg = np.concatenate([seg[a], seg[c]])
        order = np.argsort(new_seg, kind="stable")
        seg = new_seg[order]


def segsum_plane(points: torch.Tensor, ids, m: int, kind: str) -> torch.Tensor:
    """(rows, E) plane and E ids in [0, m) -> (rows, m): lane i of the
    result is the sum of the points whose id is i, the identity where no
    point has that id (native.g*_segsum on planes)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size != points.shape[-1]:
        raise ValueError(f"segsum_plane: {ids.size} ids for "
                         f"{points.shape[-1]} lanes")
    if ids.size and (ids.min() < 0 or ids.max() >= m):
        raise ValueError("segsum_plane: segment id out of range")
    dev = points.device
    out = _identities(kind, m, dev)
    if not ids.size:
        return out
    rounds, order, seg = segsum_plan(ids)
    x = points
    for a, b, c in rounds:
        ia, ib, ic = (torch.as_tensor(v, device=dev) for v in (a, b, c))
        x = torch.cat([K.padd(x.index_select(1, ia), x.index_select(1, ib),
                              kind),
                       x.index_select(1, ic)], 1)
    out[:, torch.as_tensor(seg, device=dev)] = x.index_select(
        1, torch.as_tensor(order, device=dev))
    return out


def wire_combo_plane(rows, wires, coeffs, basis: torch.Tensor, m: int,
                     kind: str) -> torch.Tensor:
    """sum over entries (r, w, c) of c * basis[r] into lane w of a (rows,
    m) plane: the basis lanes gathered on the device by row index, one
    per-lane scalar_mul, one segmented sum (the JAX package's
    ceremony._wire_combo)."""
    if not len(wires):
        return _identities(kind, m, basis.device)
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                          device=basis.device)
    pts = basis.index_select(1, idx)
    scaled = scale_plane(pts, list(coeffs), kind)
    del pts
    return segsum_plane(scaled, wires, m, kind)

"""Limb-major field core for BN254: 21 x 13-bit limbs, R = 2^273 (PyTorch).

Layout (the JAX package's, kept so every plane compares tensor by
tensor): a field element is an int32 tensor of shape ``(..., 21, T)``,
the LIMB axis second to last and the element/voter axis ``T`` last.

Why 13 x 21: products of two normalized limbs (<= 2^13 + 63) are < 2^26.2,
so a full 21-term schoolbook column sums raw products in int32 with no
splitting (21 * (2^13+63)^2 < 2^31); R = 2^273 leaves 2^19 of headroom over
p, so the one normalization rule is: weak-normalize any sum or difference
before it enters a multiply.

``mont_mul`` is the public product: a CPU tensor goes to the plain version
``mont_mul_ref``, a CUDA tensor to the hand-written kernel in
``ops/cuda/lm_kernels.py``.  Everything else here is plain PyTorch that
runs on either device.  Host oracle: ops/ff.py.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import ff

LIMB_BITS = 13
N_LIMBS = 21
MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * N_LIMBS          # 273
WIDE = 2 * N_LIMBS + 1                # 43
DTYPE = torch.int32


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (21,) int32 limbs (little-endian)."""
    assert 0 <= x < (1 << R_BITS)
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)],
                    dtype=np.int32)


def ints_to_limb_rows(xs) -> np.ndarray:
    """List of n ints in [0, 2^273) -> (n, 21) int32 limbs, one row an
    int: each int's little-endian bytes read as five 64-bit words, and
    each limb cut from the one or two words it spans (no Python loop over
    the ints' limbs)."""
    n = len(xs)
    if not n:
        return np.zeros((0, N_LIMBS), np.int32)
    words = np.frombuffer(b"".join(int(x).to_bytes(40, "little")
                                   for x in xs), "<u8").reshape(n, 5)
    assert not (words[:, 4] >> np.uint64(R_BITS - 256)).any(), \
        "value >= 2^273"
    out = np.empty((n, N_LIMBS), np.int32)
    for i in range(N_LIMBS):
        w, off = divmod(LIMB_BITS * i, 64)
        v = words[:, w] >> np.uint64(off)
        if off + LIMB_BITS > 64:
            v = v | (words[:, w + 1] << np.uint64(64 - off))
        out[:, i] = v & np.uint64(MASK)
    return out


def ints_to_lm(xs) -> np.ndarray:
    """List of n ints -> (21, n) limb-major plane."""
    return np.ascontiguousarray(ints_to_limb_rows(xs).T)


def lm_to_ints(a) -> list:
    """(..., 21, n) tensor or array -> flat list of ints (exact; limbs may
    exceed 13 bits or be negative): Horner over the limb axis on Python
    ints held in an object array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a, dtype=np.int64)
    flat = a.reshape(-1, *a.shape[-2:]).astype(object)
    acc = flat[:, -1, :]
    for i in range(flat.shape[1] - 2, -1, -1):
        acc = (acc << LIMB_BITS) + flat[:, i, :]
    return acc.reshape(-1).tolist()


# ---------------------------------------------------------------------------
# field spec
# ---------------------------------------------------------------------------

def _spread_sub_const(p: int, b_bits: int) -> np.ndarray:
    """Multiple of p whose limb i dominates any nonnegative-limb value
    < 2^b_bits with normalized limbs, so that D - b is nonnegative
    limbwise; limbs above the value boundary stay zero."""
    base = np.zeros(N_LIMBS, dtype=np.int64)
    for i in range(N_LIMBS):
        pos = b_bits - LIMB_BITS * i
        base[i] = 0 if pos <= 0 else min(MASK + 64, (1 << pos) - 1)
    val = sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(base))
    k = -val % p
    out = base + np.asarray([(k >> (LIMB_BITS * i)) & MASK
                             for i in range(N_LIMBS)], dtype=np.int64)
    assert sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(out)) % p == 0
    assert out.max() < (1 << 15)
    return out.astype(np.int32)


class FieldSpec(NamedTuple):
    p: int
    p_limbs: np.ndarray          # (21, 1) canonical
    nprime_limbs: np.ndarray     # (21, 1): -p^-1 mod 2^273
    sub_d: np.ndarray            # (21, 1) spread multiple of p (b < 2^257)
    sub_d1: np.ndarray           # (21, 1) tight spread multiple (b < 2^255)
    sub_d2: np.ndarray           # (21, 1) wide spread multiple (b < 2^259)
    r_mod_p: int
    r2_limbs: np.ndarray         # (21, 1): R^2 mod p
    one_mont: np.ndarray         # (21, 1): R mod p
    p_comp_limbs: np.ndarray     # (21, 1): 2^273 - p
    p_minus_2_bits: np.ndarray   # (bits of p,) int32 0/1, LSB first


@functools.lru_cache(maxsize=None)
def make_field(p: int) -> FieldSpec:
    r = 1 << R_BITS
    nprime = (-pow(p, -1, r)) % r

    def col(v):
        return int_to_limbs(v)[:, None]

    bits = np.array([((p - 2) >> i) & 1 for i in range(p.bit_length())],
                    dtype=np.int32)
    return FieldSpec(
        p=p,
        p_limbs=col(p),
        nprime_limbs=col(nprime),
        sub_d=_spread_sub_const(p, 257)[:, None],
        sub_d1=_spread_sub_const(p, 255)[:, None],
        sub_d2=_spread_sub_const(p, 259)[:, None],
        r_mod_p=r % p,
        r2_limbs=col(r * r % p),
        one_mont=col(r % p),
        p_comp_limbs=col(r - p),
        p_minus_2_bits=bits,
    )


FR = make_field(ff.P_FR)
FQ = make_field(ff.P_FQ)

N_CONST_ROWS = 6


def pack_consts(fs: FieldSpec) -> np.ndarray:
    """(6*21, 1) int32 constant block: p, n', sub_d, one_mont, sub_d1,
    sub_d2 — the rows a kernel reads for one field."""
    return np.concatenate(
        [fs.p_limbs, fs.nprime_limbs, fs.sub_d, fs.one_mont, fs.sub_d1,
         fs.sub_d2], axis=0).astype(np.int32)


_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """Device copy of a long-lived numpy constant (cached per device)."""
    key = (id(arr), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr),
                                    device=device))
        _CONSTS[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# carry handling (shifts run along the limb axis, -2)
# ---------------------------------------------------------------------------

def _down1(x: torch.Tensor) -> torch.Tensor:
    """Shift limbs one position toward the higher index: prepend a zero
    row and drop the top row."""
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], -2)


def weak_norm(t: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """Fold limb overflow one position up per round; drops the carry-out
    of the top row (callers arrange that it is zero / mod-R semantics)."""
    for _ in range(rounds):
        carry = t >> LIMB_BITS
        t = t & MASK
        t[..., 1:, :] += carry[..., :-1, :]
    return t


def norm_exact_carry(t: torch.Tensor):
    """Exact carry resolution (Kogge-Stone over the limb axis): limbs
    < 2^31 -> (limbs in [0, 2^13), carry beyond the top row)."""
    w = t.shape[-2]
    t = weak_norm(t, 2)
    g = t >> LIMB_BITS                  # 0/1 generate
    d = t & MASK
    pp = (d == MASK).to(DTYPE)          # propagate
    shift = 1
    while shift < w:
        zero = torch.zeros_like(g[..., :shift, :])
        gs = torch.cat([zero, g[..., :w - shift, :]], -2)
        ps = torch.cat([zero + 1, pp[..., :w - shift, :]], -2)
        g = g | (pp & gs)
        pp = pp & ps
        shift *= 2
    out = (d + _down1(g)) & MASK
    return out, g[..., w - 1:w, :]


def norm_exact(t: torch.Tensor) -> torch.Tensor:
    """Exact carry resolution; carry out of the top row must be zero."""
    return norm_exact_carry(t)[0]


# ---------------------------------------------------------------------------
# schoolbook products (raw int32 column sums, no splitting)
# ---------------------------------------------------------------------------

def _out_shape(a: torch.Tensor, b: torch.Tensor, rows: int):
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return (*shape, rows, max(a.shape[-1], b.shape[-1]))


def wide_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (..., 21, T) normalized limbs (broadcastable) -> (..., 43, T)
    column sums."""
    cols = torch.zeros(_out_shape(a, b, WIDE), dtype=DTYPE, device=a.device)
    for i in range(N_LIMBS):
        cols[..., i:i + N_LIMBS, :] += a[..., i:i + 1, :] * b
    return cols


def low_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 21 columns of a*b (for m = t * n' mod R): triangular work."""
    cols = torch.zeros(_out_shape(a, b, N_LIMBS), dtype=DTYPE,
                       device=a.device)
    for i in range(N_LIMBS):
        cols[..., i:, :] += a[..., i:i + 1, :] * b[..., :N_LIMBS - i, :]
    return cols


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------

def mont_reduce(cols: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    """cols: (..., 43, T) column sums of T0 < R*2^257 -> representative of
    T0 * R^-1 mod p, limbs <= 2^13 + 2 (normalized, not exact).

    Carry trick instead of a full resolve: t + m*p = 0 mod R and, after 3
    weak rounds, its low half has limbs <= 2^13 + 1, so value < 2R — the
    low half is exactly 0 or R, and the carry into the high half is just
    "any low limb nonzero"."""
    dev = cols.device
    t = weak_norm(cols, 2)
    m = weak_norm(low_mul(t[..., :N_LIMBS, :], const(fs.nprime_limbs, dev)),
                  2)
    s = weak_norm(t + wide_mul(m, const(fs.p_limbs, dev)), 3)
    carry = (s[..., :N_LIMBS, :] != 0).any(dim=-2, keepdim=True).to(DTYPE)
    out = s[..., N_LIMBS:2 * N_LIMBS, :].clone()
    out[..., :1, :] += carry
    return out


def mont_mul_ref(a: torch.Tensor, b: torch.Tensor,
                 fs: FieldSpec = FR) -> torch.Tensor:
    """Plain version of the Montgomery product a*b*R^-1 mod p.  Operands
    normalized (limbs <= 2^13+63), values < 2^260.  Output: exact 13-bit
    limbs, value < p * (1 + 2^-19)."""
    return mont_reduce(wide_mul(a, b), fs)


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             fs: FieldSpec = FR) -> torch.Tensor:
    """Montgomery product: plain version on the CPU, the CUDA kernel on
    the card (ops/cuda/lm_kernels.mont_mul)."""
    from .cuda import lm_kernels
    return lm_kernels.mont_mul(a, b, fs)


def mont_sqr(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    return mont_mul(a, a, fs)


def to_mont(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    return mont_mul(a, const(fs.r2_limbs, a.device), fs)


def sub_n(a: torch.Tensor, b: torch.Tensor,
          fs: FieldSpec = FR) -> torch.Tensor:
    """Normalized subtract: a - b + D, D a spread multiple of p dominating
    normalized b (value < 2^257).  a may be one lazy add deep."""
    return weak_norm(a + (const(fs.sub_d, a.device) - b))


def neg_n(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    return weak_norm(const(fs.sub_d, a.device) - a)


def cond_sub_p(r: torch.Tensor, fs: FieldSpec) -> torch.Tensor:
    """r exact limbs, value < 2p -> canonical [0, p).  Adds R - p; iff
    that overflows R (r >= p) the wrapped value r - p is kept."""
    wrapped, carry = norm_exact_carry(r + const(fs.p_comp_limbs, r.device))
    return torch.where(carry >= 1, wrapped, r)


_ONE_COL = int_to_limbs(1)[:, None]


def _one_col(device) -> torch.Tensor:
    return const(_ONE_COL, device)


def from_mont(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    """Montgomery (any normalized rep < 2^257) -> canonical plain [0, p)."""
    v = norm_exact(mont_mul(a, _one_col(a.device), fs))   # < 2p
    return cond_sub_p(v, fs)


def canon(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    return from_mont(to_mont(a, fs), fs)


# ---------------------------------------------------------------------------
# powers and inverses (plain PyTorch on either device: mont_mul_ref only)
# ---------------------------------------------------------------------------

def pow_bits(a: torch.Tensor, bits: np.ndarray,
             fs: FieldSpec = FR) -> torch.Tensor:
    """a^e for e given as a little-endian 0/1 array shared by all lanes:
    square-and-multiply, LSB first."""
    bits_t = torch.as_tensor(np.asarray(bits, dtype=np.int32),
                             device=a.device)
    acc = const(fs.one_mont, a.device).expand(a.shape)
    base = a
    for i in range(bits_t.shape[0]):
        mult = mont_mul_ref(acc, base, fs)
        acc = torch.where(bits_t[i] == 1, mult, acc)
        base = mont_mul_ref(base, base, fs)
    return acc


def inv(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    """Montgomery inverse via Fermat, a^(p-2) (inv(0) = 0)."""
    return pow_bits(a, fs.p_minus_2_bits, fs)


def batch_inv_lanes(a: torch.Tensor, fs: FieldSpec = FR) -> torch.Tensor:
    """Montgomery batch inversion across the LANE axis of (..., 21, X), X a
    power of two: one Fermat inversion in all and about 3 products per
    lane.  Zero lanes must have been mapped to one by the caller."""
    x = a
    levels = [x]
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = mont_mul_ref(x[..., :half], x[..., half:], fs)
        levels.append(x)
    invs = inv(x, fs)                           # (..., 21, 1)
    # walk down: the inverse of each half from the inverse of the product
    for cur in levels[-2::-1]:
        half = cur.shape[-1] // 2
        left = mont_mul_ref(invs, cur[..., half:], fs)
        right = mont_mul_ref(invs, cur[..., :half], fs)
        invs = torch.cat([left, right], -1)
    return invs


# ---------------------------------------------------------------------------
# bit / digit extraction (plain EXACT canonical limbs required)
# ---------------------------------------------------------------------------

def bits_from_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """x: (..., 21, T) plain exact limbs -> (n, ..., T) int32 0/1 bits,
    LSB first (the bit axis becomes the new leading axis).  One gather of
    each bit's limb, one shift and one mask."""
    i = torch.arange(n, device=x.device)
    limbs = x.index_select(-2, i // LIMB_BITS)              # (..., n, T)
    shift = (i % LIMB_BITS).to(x.dtype)[:, None]
    return ((limbs >> shift) & 1).movedim(-2, 0)


def window_digits(x: torch.Tensor, wbits: int = 8,
                  nwin: int = 32) -> torch.Tensor:
    """x: (N, 21, T) plain exact canonical limbs -> (nwin, N, T) int32
    wbits-bit little-endian windows (Pippenger digits)."""
    wins = []
    for w in range(nwin):
        off = w * wbits
        i, s = divmod(off, LIMB_BITS)
        d = x[..., i, :] >> s if i < N_LIMBS else torch.zeros_like(
            x[..., 0, :])
        if s + wbits > LIMB_BITS and i + 1 < N_LIMBS:
            d = d | (x[..., i + 1, :] << (LIMB_BITS - s))
        wins.append(d & ((1 << wbits) - 1))
    return torch.stack(wins, 0)

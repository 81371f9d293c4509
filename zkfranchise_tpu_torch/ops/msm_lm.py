"""Limb-major Pippenger MSM for BN254 G1/G2 (PyTorch, CUDA-kernel backed).

The structure is the JAX package's (ops/msm_lm.py there), kept step for
step so that every intermediate plane compares bit for bit:

  * 8-bit SIGNED-DIGIT windows (e in [-128, 127], carry-recoded): bucket
    magnitudes are 0..128, and a negative digit is a row offset into
    the doubled [P | -P] affine table (extend_table, built once per
    chunk by plan where the table is fixed);
  * per window: a stable argsort of the digit magnitudes, composed with a
    BIT-REVERSAL, gives each lane an index into that table in FOLD ORDER,
    so that every level of the sum tree is a contiguous fold-in-half add
    x[..., :m/2] + x[..., m/2:] (fold_padd_levels, several levels a
    launch as fold_plan says).  The leaves are never laid out as a plane:
    level 1 is fold_padd_aa reading its two affine operands from the
    table's rows through the index, and the path walks read their level-0
    leaves the same way, 128 rows a lane;
  * the upsweep stops at width 128; the 128 bucket-boundary prefix sums
    come from a shifted-add prefix scan over that level plus root-to-leaf
    walks over the retained levels (kernel padd);
  * sum_b b*S_b = 128*total - sum_{b<128} prefix_b, computed for all 32
    windows at once.

Scalars arrive as (n, 21, B) int32 plain canonical limbs; points as
(n, arows) int32 AFFINE rows from ec_affine.affine_table.  Results are
projective planes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ec_affine, ec_lm, lm
from .cuda import lm_kernels as K

WBITS = 8
N_WINDOWS = 32
N_MAGS = 1 << (WBITS - 1)       # signed-digit magnitudes 1..128; prefix
                                # queries cover 0..127 (= N_MAGS lanes)
WFLOOR = N_MAGS                 # the sum tree stops at width 128
MIN_CHUNK = 2048


def _signed_digits(digits: torch.Tensor):
    """(32, B, n) unsigned base-256 digits -> (signs, mags) of the signed
    recoding e_w in [-128, 127]: e = d + carry; e >= 128 -> e -= 256,
    carry out 1.  Scalars are < 2^254, so the final carry is always 0."""
    signs, mags = [], []
    carry = torch.zeros_like(digits[0])
    for w in range(N_WINDOWS):
        e = digits[w] + carry
        hi = (e >= N_MAGS).to(torch.int32)
        e = e - 256 * hi
        carry = hi
        signs.append((e < 0).to(torch.int32))
        mags.append(e.abs())
    return torch.stack(signs), torch.stack(mags)


def _next_pow2(n):
    m = 1
    while m < n:
        m *= 2
    return m


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    br = np.zeros(n, dtype=np.int64)
    for i in range(n):
        br[i] = int(bin(i)[2:].zfill(log_n)[::-1] or "0", 2)
    return br


def _bitrev_values(k: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-reverse int values over `bits` bits."""
    out = torch.zeros_like(k)
    for i in range(bits):
        out = out | (((k >> i) & 1) << (bits - 1 - i))
    return out


def _neg_plane(x: torch.Tensor, kind: str) -> torch.Tensor:
    nl = lm.N_LIMBS
    d = lm.const(lm.FQ.sub_d, x.device)
    if kind == "g1":
        neg_y = lm.weak_norm(d - x[..., nl:2 * nl, :])
        return torch.cat([x[..., :nl, :], neg_y, x[..., 2 * nl:, :]], -2)
    neg_y = lm.weak_norm(torch.cat([d, d], -2) - x[..., 2 * nl:4 * nl, :])
    return torch.cat([x[..., :2 * nl, :], neg_y, x[..., 4 * nl:, :]], -2)


def _tree_reduce_lanes(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(B, rows, m) -> (B, rows, 1) sum over lanes (m a power of two)."""
    while x.shape[-1] > 1:
        x = K.fold_padd(x, kind)
    return x


def _double_k(x: torch.Tensor, k: int, kind: str) -> torch.Tensor:
    for _ in range(k):
        x = K.padd(x, x, kind)
    return x


def _lane_scan_padd(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Inclusive EC prefix sum over the last axis (width <= 128) by
    log-step SHIFTED adds, every add at the full stored width."""
    w = x.shape[-1]
    s = 1
    while s < w:
        idp = ec_lm.identity_plane(kind, x.shape[:-2], s, x.device)
        shifted = torch.cat([idp, x[..., :-s]], -1)
        x = K.padd(x, shifted, kind)
        s *= 2
    return x


def default_window_group(m: int, B: int, device) -> int:
    """Windows processed together.  On the card: G*B <= 128 and
    G*B*m <= 2^23, the caps the JAX package measured on the TPU (at
    B = 128 and m = 32,768 a 32-window group would gather ~23 GB).  On
    the CPU (tests, tiny sizes): one 32-window group."""
    if torch.device(device).type != "cuda":
        return N_WINDOWS
    lanes_cap = max(1, (1 << 23) // m)
    G = max(1, min(8, 128 // B, lanes_cap // B))
    return 1 << (G.bit_length() - 1)       # a divisor of N_WINDOWS


def extend_table(table: torch.Tensor, kind: str) -> torch.Tensor:
    """(m, arows) affine rows -> (2m, arows) rows [P | -P]: the point of a
    negative digit lies m rows after its own."""
    return torch.cat([table, ec_affine.neg_affine(
        table.transpose(0, 1), kind).transpose(0, 1)], 0)


def chunk_window_sums(scalars_chunk: torch.Tensor, table_ext: torch.Tensor,
                      kind: str,
                      window_group: int | None = None) -> torch.Tensor:
    """Per-window signed-bucket sums for ONE pow2-sized chunk.
    scalars_chunk: (m, 21, B) canonical plain (zero-padded to pow2 m);
    table_ext: (2m, arows) the identity-padded chunk's extend_table.
    Returns (32, B, rows, 1) projective planes."""
    m = scalars_chunk.shape[0]
    assert table_ext.shape[0] == 2 * m and m == _next_pow2(m)
    digits = lm.window_digits(scalars_chunk, WBITS, N_WINDOWS)  # (32, m, B)
    signs, mags = _signed_digits(digits.transpose(-1, -2))      # (32, B, m)
    return _window_sums(signs, mags, table_ext, kind, window_group, m)


def combine_horner(w_chunks: list, kind: str, B: int) -> torch.Tensor:
    """[(32, B, rows, 1)] per-chunk window sums -> (B, rows, 1) MSM
    result: add the window sums across chunks, then Horner over windows
    (most significant first)."""
    w_all = w_chunks[0]
    for w in w_chunks[1:]:
        w_all = K.padd(w_all, w, kind)
    acc = ec_lm.identity_plane(kind, (B,), 1, w_all.device)
    for wv in w_all.flip(0):
        for _ in range(WBITS):
            acc = K.padd(acc, acc, kind)
        acc = K.padd(acc, wv, kind)
    return acc


def pad_chunk(scalars: torch.Tensor | None, table, start: int, real: int,
              m: int, kind: str):
    """Slice chunk [start, start+real) and pad to pow2 m (zero scalars,
    identity points).  Either argument may be None."""
    sc = tab = None
    if scalars is not None:
        sc = scalars[start:start + real]
        if m != real:
            sc = torch.cat([sc, sc.new_zeros((m - real, *sc.shape[1:]))], 0)
    if table is not None:
        tab = table[start:start + real]
        if m != real:
            tab = torch.cat([tab, torch.as_tensor(
                ec_affine.identity_rows(kind, m - real), device=tab.device)],
                0)
    return sc, tab


def plan(table: torch.Tensor, kind: str) -> list:
    """An n-point AFFINE table (n, arows) -> its chunks [(start, real, m,
    table_ext)] for msm_planned: each chunk identity-padded to pow2 m and
    extended by its negation (extend_table).  Built once where the table
    is fixed (the provers' keys)."""
    assert table.shape[-1] == ec_affine.AROWS[kind], \
        "msm expects an AFFINE table"
    return [(s, r, m, extend_table(pad_chunk(None, table, s, r, m, kind)[1],
                                   kind))
            for s, r, m in _chunks(table.shape[0])]


def msm_planned(scalars_plain: torch.Tensor, chunks: list, kind: str,
                window_group: int | None = None) -> torch.Tensor:
    """scalars_plain: (n, 21, B) int32 canonical plain limbs over the
    table that plan(table, kind) made `chunks` of.
    Returns (B, rows, 1) packed PROJECTIVE result planes."""
    ws = [chunk_window_sums(pad_chunk(scalars_plain, None, s, r, m, kind)[0],
                            ext, kind, window_group)
          for s, r, m, ext in chunks]
    return combine_horner(ws, kind, scalars_plain.shape[-1])


def msm(scalars_plain: torch.Tensor, table: torch.Tensor, kind: str,
        window_group: int | None = None) -> torch.Tensor:
    """scalars_plain: (n, 21, B) int32 canonical plain limbs;
    table: (n, arows) int32 AFFINE point rows, planned on every call.
    Returns (B, rows, 1) packed PROJECTIVE result planes."""
    assert table.shape[0] == scalars_plain.shape[0]
    return msm_planned(scalars_plain, plan(table, kind), kind, window_group)


def fold_launches(m: int, B: int, kind: str, G: int | None = None) -> dict:
    """{lm_kernels.FOLD_SHAPES key: launches} of one chunk_window_sums on
    the card: a pow2 chunk of m points at batch B, G windows a group
    (default_window_group on the card when None)."""
    if G is None:
        G = default_window_group(m, B, "cuda")
    out: dict = {}

    def add(name, h, n):
        key = f"{name}/{kind}/B{G * B}/h{h}/n{n}"
        out[key] = out.get(key, 0) + N_WINDOWS // G

    floor = 1 if m < WFLOOR else WFLOOR
    if m > floor:
        h = m // 2
        add("fold_padd_aa", h, 1)
        for n in K.fold_plan(kind, h, floor):
            add("fold_padd", h // 2, n)
            h >>= n
    if m < WFLOOR:                      # group_small's _tree_reduce_lanes
        for h in range(WFLOOR.bit_length() - 2, -1, -1):
            add("fold_padd", 1 << h, 1)
    return out


def msm_fold_launches(n: int, B: int, kind: str,
                      G: int | None = None) -> dict:
    """fold_launches summed over the chunks of an n-point msm."""
    out: dict = {}
    for _, _, m in _chunks(n):
        for key, v in fold_launches(m, B, kind, G).items():
            out[key] = out.get(key, 0) + v
    return out


def _chunks(n: int):
    """[(start, real, padded)].  At most ONE split, and only when the
    padding waste is >= 25% of the padded tree: one big pow2 half plus one
    padded remainder."""
    m = _next_pow2(n)
    if m - n < max(MIN_CHUNK, m // 4):
        return [(0, n, m)]
    c = m // 2
    return [(0, c, c), (c, n - c, _next_pow2(n - c))]


def upsweep(table_ext: torch.Tensor, idx: torch.Tensor, kind: str,
            floor: int) -> list:
    """The sum tree over the leaves table_ext[idx] (lane b's leaf j is row
    idx[b, j] of the (rows, arows) affine table; idx (B, m) int32, fold
    order) -> its levels above the leaves down to width `floor`, [level 1,
    level 2, ...] (projective): level 1 by fold_padd_aa reading the table
    through idx, so the leaves are never laid out as a plane, then
    fold_padd_levels, several levels a launch as fold_plan says.  Every
    level is kept: fine_walk reads them all."""
    if idx.shape[-1] <= floor:
        return []
    levels = [K.fold_padd_aa(table_ext, kind, idx=idx)]
    for n in K.fold_plan(kind, levels[-1].shape[-1], floor):
        levels += K.fold_padd_levels(levels[-1], kind, n)
    return levels


def _window_sums(signs, mags, table_ext, kind, G, m):
    """signs/mags (32, B, m); table_ext (2m, arows) affine -> (32, B, rows,
    1).

    Per window group: sort by magnitude -> each lane's signed index into
    table_ext in fold order -> upsweep down to width 128 (level 1 through
    fold_padd_aa on the indexed rows) -> unscramble the width-128 level
    and take its inclusive prefix scan -> per-bucket prefix = coarse
    prefix + fine path walk over the stored levels (level 0: 128 indexed
    rows a lane) -> u = scan over the bucket prefixes.  W = 128*total - u
    then runs once on the stacked 32-window plane."""
    rows = ec_lm.ROWS[kind]
    dev = signs.device
    B = signs.shape[1]
    if G is None:
        G = default_window_group(m, B, dev)
    assert N_WINDOWS % G == 0
    log_m = m.bit_length() - 1
    br = lm.const(_bitrev(m), dev)
    small = m < WFLOOR                 # tiny chunks (tests): full tree
    k = 0 if small else log_m - 7      # coarse block size 2^k
    buckets = torch.arange(N_MAGS, dtype=torch.int32,
                           device=dev).expand(G * B, N_MAGS).contiguous()

    def sort_index(sg, d):
        order = torch.argsort(d, dim=-1, stable=True)
        d_sorted = torch.take_along_dim(d, order, -1)
        perm = order[..., br]                           # fold order
        sg_fold = torch.take_along_dim(sg, perm, -1)
        idx = (perm + m * sg_fold).reshape(G * B, m).to(torch.int32)
        counts = torch.searchsorted(d_sorted.reshape(G * B, m).contiguous(),
                                    buckets, right=True).to(torch.int32)
        return idx, counts                      # signed: 2nd half; (G*B, 128)

    def leaves(rows_at):
        """The table's rows at rows_at (G*B, w) -> (G*B, rows, w)
        projective leaves."""
        x = table_ext[rows_at.long()].transpose(-1, -2)
        return ec_affine.to_projective(x, kind)

    def fine_walk(idx, levels, acc, counts, offset, top_lvl):
        """Root-to-leaf path adds for levels < top_lvl (width-128 ops);
        levels[l - 1] holds level l."""
        for lvl in range(top_lvl - 1, -1, -1):
            take = (counts >> lvl) & 1                  # (G*B, 128)
            src = _bitrev_values(offset >> lvl, log_m - lvl).long()
            if lvl == 0:
                node = leaves(torch.take_along_dim(idx, src, -1))
            else:
                node = torch.take_along_dim(levels[lvl - 1], src[:, None, :],
                                            -1)         # (G*B, rows, 128)
            added = K.padd(acc, node, kind)
            acc = torch.where((take == 1)[:, None, :], added, acc)
            offset = offset + (take << lvl)
        return acc

    def group_small(sg, d):
        """Full tree to width 1 (m < 128: tests and tiny chunks)."""
        idx, counts = sort_index(sg, d)
        levels = upsweep(table_ext, idx, kind, 1)
        total = levels[-1] if levels else leaves(idx)   # m == 1
        acc = ec_lm.identity_plane(kind, (G * B,), N_MAGS, dev)
        acc = fine_walk(idx, levels, acc, counts, torch.zeros_like(counts),
                        log_m + 1)
        return total, _tree_reduce_lanes(acc, kind)

    def group(sg, d):
        idx, counts = sort_index(sg, d)
        levels = upsweep(table_ext, idx, kind, WFLOOR)
        coarse = levels[-1] if levels else leaves(idx)  # width 128
        # storage position j holds sorted block bitrev7(j): unscramble,
        # then inclusive prefix over the sorted coarse blocks
        br7 = lm.const(_bitrev(WFLOOR), dev)
        cp = _lane_scan_padd(coarse[..., br7], kind)    # (G*B, rows, 128)
        total = cp[..., -1:]
        q = counts >> k                                 # (G*B, 128)
        node_c = torch.take_along_dim(
            cp, torch.clamp(q - 1, min=0)[:, None, :].long(), -1)
        idp = ec_lm.identity_plane(kind, (G * B,), N_MAGS, dev)
        acc = torch.where((q >= 1)[:, None, :], node_c, idp)
        acc = fine_walk(idx, levels, acc, counts & ((1 << k) - 1),
                        (q << k) if k else torch.zeros_like(q), k)
        return total, _lane_scan_padd(acc, kind)[..., -1:]

    body = group_small if small else group
    totals, us = [], []
    for g0 in range(0, N_WINDOWS, G):
        total, u = body(signs[g0:g0 + G], mags[g0:g0 + G])
        totals.append(total.reshape(G, B, rows))
        us.append(u.reshape(G, B, rows))
    # W_w = 128 * total_w - u_w across ALL windows at once: windows ride
    # the lane axis (width-32 kernel launches)
    tw = torch.cat(totals, 0).permute(1, 2, 0)          # (B, rows, 32)
    uw = torch.cat(us, 0).permute(1, 2, 0)
    t128 = _double_k(tw, WBITS - 1, kind)
    w = K.padd(t128, _neg_plane(uw, kind), kind)        # (B, rows, 32)
    return w.permute(2, 0, 1)[..., None]                # (32, B, rows, 1)

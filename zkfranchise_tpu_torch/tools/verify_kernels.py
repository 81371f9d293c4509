"""The port's kernels and the whole MSM against the host bigint oracle.

Runs the wrappers the prover uses (padd G1/G2 with doubling and identity
lanes, fold_padd, mont_mul), fold_mul, inv (with a zero lane), the batch
inversion (batch_inv: fold_mul_levels, its top and walk down), a
fold_affine chain folded to the total, and the full
msm_lm.msm, G1 and G2, and checks every result against ops/ec.py and
ops/ff.py.

    python -m zkfranchise_tpu_torch.tools.verify_kernels [--device cpu] [--small]

Exit code 0 iff everything matches.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import ec, ec_affine, ec_lm, ff, lm, msm_lm
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import check, cli, verdict

FULL = dict(lanes=256, inv_lanes=128, chain=256, msm_n={"g1": 300, "g2": 48},
            msm_batch=8)
SMALL = dict(lanes=4, inv_lanes=8, chain=8, msm_n={"g1": 5, "g2": 3},
             msm_batch=2)

_GROUPS = {"g1": (ec.G1, ec.g1_mul, ec_lm.g1_plane_to_affine, ec_lm.g1_table),
           "g2": (ec.G2, ec.g2_mul, ec_lm.g2_plane_to_affine, ec_lm.g2_table)}


def affine_plane_to_host(plane, kind: str) -> list:
    """(arows, T) affine plane -> list of host points | None."""
    k = 1 if kind == "g1" else 2
    nl = lm.N_LIMBS
    comps = [lm.lm_to_ints(lm.from_mont(plane[i * nl:(i + 1) * nl, :], lm.FQ))
             for i in range(2 * k)]
    inf = plane[2 * k * nl].tolist()
    out = []
    for t in range(plane.shape[-1]):
        if inf[t] == 1:
            out.append(None)
        elif k == 1:
            out.append((comps[0][t], comps[1][t]))
        else:
            out.append(((comps[0][t], comps[1][t]),
                        (comps[2][t], comps[3][t])))
    return out


def _timed(dev, name, fn):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# {name}: {time.perf_counter() - t0:.3f}s", file=sys.stderr)
    return out


def _rand_fq(rng, n):
    return [int.from_bytes(rng.bytes(31), "big") % ff.P_FQ for _ in range(n)]


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    size = SMALL if small else FULL
    print(f"device: {dev}", file=sys.stderr)
    rng = np.random.default_rng(17)
    failed: list = []
    T = size["lanes"]

    def on(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=dev)

    # --- padd G1/G2 over T lanes, doubling, identity, fold_padd ------------
    for kind, (grp, gmul, to_aff, tab) in _GROUPS.items():
        ps = [gmul(3 + j) for j in range(T)]
        qs = [gmul(1000 + 7 * j) for j in range(T)]
        pp, qq = on(tab(ps).T), on(tab(qs).T)
        out = _timed(dev, f"padd {kind}", lambda: K.padd(pp, qq, kind))
        want = [grp.add(p, q) for p, q in zip(ps, qs)]
        check(failed, f"padd {kind} ({T} lanes)", to_aff(out) == want)
        check(failed, f"pdouble {kind}",
              to_aff(K.padd(pp, pp, kind)) == [grp.double(p) for p in ps])
        ident = ec_lm.identity_plane(kind, (), T, dev)
        check(failed, f"padd identity {kind}",
              to_aff(K.padd(ident, qq, kind)) == qs)
        both = torch.cat([pp, qq], -1)[None]
        outf = _timed(dev, f"fold_padd {kind}",
                      lambda: K.fold_padd(both, kind))
        check(failed, f"fold_padd {kind}", to_aff(outf[0]) == want)

    # --- mont_mul -----------------------------------------------------------
    xs, ys = _rand_fq(rng, T), _rand_fq(rng, T)
    out = K.mont_mul(on(lm.ints_to_lm(xs)), on(lm.ints_to_lm(ys)), lm.FQ)
    rinv = pow(1 << lm.R_BITS, -1, ff.P_FQ)
    check(failed, "mont_mul", all(
        g % ff.P_FQ == x * y * rinv % ff.P_FQ
        for g, x, y in zip(lm.lm_to_ints(out), xs, ys)))

    # --- fold_mul, inv (a zero lane), batch_inv -----------------------------
    n_inv = size["inv_lanes"]
    vals = [v or 1 for v in _rand_fq(rng, n_inv)]
    rm = 1 << lm.R_BITS
    d = on(lm.ints_to_lm([v * rm % ff.P_FQ for v in vals])[None])
    h = n_inv // 2
    out = K.fold_mul(d, lm.FQ)
    check(failed, f"fold_mul ({n_inv} lanes)",
          lm.lm_to_ints(lm.from_mont(out[0], lm.FQ)) ==
          [vals[j] * vals[j + h] % ff.P_FQ for j in range(h)])
    a = d[0].clone()
    a[:, 1] = 0                                            # inv(0) = 0
    out = _timed(dev, "inv", lambda: K.inv(a, lm.FQ))
    check(failed, f"inv ({n_inv} lanes, one zero)",
          lm.lm_to_ints(lm.from_mont(out, lm.FQ)) ==
          [0 if j == 1 else pow(v, -1, ff.P_FQ) for j, v in enumerate(vals)])
    iv = _timed(dev, "batch_inv", lambda: K.batch_inv(d, lm.FQ))
    check(failed, f"batch_inv ({n_inv} lanes)",
          lm.lm_to_ints(lm.from_mont(iv, lm.FQ)) ==
          [pow(v, -1, ff.P_FQ) for v in vals])

    # --- fold_affine: a chain folded to the total ---------------------------
    n = size["chain"]
    for kind, (grp, gmul, _, _) in _GROUPS.items():
        # real points, two infinities, an equal pair and an opposite pair
        # at level 0 (lanes j and j + n/2)
        pts = [gmul(3 + j) for j in range(n)]
        pts[1] = pts[n - 1] = None
        pts[n // 2 + 2] = pts[2]
        pts[n // 2 + 3] = grp.neg(pts[3])
        x = on(ec_affine.affine_table(pts, kind).T[None])

        def fold_all(x=x, kind=kind):
            while x.shape[-1] > 1:
                x = ec_affine.fold_affine(x, kind)
            return x

        x = _timed(dev, f"fold_affine chain {kind}", fold_all)
        want = None
        for p in pts:
            want = grp.add(want, p)
        check(failed, f"fold_affine chain {kind} ({n} points)",
              affine_plane_to_host(x[0], kind)[0] == want)

    # --- the whole MSM ------------------------------------------------------
    B = size["msm_batch"]
    for kind, (grp, gmul, to_aff, _) in _GROUPS.items():
        n = size["msm_n"][kind]
        pts = [gmul(j + 3) for j in range(n)]
        scal = [[int.from_bytes(rng.bytes(32), "big") % ff.P_FR
                 for _ in range(n)] for _ in range(B)]
        sc = on(np.stack([lm.ints_to_lm([scal[j][i] for j in range(B)])
                          for i in range(n)]))
        table = on(ec_affine.affine_table(pts, kind))
        out = _timed(dev, f"msm {kind} n={n} B={B}",
                     lambda: msm_lm.msm(sc, table, kind))
        plane = out[..., 0].transpose(0, 1)
        want = [ec.msm_host(row, pts, grp) for row in scal]
        check(failed, f"msm {kind} n={n} B={B} vs host oracle",
              to_aff(plane) == want)

    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

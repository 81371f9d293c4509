"""padd (G1 and G2) at the shapes the main path launches it with.

The MSM and the assembly call ``padd`` on five kinds of plane (B, rows, T):

  walk     (128, rows, 128)   fine_walk and _lane_scan_padd, G*B = 128
  double   (128, rows, 32)    the x128 doublings and W, windows on lanes
  horner   (128, rows, 1)     combine_horner, one point per batch row
  assemble (1, rows, 128)     the assembly's point adds
  wide     (128, rows, 2048)  no main-path launch: the card filled

Each plane mixes real points (sums of two random multiples of the
generator: Z != 1) with identity, doubling and P + (-P) positions.  The
kernel's output is first held against ``padd_ref`` (exact equality); then,
on the card only, one JSON line per shape gives the median milliseconds of
a whole call (CUDA events, host time included), the mean device time per
call (torch.profiler: the kernels' own durations, through
``tools.device_reading``, which marks a reading no card can give
``"invalid"``), and the shape's bounds:
bytes at 3.35 TB/s, multiply-adds at 67 T op/s (a multiply-add counted as
two, the data sheet's 32-bit rate) and at 64 integer multiply-adds per
clock per SM (the integer ceiling) at the SM clock read right after it.

    python -m zkfranchise_tpu_torch.tools.padd_shapes [--device cpu] [--small]
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import ec, ec_lm, msm_lm
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import HBM_BYTES_PER_S, INT_MADS_PER_CLK_SM, OPS_PER_S, SMS, \
    add_mads, check, cli, device_reading, event_ms, verdict

# (name, B, T)
SHAPES = [("walk", 128, 128), ("double", 128, 32), ("horner", 128, 1),
          ("assemble", 1, 128), ("wide", 128, 2048)]
SMALL_SHAPES = [("walk", 4, 16), ("double", 4, 8), ("horner", 8, 1),
                ("assemble", 1, 16)]


def padd_inputs(kind: str, B: int, T: int, rng, dev):
    """(p, q) projective planes (B, rows, T) from a pool of real points,
    with identity, doubling and P + (-P) positions spread over all B*T
    adds (a quarter of them when B*T >= 16)."""
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    pool = [mul(int(k)) for k in rng.integers(1, 1 << 60, size=32)]
    proj = torch.as_tensor((ec_lm.g1_table if kind == "g1"
                            else ec_lm.g2_table)(pool).T, device=dev)

    def pick():
        idx = torch.as_tensor(rng.integers(0, len(pool), size=B * T),
                              device=dev)
        return proj[:, idx]                             # (rows, B*T)

    p = K.padd_ref(pick(), pick(), kind)
    q = K.padd_ref(pick(), pick(), kind)
    n = B * T
    special = torch.as_tensor(rng.permutation(n)[:4 * max(1, n // 16)],
                              device=dev)
    neg, dbl, idp, idq = special.chunk(4) if n >= 4 else (special,) * 4
    q[:, neg] = msm_lm._neg_plane(p[:, neg], kind)
    q[:, dbl] = p[:, dbl]
    ident = ec_lm.identity_plane(kind, (), 1, dev)
    p[:, idp] = ident
    q[:, idq] = ident

    def plane(x):
        return x.reshape(-1, B, T).permute(1, 0, 2).contiguous()

    return plane(p), plane(q)


def bounds(kind: str, B: int, T: int, sm_mhz: float | None) -> dict:
    rows, adds = ec_lm.ROWS[kind], B * T
    bytes_ms = 4 * 3 * rows * adds / HBM_BYTES_PER_S * 1e3
    mads = add_mads("padd", kind) * adds
    ops_ms = 2 * mads / OPS_PER_S * 1e3
    out = {"bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if sm_mhz:
        out["int_ceiling_ms"] = mads / (
            INT_MADS_PER_CLK_SM * SMS * sm_mhz * 1e6) * 1e3
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def run(dev, shapes, failed: list) -> list:
    """Check and (on the card) time padd at `shapes` for both groups;
    -> one dict per (kind, shape)."""
    rng = np.random.default_rng(4)
    results = []
    for kind in ("g1", "g2"):
        rows = ec_lm.ROWS[kind]
        for name, B, T in shapes:
            p, q = padd_inputs(kind, B, T, rng, dev)
            tag = f"padd/{kind}/{name} ({B},{rows},{T})"
            check(failed, tag, torch.equal(K.padd(p, q, kind),
                                           K.padd_ref(p, q, kind)))
            res = {"kind": kind, "name": name, "shape": [B, rows, T],
                   "adds": B * T}
            if dev.type == "cuda":
                res["ms"] = event_ms(lambda: K.padd(p, q, kind))
                r = device_reading(tag, lambda: K.padd(p, q, kind),
                                   4 * 3 * rows * B * T,
                                   add_mads("padd", kind) * B * T)
                res.update(device_ms=r["device_ms"], burst_ms=r["burst_ms"],
                           invalid=r["invalid"])
                # the clock right after the card's busy spell
                sm_mhz = float(smi("clocks.sm").split()[0])
                res.update(bounds(kind, B, T, sm_mhz), sm_mhz=sm_mhz)
            print(json.dumps(res), flush=True)
            results.append(res)
            del p, q
    return results


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    failed: list = []
    if dev.type == "cuda":
        print(smi("name,power.limit"), flush=True)
    run(dev, SMALL_SHAPES if small else SHAPES, failed)
    if dev.type != "cuda":
        print("no card: nothing timed")
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

"""The in-kernel scalar-mul chain against the host bigint oracle.

Computes k*P for per-lane base points and one shared 254-bit scalar, G1
and G2, through the scalar_mul kernel (double-and-add whose inner step is
the complete RCB15 addition), and checks the affine results against
ops/ec.py.  The scalar's zero bits keep the accumulator, bit runs exercise
doubling, and the first set bit adds to the identity.

    python -m zkfranchise_tpu_torch.tools.verify_lm [--device cpu] [--small]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import ec, ec_lm, ff
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import check, cli, verdict


def scalar_bits(k: int, nbits: int) -> np.ndarray:
    """k -> (nbits,) int32 0/1, least significant first."""
    return np.array([(k >> i) & 1 for i in range(nbits)], dtype=np.int32)


def run(kind: str, dev, lanes: int, nbits: int, failed: list) -> None:
    rng = np.random.default_rng(11)
    k = (int.from_bytes(rng.bytes(32), "big") % ff.P_FR) & ((1 << nbits) - 1)
    if kind == "g1":
        grp, gmul, table, to_aff = (ec.G1, ec.g1_mul, ec_lm.g1_table,
                                    ec_lm.g1_plane_to_affine)
    else:
        grp, gmul, table, to_aff = (ec.G2, ec.g2_mul, ec_lm.g2_table,
                                    ec_lm.g2_plane_to_affine)
    base_host = [gmul(7 + j) for j in range(lanes)]
    pts = torch.as_tensor(np.ascontiguousarray(table(base_host).T),
                          device=dev)
    t0 = time.perf_counter()
    out = K.scalar_mul(pts, scalar_bits(k, nbits), kind)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# {kind} scalar_mul: {time.perf_counter() - t0:.3f}s",
          file=sys.stderr)
    check(failed, f"{kind}: {lanes}-lane scalar-mul ({nbits}-bit) vs host "
                  f"oracle", to_aff(out) == [grp.mul(k, p) for p in base_host])


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    lanes, nbits = (2, 12) if small else (128, 254)
    failed: list = []
    for kind in ("g1", "g2"):
        run(kind, dev, lanes, nbits, failed)
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

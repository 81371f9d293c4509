"""Kernel-geometry experiments: how the time of a single-pass Montgomery
product and of a projective fold level depends on how many lanes a block
owns and on how the lane axis is laid out.

Swept (counterparts of the TPU experiments of the same names):

  mm2d    `chain` Fq products on a flat (21, T) lane axis, T = 2^20, at
          `tile` lanes per block from 512 to 32,768; chains of 2 and 8
          show what a product costs once the operands are in registers
  mm3d    one product on (128, 21, 8192), a block owning (blk, tile)
  fold2d  one G1 fold level on a flat (63, 128 * 8192) lane axis, on the
          cooperative add, at `tile` output lanes per block from 32 (one
          group of 32 adds, fold_padd's geometry) to 4096 (a block walking
          128 groups)

beside the production kernels mont_mul and fold_padd at the same sizes
(mont_mul reads through general strides; mm3d does not) and on the same
data (fold_padd folds the segmented (128, 63, 8192) view of fold2d's
points: segmented against flat, on the same add).

Every geometry's output is first held against the plain PyTorch version
(exact equality); a geometry that differs is a FAIL and the run returns
non-zero, and a launch that fails raises.  Times are CUDA-event medians
and exist only on the card; on the CPU the tool checks and says that it
timed nothing.

    python -m zkfranchise_tpu_torch.tools.layout_expt [--device cpu] [--small]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ec_lm, lm
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import check_and_time, cli, verdict

# lanes, tiles of the 2D sweep, (tile, chain) of the chains, batch rows of
# the 3D view, (tile, blk) of the 3D sweep, fold segments and width, fold
# tiles
FULL = dict(T=1 << 20, tiles=(512, 2048, 8192, 32768),
            chains=((512, 2), (512, 8), (2048, 8)), B3=128,
            mm3d=((512, 8), (512, 1), (8192, 1)), B=128, m=8192,
            fold_tiles=(32, 512, 2048, 4096))
# fold tiles: below, at and past one group of 32 adds (40: a block of two
# groups, the second ragged), on segments of 40 output lanes
SMALL = dict(T=256, tiles=(16, 64, 256), chains=((16, 2), (64, 8)), B3=4,
             mm3d=((16, 2), (16, 1), (64, 1)), B=2, m=80,
             fold_tiles=(2, 8, 32, 40))


def random_limbs(rng, shape) -> np.ndarray:
    """Normalized limbs of values < 2^254, one element per 21 rows of the
    second-to-last axis."""
    x = rng.integers(0, 1 << 13, size=shape, dtype=np.int32)
    x[..., 19::21, :] &= 0x7F
    x[..., 20::21, :] = 0
    return x


def timed(failed: list, dev, name: str, work: int, fn, want) -> None:
    check_and_time(failed, dev, name, fn, want,
                   lambda ms: f"{ms * 1e6 / work:7.3f} ns/unit")


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    cfg = SMALL if small else FULL
    rng = np.random.default_rng(0)
    T = cfg["T"]
    a2 = torch.as_tensor(random_limbs(rng, (lm.N_LIMBS, T)), device=dev)
    b2 = torch.as_tensor(random_limbs(rng, (lm.N_LIMBS, T)), device=dev)
    failed: list = []

    want = {}                                   # chain -> a * b^chain
    x = a2
    for chain in range(1, 1 + max(c for _, c in cfg["chains"])):
        x = K.mm2d_ref(x, b2, 1, 1)
        want[chain] = x
    for tile in cfg["tiles"]:
        timed(failed, dev, f"mm 2D t={tile} single", T,
              lambda: K.mm2d(a2, b2, tile, 1), want[1])
    for tile, chain in cfg["chains"]:
        timed(failed, dev, f"mm 2D t={tile} chain{chain} (per-mul)",
              chain * T, lambda: K.mm2d(a2, b2, tile, chain), want[chain])
    del want, x

    # the same memory viewed as (B3, 21, T / B3)
    B3 = cfg["B3"]
    a3 = a2.reshape(B3, lm.N_LIMBS, T // B3)
    b3 = b2.reshape(B3, lm.N_LIMBS, T // B3)
    want3 = K.mm3d_ref(a3, b3, 1, 1)
    for tile, blk in cfg["mm3d"]:
        timed(failed, dev, f"mm 3D blk={blk} t={tile}", T,
              lambda: K.mm3d(a3, b3, tile, blk), want3)
    timed(failed, dev, f"K.mont_mul {tuple(a3.shape)}", T,
          lambda: K.mont_mul(a3, b3, lm.FQ), want3)
    del a2, b2, a3, b3, want3

    # one fold level of the same points, flat (rows, B*m) and segmented
    # (B, rows, m)
    B, m = cfg["B"], cfg["m"]
    rows = ec_lm.ROWS["g1"]
    x2 = torch.as_tensor(random_limbs(rng, (rows, B * m)), device=dev)
    x3 = x2.reshape(rows, B, m).permute(1, 0, 2).contiguous()
    n_padd = B * m // 2
    timed(failed, dev, f"K.fold_padd g1 {tuple(x3.shape)}", n_padd,
          lambda: K.fold_padd(x3, "g1"), K.fold_padd_ref(x3, "g1"))
    want2 = K.fold2d_ref(x2, 1, "g1", m)
    for tile in cfg["fold_tiles"]:
        timed(failed, dev, f"fold2d g1 t={tile}", n_padd,
              lambda: K.fold2d(x2, tile, "g1", m), want2)
    if dev.type != "cuda":
        print("no card: nothing timed")
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

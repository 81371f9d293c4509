"""Boundary-cost experiments: what does one pass over device memory cost
through a hand-written kernel of this binding, against PyTorch's own
elementwise add, and what does fusing a whole halving sum tree into one
launch save over a launch per level?

  E1  add_one (o = a + 1), (21, 2^20), 512 and 8192 lanes per block
  E2  torch add on the same array, and a chain of four
  E3  add_one on 24 and on 8 rows (row counts that are multiples of 8)
  E4  two add_one launches, one after the other
  E5  fused_upsweep (63, 65536): all 16 levels in one launch, beside the
      16 per-level torch adds (a launch and a pass over memory per level)

Every output is first held against its plain PyTorch version (exact
equality); one that differs is a FAIL and the run returns non-zero, and a
launch that fails raises.  Times are CUDA-event medians and exist only on
the card; on the CPU the tool checks and says that it timed nothing.

    python -m zkfranchise_tpu_torch.tools.layout_expt2 [--device cpu] [--small]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import check_and_time, cli, verdict


def timed(failed: list, dev, name: str, nbytes: int, fn, want) -> None:
    check_and_time(failed, dev, name, fn, want,
                   lambda ms: f"{nbytes / ms / 1e6:8.1f} GB/s")


def level_adds(x: torch.Tensor) -> torch.Tensor:
    """The halving sum tree as one torch add per level."""
    outs = []
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = torch.add(x[..., :h], x[..., h:])
        outs.append(x)
    return torch.cat(outs, -1)


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    T, tiles, m = (256, (16, 64), 64) if small else (1 << 20, (512, 8192),
                                                    1 << 16)
    rng = np.random.default_rng(0)

    def rand(rows, lanes):
        return torch.as_tensor(rng.integers(0, 1 << 13, (rows, lanes),
                                            dtype=np.int32), device=dev)

    a21, a24, a8 = rand(21, T), rand(24, T), rand(8, T)
    nb = {r: 2 * r * T * 4 for r in (21, 24, 8)}         # read + write
    failed: list = []

    timed(failed, dev, "E2 torch add (21,T)", nb[21], lambda: a21 + 1,
          K.add_one_ref(a21, 1))
    timed(failed, dev, "E2b torch chain4 (21,T)", 4 * nb[21],
          lambda: a21 + 1 + 1 + 1 + 1, K.add_one_ref(a21, 1) + 3)
    for tag, tile in zip(("E1", "E1b"), tiles):
        timed(failed, dev, f"{tag} add_one (21,T) t={tile}", nb[21],
              lambda: K.add_one(a21, tile), K.add_one_ref(a21, tile))
    timed(failed, dev, f"E3 add_one (24,T) t={tiles[0]}", nb[24],
          lambda: K.add_one(a24, tiles[0]), K.add_one_ref(a24, tiles[0]))
    timed(failed, dev, f"E3b add_one (8,T) t={tiles[0]}", nb[8],
          lambda: K.add_one(a8, tiles[0]), K.add_one_ref(a8, tiles[0]))
    timed(failed, dev, f"E4 add_one x2 (21,T) t={tiles[0]}", 2 * nb[21],
          lambda: K.add_one(K.add_one(a21, tiles[0]), tiles[0]),
          K.add_one_ref(a21, 1) + 1)

    x = rand(63, m)
    nbx = 63 * (2 * m - 1) * 4                           # read + write
    want = K.fused_upsweep_ref(x)
    timed(failed, dev, f"E5 fused_upsweep (63,{m})", nbx,
          lambda: K.fused_upsweep(x, tiles[0]), want)
    timed(failed, dev, f"E5b torch add per level (63,{m})", nbx,
          lambda: level_adds(x), want)
    if dev.type != "cuda":
        print("no card: nothing timed")
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

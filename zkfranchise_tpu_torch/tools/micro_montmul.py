"""Microbenchmark: Montgomery products per second of the 21 x 13 bit limb
core inside one kernel (mont_chain: 20 chained Fq products over 131,072
lanes, x kept in registers, the Karatsuba register product), beside the
same chain through the mont_mul kernel (one launch and one pass over
device memory per product), and the chain's device ms through
tools.device_reading.

Correctness first: one product per lane against the integer formula
a*b*R^-1 mod p.  Rates are timed with CUDA events and so exist only on the
card; on the CPU the script checks correctness and says that it timed
nothing.

    python -m zkfranchise_tpu_torch.tools.micro_montmul [--device cpu] [--small]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ff, lm
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import check, cli, device_reading, event_ms, mont_chain_work, verdict

P = ff.P_FQ
N_VALUES = 256


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    lanes, iters = (N_VALUES, 3) if small else (128 * 1024, 20)
    rng = np.random.default_rng(0)
    xs = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(N_VALUES)]
    ys = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(N_VALUES)]
    a = torch.as_tensor(np.tile(lm.ints_to_lm(xs), (1, lanes // N_VALUES)),
                        device=dev)
    b = torch.as_tensor(np.tile(lm.ints_to_lm(ys), (1, lanes // N_VALUES)),
                        device=dev)
    failed: list = []

    out = K.mont_chain(a[:, :N_VALUES], b[:, :N_VALUES], 1, lm.FQ)
    rinv = pow(1 << lm.R_BITS, -1, P)
    check(failed, "mont_chain iters=1 vs integer formula", all(
        g % P == x * y * rinv % P
        for g, x, y in zip(lm.lm_to_ints(out), xs, ys)))
    full = K.mont_chain(a, b, iters, lm.FQ)
    want = [x * pow(y * rinv, iters, P) % P for x, y in zip(xs, ys)]
    check(failed, f"mont_chain iters={iters} vs integer formula", all(
        g % P == w for g, w in zip(lm.lm_to_ints(full[:, :N_VALUES]), want)))

    if dev.type != "cuda":
        print("no card: nothing timed")
        return verdict(failed)

    def launches():
        x = a
        for _ in range(iters):
            x = K.mont_mul(x, b, lm.FQ)
        return x

    check(failed, "mont_chain equals chained mont_mul launches",
          torch.equal(full, launches()))
    work = lanes * iters
    for tag, fn in (("mont_chain (one kernel)",
                     lambda: K.mont_chain(a, b, iters, lm.FQ)),
                    (f"mont_mul x {iters} launches", launches)):
        ms = event_ms(fn)
        print(f"{tag:28s} {work / ms / 1e3:9.1f} Mmul/s  ({ms:8.3f} ms, "
              f"{lanes} lanes x {iters})", flush=True)
    # the kernel's own time, held against the Karatsuba product's
    # multiply-adds (what mont_chain runs)
    device_reading(f"mont_chain/fq/21x{lanes}x{iters}",
                   lambda: K.mont_chain(a, b, iters, lm.FQ),
                   *mont_chain_work(lanes, iters))
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

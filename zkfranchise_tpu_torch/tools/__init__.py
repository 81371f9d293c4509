"""Checks of the port's kernels against the host bigint oracle, and the
layout experiments (geometry sweeps held against the plain versions).

    python -m zkfranchise_tpu_torch.tools.verify_kernels [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.verify_lm [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.micro_montmul [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.layout_expt [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.layout_expt2 [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.padd_shapes [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.fold_shapes [--device cpu] [--small]

    python -m zkfranchise_tpu_torch.tools.prove_from_zkey --zkey F --vk F --nlevels N

Each has a ``main(..., device=None, ...) -> int`` that prints PASS/FAIL lines
and returns non-zero on any FAIL.  They run on the card unless another device
is named; on the CPU the kernels' plain versions run (``--small`` keeps
that short).
"""
from __future__ import annotations

import argparse
import statistics

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the 32-bit
# non-tensor rate (67 T op/s float32, a multiply-add counted as two); the
# integer ceiling: 64 32-bit multiply-adds per clock per SM (CUDA C
# Programming Guide, compute capability 9.0), 132 SMs
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT_MADS_PER_CLK_SM, SMS = 64, 132

# Multiply-adds, counted from csrc/.  The column sums of a product of two
# 21-limb elements take 441 in the schoolbook (the one-thread kernels:
# mont_mul, the chains, padd_point) and 342 with the one level of
# Karatsuba of the cooperative adds (lm_kernels.cu cols_add, which also
# forms the reduction's m*p); a reduction adds the triangular m = t*n'.
COLS_SCHOOLBOOK, COLS_KARATSUBA, MAD_LOW = 441, 342, 231
MAD_MONT = 2 * COLS_SCHOOLBOOK + MAD_LOW                # 1113
# an EC add as (products, reductions of 2 lazy terms, of 4): RCB15 (padd)
# and the mixed add of two affine points (padd_aa), over Fq (G1) or Fq2
_ADD_TERMS = {("padd", "g1"): (8, 3, 0), ("padd", "g2"): (0, 16, 6),
              ("padd_aa", "g1"): (4, 3, 0), ("padd_aa", "g2"): (0, 8, 6)}


def add_mads(form: str, kind: str, cols: int = COLS_KARATSUBA) -> int:
    """Multiply-adds of one EC add of `form` ("padd" or "padd_aa") in
    group `kind` whose column products take `cols` each: the cooperative
    adds' Karatsuba by default (G1 11,091 / 7,431, G2 31,758 / 21,702), the
    schoolbook for padd_point (G1 13,566 / 9,114, G2 39,480 / 27,048)."""
    prods, lazy2, lazy4 = _ADD_TERMS[(form, kind)]
    red = MAD_LOW + cols
    return prods * (cols + red) + lazy2 * (2 * cols + red) + \
        lazy4 * (4 * cols + red)


def check(failed: list, name: str, ok: bool) -> None:
    print(f"{'PASS' if ok else 'FAIL'}  {name}", flush=True)
    if not ok:
        failed.append(name)


def verdict(failed: list) -> int:
    print("VERDICT:", "PASS" if not failed else f"FAIL {failed}", flush=True)
    return 1 if failed else 0


def cli(main, doc: str) -> int:
    """Parse --device / --small and call main(device, small=...)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="reduced sizes, for the plain versions on a CPU")
    args = ap.parse_args()
    return main(args.device, small=args.small)


def event_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over `runs` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = 20) -> float:
    """Mean device milliseconds per call of `fn`: the summed durations of
    the CUDA kernels it launched, from torch.profiler, so the host's time
    between launches is left out (it dominates a call of a few
    microseconds of device work)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / runs / 1e3


def check_and_time(failed: list, dev: torch.device, name: str, fn, want,
                   rate) -> None:
    """Hold fn() against `want` (exact equality), then, on the card, print
    its median milliseconds, `rate(ms)` (the tool's own unit) and the
    kernels' own device milliseconds per call."""
    check(failed, name, torch.equal(fn(), want))
    if dev.type == "cuda":
        ms = event_ms(fn)
        print(f"{name:44s} {ms:9.4f} ms   {rate(ms)}   device "
              f"{device_ms(fn):.4f} ms", flush=True)

"""Checks of the port's kernels against the host bigint oracle, and the
layout experiments (geometry sweeps held against the plain versions).

    python -m zkfranchise_tpu_torch.tools.verify_kernels [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.verify_lm [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.micro_montmul [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.layout_expt [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.layout_expt2 [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.padd_shapes [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.fold_shapes [--device cpu] [--small]
    python -m zkfranchise_tpu_torch.tools.ladder_teams [--device cpu]
    python -m zkfranchise_tpu_torch.tools.tree_compare PARENT [CHANGE]

    python -m zkfranchise_tpu_torch.tools.prove_from_zkey --zkey F --vk F --nlevels N

Each but tree_compare (parent against change on the card, see its
docstring) has a ``main(..., device=None, ...) -> int`` that prints
PASS/FAIL lines and returns non-zero on any FAIL.  They run on the card
unless another device is named; on the CPU the kernels' plain versions run
(``--small`` keeps that short).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import torch

from ..ops import ec_lm

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the 32-bit
# non-tensor rate (67 T op/s float32, a multiply-add counted as two); the
# integer ceiling: 64 32-bit multiply-adds per clock per SM (CUDA C
# Programming Guide, compute capability 9.0), 132 SMs
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT_MADS_PER_CLK_SM, SMS = 64, 132

# Multiply-adds, counted from csrc/.  The column sums of a product of two
# 21-limb elements take 441 in the schoolbook (fold_mul at one level,
# Poseidon, mm3d, and the warp inv, whose lanes form the schoolbook's
# columns) and 342 with the one level of Karatsuba of lm_device.cuh
# cols_add (the cooperative adds and fold2d, mont_mul, ntt_level, mm2d,
# mont_chain and batch_inv's tree, which also form the reduction's m*p
# with it); a reduction adds the triangular m = t*n'.  batch_inv's bound
# counts its chain at the Karatsuba product too, the least work known.
COLS_SCHOOLBOOK, COLS_KARATSUBA, MAD_LOW = 441, 342, 231
MAD_MONT = 2 * COLS_SCHOOLBOOK + MAD_LOW                # 1113
MAD_MONT_KARATSUBA = 2 * COLS_KARATSUBA + MAD_LOW       # 915
# an EC add as (products, reductions of 2 lazy terms, of 4): RCB15 (padd)
# and the mixed add of two affine points (padd_aa), over Fq (G1) or Fq2
_ADD_TERMS = {("padd", "g1"): (8, 3, 0), ("padd", "g2"): (0, 16, 6),
              ("padd_aa", "g1"): (4, 3, 0), ("padd_aa", "g2"): (0, 8, 6)}


def add_mads(form: str, kind: str, cols: int = COLS_KARATSUBA) -> int:
    """Multiply-adds of one EC add of `form` ("padd" or "padd_aa") in
    group `kind` whose column products take `cols` each: the cooperative
    adds' Karatsuba by default (G1 11,091 / 7,431, G2 31,758 / 21,702), or
    the schoolbook's (G1 13,566 / 9,114, G2 39,480 / 27,048)."""
    prods, lazy2, lazy4 = _ADD_TERMS[(form, kind)]
    red = MAD_LOW + cols
    return prods * (cols + red) + lazy2 * (2 * cols + red) + \
        lazy4 * (4 * cols + red)


def bound_ms(nbytes: float, mads: float) -> tuple:
    """Least time in ms for this work on the card, and what bounds it:
    bytes over the H100's memory rate or multiply-adds over its 32-bit
    rate, a multiply-add counted as two operations -> (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * mads / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mont_chain_work(T: int, iters: int) -> tuple:
    """(bytes, multiply-adds) of a chain of `iters` products on (21, T)
    (mont_chain, mm2d): a and b read and the result written once, `iters`
    Karatsuba products a lane."""
    return 4 * 3 * 21 * T, MAD_MONT_KARATSUBA * iters * T


# the Fermat chain of an Fq inverse: 253 squares and a product per set bit
# of p - 2 (110)
INV_CHAIN_FQ = 363


def batch_inv_work(B: int, X: int, chain: int = INV_CHAIN_FQ) -> tuple:
    """(bytes, multiply-adds) of batch_inv over (B, 21, X): d read and the
    result written once; X - 1 products a row up, 2 (X - 1) down, and one
    Fermat chain of `chain` products a row, each product counted at the
    Karatsuba's 915."""
    return 4 * 21 * 2 * X * B, \
        B * MAD_MONT_KARATSUBA * (3 * (X - 1) + chain)


def batch_inv_step_work(kernel: str, lo: int, levels: int, B: int,
                        X: int) -> tuple:
    """(bytes, multiply-adds) of one launch of batch_inv_plan over (B, 21,
    X) (a "fold_mul_levels", "top" or "down" launch of `levels` levels
    from level lo): the lanes it reads and writes once each, at the
    Karatsuba's 915 a product, the top's Fermat chain included."""
    top = lo + levels
    widths = sum(X >> l for l in range(lo + 1, top + 1))    # levels above lo
    if kernel == "fold_mul_levels":
        lanes, products = (X >> lo) + widths, widths
    elif kernel == "down":
        lanes = (X >> top) + sum(X >> l for l in range(lo, top)) + (X >> lo)
        products = widths + (X >> lo) - (X >> top)
    else:
        lanes, products = 2 * (X >> lo), 3 * ((X >> lo) - 1) + INV_CHAIN_FQ
    return 4 * 21 * B * lanes, B * MAD_MONT_KARATSUBA * products


def fold2d_work(kind: str, B: int, m: int) -> tuple:
    """(bytes, multiply-adds) of one fold2d level over (rows, B*m): every
    input lane read and every output lane written once, B*m/2 cooperative
    adds (Karatsuba)."""
    rows = ec_lm.ROWS[kind]
    return 4 * rows * (B * m + B * m // 2), add_mads("padd", kind) * B * m // 2


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


# Spin kernels (torch.cuda._sleep) run at both ends of every profiling
# window.  On the card, after tens of thousands of launches in a process,
# torch.profiler loses the first kernel events of a window (seen: 2 to 9;
# never the last ones): the leading spins take that loss instead of the
# kernels timed, and how many of each group it recorded is reported.
SENTINELS = 64
# Windows in which the profiler traced nothing: how many device_reading
# profiles at most, and the pause before each retry.
EMPTY_WINDOWS = 8
EMPTY_PAUSE_S = 0.5


def kernel_events(fn, runs: int = 20) -> tuple:
    """([(name, device us)] of the CUDA kernel events torch.profiler
    recorded over `runs` calls of `fn`, (leading, trailing) spin kernels
    recorded of SENTINELS each).  Kernel durations only, so the host's
    time between launches is left out (it dominates a call of a few
    microseconds of device work); the spins are left out of the list."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    kept = [ev for ev in events if "spin_kernel" not in ev.name]
    first = min((ev.time_range.start for ev in kept), default=float("inf"))
    spins = [ev.time_range.start < first for ev in events
             if "spin_kernel" in ev.name]
    return [(ev.name, ev.device_time_total) for ev in kept], \
        (sum(spins), len(spins) - sum(spins))


def device_ms(fn, runs: int = 20) -> float:
    """Mean device milliseconds per call of `fn` (kernel_events)."""
    return sum(us for _, us in kernel_events(fn, runs)[0]) / runs / 1e3


def _torch_kernel(name: str) -> bool:
    """A device event of PyTorch's own (a kernel of at::, a copy or a
    fill), not one of the port's."""
    return "at::" in name or name.startswith(("Memcpy", "Memset"))


def burst_ms(fn, min_calls: int = 20, min_ms: float = 10.0) -> float:
    """ms per call over a burst of back-to-back calls between two CUDA
    events: at least `min_calls` calls and `min_ms` in all."""
    est = event_ms(fn, runs=3, warmup=1)
    calls = max(min_calls, int(min_ms / max(est, 1e-3)) + 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


@functools.lru_cache(maxsize=None)
def max_sm_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm): at it the
    integer ceiling is the lowest any run can reach."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def int_ceiling_ms(mads: float, sm_mhz: float) -> float:
    """Least ms for `mads` 32-bit multiply-adds at 64 a clock per SM."""
    return mads / (INT_MADS_PER_CLK_SM * SMS * sm_mhz * 1e6) * 1e3


def device_reading(name: str, fn, nbytes: float, mads: float,
                   runs: int = 20, attempts: int = 3) -> dict:
    """The device time of `fn` that a verdict may use, with what marks it
    impossible.  One call counts the port's launches (LAUNCHES); then
    kernel_events, again (at most `attempts` times) while the profiler
    recorded fewer of the port's kernel events than the port launched (a
    loss that the leading spins did not take: the sum of the rest reads
    low), or while it lost more than half of the leading spins (such a
    window once gave all 20 events of 20 calls summing to half the time
    the same calls took between CUDA events).  If events are still missing
    in an undisturbed window and every recorded event is a port kernel,
    the reading is their mean duration times the launches of a call
    (``"scaled": true``).  The reading is marked ``"invalid": true`` when
    it is 0, when it lies below the bytes bound (each input read and each
    output written once, `nbytes`, at 3.35 TB/s) or below the integer
    ceiling of `mads` at the card's highest SM clock, when events are
    missing and it could not be scaled, or when the window stayed
    disturbed.  Prints one JSON line: the reading beside the event-burst
    ms.

    A window in which the profiler recorded no device event at all, not
    even a spin, is a window it failed to trace (seen on the card: three
    such windows in a row, then whole ones again).  It is profiled again,
    EMPTY_PAUSE_S apart, at most EMPTY_WINDOWS times; if every window
    stays empty the reading is the event-burst ms (``"source":
    "cuda_events"``: the kernels' time with the host's gaps between
    launches, never less than their device time), else ``"source":
    "profiler"``."""
    from ..ops.cuda import lm_kernels as K

    before = sum(K.LAUNCHES.values())
    fn()
    launches = sum(K.LAUNCHES.values()) - before
    attempt = empty = 0
    while attempt < attempts or (empty and empty < EMPTY_WINDOWS):
        if empty:
            time.sleep(EMPTY_PAUSE_S)
        attempt += 1
        events, (lead, tail) = kernel_events(fn, runs)
        empty = empty + 1 if not events and lead + tail == 0 else 0
        ours = [us for n, us in events if not _torch_kernel(n)]
        disturbed = 2 * lead < SENTINELS
        if len(ours) >= launches * runs and not disturbed:
            break
    burst = burst_ms(fn)
    dev_ms = sum(us for _, us in events) / runs / 1e3
    short = len(ours) < launches * runs
    scaled = short and not disturbed and bool(ours) and \
        len(ours) == len(events)
    if scaled:
        dev_ms = sum(ours) / len(ours) * launches / 1e3
    if empty:
        dev_ms, short, disturbed = burst, False, False
    res = {"reading": name, "device_ms": dev_ms, "burst_ms": burst,
           "source": "cuda_events" if empty else "profiler",
           "kernel_events": len(ours), "launches": launches * runs,
           "torch_events": len(events) - len(ours),
           "sentinels": f"lead {lead}/{SENTINELS}, tail {tail}/{SENTINELS}",
           "attempts": attempt,
           "scaled": scaled, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "int_ceiling_ms": int_ceiling_ms(mads, max_sm_mhz())}
    why = [w for w, bad in (
        ("zero", dev_ms <= 0),
        ("below the bytes bound", dev_ms < res["bytes_ms"]),
        ("below the integer ceiling", dev_ms < res["int_ceiling_ms"]),
        ("events dropped", short and not scaled),
        ("window disturbed", disturbed)) if bad]
    res["invalid"] = bool(why)
    if why:
        res["why"] = why
    print(json.dumps(res), flush=True)
    return res


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


# The functions that fill a device-constant cache at first use (lm.const,
# ec_lm._identity_col, NTTPlan.on and DistNTTPlan.on): a proving step
# makes a tensor from host data nowhere else.
CONSTANT_CACHES = {"const", "_identity_col", "on"}


@contextlib.contextmanager
def host_tensors(record: list):
    """Records (torch function, caller) for every tensor made from host
    data (not from a tensor) through torch.as_tensor, torch.tensor or
    torch.from_numpy, and every item assignment of host data into a
    tensor (a copy from the host on the card).  Such a copy inside a step
    breaks its capture as a CUDA graph, so a step run under this records
    callers in CONSTANT_CACHES at most."""
    names = ("as_tensor", "tensor", "from_numpy")
    originals = {name: getattr(torch, name) for name in names}
    setitem = torch.Tensor.__setitem__

    def wrap(name, fn):
        def made(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                record.append((name, sys._getframe(1).f_code.co_name))
            return fn(data, *args, **kwargs)
        return made

    def assign(self, index, value):
        if not isinstance(value, torch.Tensor):
            record.append(("__setitem__", sys._getframe(1).f_code.co_name))
        return setitem(self, index, value)

    for name, fn in originals.items():
        setattr(torch, name, wrap(name, fn))
    torch.Tensor.__setitem__ = assign
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(torch, name, fn)
        torch.Tensor.__setitem__ = setitem


def smt_inputs(L: int, T: int, depths, seed: int, device="cpu"):
    """Inputs of lm_kernels.smt_chain for len(depths) // T trees of T
    voters at L levels, lane g of depth depths[g]: (bits (254, T),
    siblings plain and Montgomery (L, 21, n T), leaves (21, n T), their
    traces (264, 21, n T)).  Below a lane's last nonzero sibling (at d - 1)
    a sibling is nonzero four times in five, so zero siblings under
    nonzero ones come up too."""
    import numpy as np

    from ..ops import ff, lm
    from ..ops.cuda import lm_kernels as K

    rng = np.random.default_rng(seed)
    nT = len(depths)

    def elements(shape):
        vals = [int.from_bytes(rng.bytes(32), "big") % ff.P_FR
                for _ in range(int(np.prod(shape)))]
        return lm.ints_to_lm(vals).T.reshape(*shape, lm.N_LIMBS)

    sib = np.zeros((L, nT, lm.N_LIMBS), dtype=np.int32)
    for g, d in enumerate(depths):
        for i in range(d):
            if i == d - 1 or rng.random() < 0.8:
                sib[i, g] = elements((1,))[0]
    sib_plain = torch.as_tensor(sib.transpose(0, 2, 1).copy(), device=device)
    bits = torch.as_tensor(rng.integers(0, 2, (254, T)).astype(np.int32),
                           device=device)
    leaf_in = torch.as_tensor(elements((3, nT)).transpose(0, 2, 1).copy(),
                              device=device)
    leaf, leaf_tr = K.poseidon_trace(lm.to_mont(leaf_in))
    return bits, sib_plain, lm.to_mont(sib_plain), leaf, leaf_tr


def deep_pair_batch(n_levels: int, n_voters: int, shared_bits: int,
                    seed: int, device=None) -> list:
    """n_voters voters in one census and one SIK tree
    (inputs.shared_trees_batch) from random addresses, of which voters 0
    and 1 differ only in path bit `shared_bits`: their leaves lie at depth
    shared_bits + 1 in both trees (below the provers' cut depth where that
    is larger).  Signatures are random bytes: the circuit reads a
    signature only as a field element."""
    import random

    from .. import inputs as inp

    rng = random.Random(seed)
    addrs = [bytearray(rng.randbytes(20)) for _ in range(n_voters)]
    addrs[1] = bytearray(addrs[0])
    addrs[1][shared_bits // 8] ^= 1 << (shared_bits % 8)
    return inp.shared_trees_batch(
        [(bytes(a), rng.randbytes(64)) for a in addrs], n_levels,
        device=device)

"""fold_padd and fold_padd_aa (G1 and G2) at the widths the MSM sum tree
launches them with, and fold_padd_aa through the sort's index at the
shapes the MSM launches it with at nlevels=160.

At batch 128 every window of the main path folds planes of G*B = 128
rows: ``fold_padd_aa`` once per chunk (output widths 16384, 4096 and 1024
for G1, 4096 for G2), then ``fold_padd`` level by level down to width 128
(``ops/msm_lm.py`` ``upsweep``).  ``SHAPES`` lists each one-level launch
by its output width h; ``LEVELS`` lists the several-level launches that
``lm_kernels.fold_plan`` makes of the same trees (input width 2h, n
levels, outputs h, h/2, ..., h/2^(n-1)) at B = 128 and at the stream
tail's 32 and 64, and three that it does not make (three levels from
8192, 4096 and 1024): ``FOLD_WIDE`` rests on them.  Every plane mixes
real points with identity, doubling and P + (-P) lanes, and the affine
planes carry infinity-flagged lanes.  ``GATHERED`` lists the main path's
level 0 at nlevels=160, batch 16 (``fold_padd_aa`` reading a chunk's
[P | -P] rows through each lane's index); each of those lines also times
the same adds on the plane the index gathers (``plane_*``).

Each shape is first held against its plain version (``torch.equal``);
then, on the card only, one JSON line per shape gives the median
milliseconds of a whole call (CUDA events, host time included), the mean
device time per call (torch.profiler, through ``tools.device_reading``,
which marks a reading no card can give ``"invalid"``), the time per call
of a burst of back-to-back calls between two CUDA events (at least 20
calls and 10 ms),
ns per add, and the bounds: multiply-adds at 67 T op/s (a multiply-add
counted as two, the data sheet's 32-bit rate) and the integer ceiling, 64
multiply-adds per clock per SM at the SM clock read right after the
shape; and the host's own time for a call (``host_ms``: until the
wrapper returns, before the card is waited for), which is what a call
costs a step whose device waits on the host.  A LEVELS line also times
the same levels as n one-level calls (``apart_ms``, ``apart_device_ms``,
``apart_host_ms``): what the several-level launch saves or costs.

    python -m zkfranchise_tpu_torch.tools.fold_shapes [--device cpu] [--small]
"""
from __future__ import annotations

import collections
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import ec, ec_affine, ec_lm, msm_lm
from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import HBM_BYTES_PER_S, INT_MADS_PER_CLK_SM, OPS_PER_S, SMS, \
    add_mads, check, cli, device_reading, event_ms, verdict
from .padd_shapes import smi

# (form, kind, B, h): one level, output width h
SHAPES = ([("fold", "g1", 128, h) for h in (8192, 4096, 2048, 1024, 512,
                                            256, 128)] +
          [("fold", "g2", 128, h) for h in (2048, 1024, 512, 256, 128)] +
          [("aa", "g1", 128, h) for h in (16384, 4096, 1024)] +
          [("aa", "g2", 128, 4096), ("fold", "g1", 32, 128),
           ("fold", "g2", 32, 128)])
# (kind, B, h, n): n levels in one launch, first output width h
LEVELS = [("g1", B, h, n) for B in (128, 64, 32)
          for h, n in ((2048, 3), (512, 3), (256, 2))] + \
    [("g1", 128, 8192, 3), ("g1", 128, 4096, 3), ("g1", 128, 1024, 3)]
# lanes a plain version takes at once: it holds many temporaries of its
# input's size, so a wide plane goes through it a few batch rows (or
# lanes) at a time, which gives the same result
PLAIN_LANES = 1 << 20
# (kind, B, h): fold_padd_aa through the index at nlevels=160, batch 16:
# G*B lanes, output width h, for A's chunks of 65,536 and 16,384 points,
# B1's and B2's of 65,536 (G = 8) and C's of 262,144 (G = 2)
GATHERED = [("g1", 128, 32768), ("g1", 128, 8192), ("g2", 128, 32768),
            ("g1", 32, 131072)]
SMALL_GATHERED = [("g1", 4, 16), ("g2", 2, 8), ("g1", 1, 33)]
SMALL_SHAPES = [("fold", "g1", 4, 16), ("fold", "g2", 2, 8),
                ("aa", "g1", 4, 16), ("aa", "g2", 2, 8),
                ("fold", "g1", 1, 33), ("aa", "g2", 1, 33)]
SMALL_LEVELS = [("g1", 2, 16, 3), ("g2", 2, 8, 2), ("g1", 1, 4, 3)]


def fold_inputs(form: str, kind: str, B: int, m: int, rng, dev):
    """(B, rows, m) projective plane (form "fold") or (B, arows, m) affine
    plane (form "aa") from a pool of real points.  Of the m/2 pairs
    (j, j + m/2) a quarter are special: P + (-P), doublings, and an
    identity (an infinity flag) on the left or on the right."""
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    pool = [mul(int(k)) for k in rng.integers(1, 1 << 60, size=32)]
    h = m // 2
    idx = torch.as_tensor(rng.integers(0, len(pool), size=(2, B * m)),
                          device=dev)
    if form == "aa":
        table = torch.as_tensor(ec_affine.affine_table(pool, kind).T,
                                device=dev)
        x = table[:, idx[0]]
    else:
        table = torch.as_tensor((ec_lm.g1_table if kind == "g1"
                                 else ec_lm.g2_table)(pool).T, device=dev)
        x = torch.cat([K.padd_ref(table[:, i], table[:, j], kind)  # Z != 1
                       for i, j in zip(idx[0].split(PLAIN_LANES),
                                       idx[1].split(PLAIN_LANES))], -1)
    x = x.reshape(-1, B, m).permute(1, 0, 2).contiguous()
    special = torch.as_tensor(rng.permutation(h)[:4 * max(1, h // 16)],
                              device=dev)
    neg, dbl, idl, idr = special.chunk(4) if h >= 4 else (special,) * 4
    if form == "aa":
        x[..., h + neg] = ec_affine.neg_affine(x[..., neg], kind)
        ident = torch.as_tensor(ec_affine.identity_rows(kind, 1).T,
                                device=dev)
    else:
        x[..., h + neg] = msm_lm._neg_plane(x[..., neg], kind)
        ident = ec_lm.identity_plane(kind, (), 1, dev)
    x[..., h + dbl] = x[..., dbl]
    x[..., idl] = ident
    x[..., h + idr] = ident
    return x


def fold_at_inputs(kind: str, B: int, m: int, rng, dev):
    """A chunk's [P | -P] rows (2m, arows) (msm_lm.extend_table of m
    points drawn from a pool of real points, a sixteenth of them the
    identity) and idx (B, m) int32: each lane takes the m points in an
    order of its own, each with a random sign (row j or m + j).  Pool
    points repeat, so doublings and P + (-P) pairs are among the adds."""
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    pool = [mul(int(k)) for k in rng.integers(1, 1 << 60, size=32)]
    table = torch.as_tensor(ec_affine.affine_table(pool, kind), device=dev)[
        torch.as_tensor(rng.integers(0, len(pool), size=m), device=dev)]
    table[torch.as_tensor(rng.permutation(m)[:max(1, m // 16)],
                          device=dev)] = torch.as_tensor(
        ec_affine.identity_rows(kind, 1), device=dev)
    order = rng.permuted(np.tile(np.arange(m, dtype=np.int32), (B, 1)),
                         axis=1)
    sign = rng.integers(0, 2, size=(B, m), dtype=np.int32)
    return msm_lm.extend_table(table, kind), \
        torch.as_tensor(order + m * sign, device=dev)


def plain_by_rows(ref, x, kind: str, *args):
    """ref(x, kind, *args) for x (B, rows, m), a few batch rows at a time
    (PLAIN_LANES lanes at most); ref returns a plane or a list of them."""
    step = max(1, PLAIN_LANES // x.shape[-1])
    parts = [ref(x[b:b + step], kind, *args)
             for b in range(0, x.shape[0], step)]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts, 0)
    return [torch.cat(level, 0) for level in zip(*parts)]


def levels_apart(x, kind: str, n: int) -> list:
    """The n levels as n one-level launches."""
    out = []
    for _ in range(n):
        x = K.fold_padd(x, kind)
        out.append(x)
    return out


def bounds(form: str, kind: str, adds: int, in_ints: int, out_ints: int,
           sm_mhz: float | None) -> dict:
    bytes_ms = 4 * (in_ints + out_ints) / HBM_BYTES_PER_S * 1e3
    mads = add_mads("padd" if form == "fold" else "padd_aa", kind) * adds
    ops_ms = 2 * mads / OPS_PER_S * 1e3
    out = {"bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if sm_mhz:
        out["int_ceiling_ms"] = mads / (
            INT_MADS_PER_CLK_SM * SMS * sm_mhz * 1e6) * 1e3
    return out


def host_ms(fn, runs: int = 10) -> float:
    """Median host milliseconds from calling `fn` to its return, the card
    idle at the call and waited for after it."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _time(res: dict, name: str, fn, form: str, kind: str, adds: int,
          in_ints: int, out_ints: int) -> None:
    res["ms"] = event_ms(fn)
    mads = add_mads("padd" if form == "fold" else "padd_aa", kind) * adds
    r = device_reading(name, fn, 4 * (in_ints + out_ints), mads)
    res.update(device_ms=r["device_ms"], burst_ms=r["burst_ms"],
               invalid=r["invalid"])
    res["host_ms"] = host_ms(fn)
    res["profiler_vs_events"] = res["device_ms"] / res["burst_ms"]
    res["ns_per_add"] = res["device_ms"] * 1e6 / adds
    sm_mhz = float(smi("clocks.sm").split()[0])
    res.update(bounds(form, kind, adds, in_ints, out_ints, sm_mhz),
               sm_mhz=sm_mhz)


def run(dev, shapes, levels, failed: list, timed: bool = True) -> list:
    """Each shape and several-level launch held against its plain version
    (a failure is appended to `failed`), then timed on the card unless
    `timed` is False; one JSON line each."""
    timed = timed and dev.type == "cuda"
    rng = np.random.default_rng(5)
    results = []
    for form, kind, B, h in shapes:
        rows = ec_lm.ROWS[kind]
        x = fold_inputs(form, kind, B, 2 * h, rng, dev)
        fn = K.fold_padd if form == "fold" else K.fold_padd_aa
        ref = K.fold_padd_ref if form == "fold" else K.fold_padd_aa_ref
        tag = f"fold_padd{'_aa' if form == 'aa' else ''}/{kind} " \
              f"({B},{x.shape[1]},{2 * h}) -> h {h}"
        check(failed, tag, torch.equal(fn(x, kind),
                                       plain_by_rows(ref, x, kind)))
        res = {"form": form, "kind": kind, "B": B, "h": h, "levels": 1,
               "adds": B * h}
        if timed:
            _time(res, tag, lambda: fn(x, kind), form, kind, B * h,
                  x.numel(), B * rows * h)
        print(json.dumps(res), flush=True)
        results.append(res)
        del x
    for kind, B, h, n in levels:
        rows = ec_lm.ROWS[kind]
        x = fold_inputs("fold", kind, B, 2 * h, rng, dev)
        got = K.fold_padd_levels(x, kind, n)
        want = plain_by_rows(K.fold_padd_levels_ref, x, kind, n)
        tag = f"fold_padd_levels/{kind} ({B},{rows},{2 * h}) n {n}"
        check(failed, tag, len(got) == n and all(
            torch.equal(g, w) for g, w in zip(got, want)))
        adds = B * sum(h >> i for i in range(n))
        res = {"form": "levels", "kind": kind, "B": B, "h": h, "levels": n,
               "adds": adds}
        if timed:
            _time(res, tag, lambda: K.fold_padd_levels(x, kind, n),
                  "fold", kind, adds, x.numel(), rows * adds)
            res["apart_ms"] = event_ms(lambda: levels_apart(x, kind, n))
            r = device_reading(tag + " apart", lambda: levels_apart(x, kind, n),
                               4 * (x.numel() + rows * adds),
                               add_mads("padd", kind) * adds)
            res.update(apart_device_ms=r["device_ms"],
                       apart_invalid=r["invalid"])
            res["apart_host_ms"] = host_ms(lambda: levels_apart(x, kind, n))
        print(json.dumps(res), flush=True)
        results.append(res)
        del x, got, want
    return results


def run_gathered(dev, shapes, failed: list, timed: bool = True) -> list:
    """fold_padd_aa through the index at each (kind, B, h) of `shapes`,
    held against the plain version on the plane the index gathers, then
    timed on the card unless `timed` is False, beside fold_padd_aa on that
    plane; one JSON line each."""
    timed = timed and dev.type == "cuda"
    rng = np.random.default_rng(6)
    results = []
    for kind, B, h in shapes:
        rows = ec_lm.ROWS[kind]
        table, idx = fold_at_inputs(kind, B, 2 * h, rng, dev)
        plane = table[idx.long()].transpose(-1, -2).contiguous()
        tag = f"fold_padd_aa/{kind} table ({table.shape[0]}," \
              f"{table.shape[1]}) at ({B},{2 * h}) -> h {h}"
        check(failed, tag, torch.equal(
            K.fold_padd_aa(table, kind, idx=idx),
            plain_by_rows(K.fold_padd_aa_ref, plane, kind)))
        res = {"form": "aa_at", "kind": kind, "B": B, "h": h, "levels": 1,
               "adds": B * h}
        if timed:
            _time(res, tag, lambda: K.fold_padd_aa(table, kind, idx=idx),
                  "aa", kind, B * h, plane.numel(), B * rows * h)
            plane_res: dict = {}
            _time(plane_res, tag + " plane",
                  lambda: K.fold_padd_aa(plane, kind), "aa", kind, B * h,
                  plane.numel(), B * rows * h)
            res.update({f"plane_{k}": plane_res[k] for k in
                        ("ms", "device_ms", "invalid", "host_ms")})
        print(json.dumps(res), flush=True)
        results.append(res)
        del table, idx, plane
    return results


def _cuobjdump() -> str | None:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if pathlib.Path(path).exists():
        return path
    try:
        import triton
    except ImportError:
        return None
    path = pathlib.Path(triton.__file__).parent / "backends" / "nvidia" / \
        "bin" / "cuobjdump"
    return str(path) if path.exists() else None


def sass_mix(library) -> dict:
    """Static SASS instruction counts per function of a built library:
    {function: {"instructions": n, "IMAD": n, "IMAD_other": n, "top":
    {opcode: n}}}: "IMAD" the plain 32-bit multiply-adds (the products),
    "IMAD_other" the moves, shifts, adds and wide address products that
    the compiler also issues to the multiply-add pipe (IMAD.MOV, .SHL,
    .IADD, .WIDE, ...)."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    return parse_sass(subprocess.run(
        [tool, "-sass", str(library)], capture_output=True, text=True,
        check=True).stdout)


def parse_sass(text: str) -> dict:
    """sass_mix of a ``cuobjdump -sass`` listing."""
    mix, func = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            func = mix.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and func is not None:
            parts = m.group(1).split(".")
            func[".".join(parts[:2]) if parts[0] == "IMAD" else
                 parts[0]] += 1
    return {name: {"instructions": sum(c.values()), "IMAD": c["IMAD"],
                   "IMAD_other": sum(v for k, v in c.items()
                                     if k.startswith("IMAD.")),
                   "top": dict(c.most_common(10))}
            for name, c in mix.items()}


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    failed: list = []
    if dev.type == "cuda":
        print(smi("name,power.limit"), flush=True)
        lib = K.build()["lm_kernels"]
        print(json.dumps({"sass_mix": sass_mix(lib)}), flush=True)
    run(dev, SMALL_SHAPES if small else SHAPES,
        SMALL_LEVELS if small else LEVELS, failed)
    run_gathered(dev, SMALL_GATHERED if small else GATHERED, failed)
    if dev.type != "cuda":
        print("no card: nothing timed")
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

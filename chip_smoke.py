#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``zkfranchise_tpu_torch/csrc`` and then:

  1. prints the toolchain, the card, the build time and each kernel's
     registers and spills (from ``nvcc -Xptxas -v``);
  2. holds every kernel against its plain PyTorch version on the card at
     the main path's shapes, with exact equality (all arithmetic is
     integer), and times both with CUDA events;
  3. drives the main path at nlevels=16, batch 128: CensusCircuit(16),
     dev setup, mock_batch(16, 128, seed=7) -> batch_to_arrays ->
     DeviceProver -> prove_batch(seed=1), then a second timed prove_arrays
     with per-stage seconds, proofs/s and peak device memory; checks that
     all four kernels were launched on that path, and verifies sampled
     proofs against the committed dev/16 verification key (a cross-voter
     check and a tampered signal must be rejected).

Every phase prints JSON lines.  The last line is
{"ok": true, "device": {...}}; any failure exits non-zero before it.
It imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the 32-bit
# non-tensor rate (67 T op/s float32; int32 multiply-adds do not run
# faster on Hopper), counting a multiply-add as two operations
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# multiply-adds per element: wide (21x21), low (triangular 21), reduce
MAD_WIDE, MAD_LOW = 441, 231
MAD_RED = MAD_LOW + MAD_WIDE
MAD_MONT = MAD_WIDE + MAD_RED                           # 1113
MAD_FQ2 = 4 * MAD_WIDE + 2 * MAD_RED                    # lazy Fq2 product
MADS = {
    ("padd", "g1"): 8 * MAD_MONT + 6 * MAD_WIDE + 3 * MAD_RED,      # 13566
    ("padd", "g2"): 8 * MAD_FQ2 + 24 * MAD_WIDE + 6 * MAD_RED,      # 39480
    ("padd_aa", "g1"): 4 * MAD_MONT + 6 * MAD_WIDE + 3 * MAD_RED,   # 9114
    ("padd_aa", "g2"): 4 * MAD_FQ2 + 24 * MAD_WIDE + 6 * MAD_RED,   # 27048
}
SOURCE = "zkfranchise_tpu_torch/csrc/lm_kernels.cu"
REPLACES = {
    "mont_mul": "zkfranchise_tpu/ops/pallas/lm_kernels.py:217",
    "padd": "zkfranchise_tpu/ops/pallas/lm_kernels.py:89",
    "fold_padd": "zkfranchise_tpu/ops/pallas/lm_kernels.py:122",
    "fold_padd_aa": "zkfranchise_tpu/ops/pallas/lm_kernels.py:163",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, mads: float) -> tuple[float, str]:
    """Least time in ms for this work on the card, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * mads / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, runs: int = 10, warmup: int = 2) -> float:
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


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# phase 1: toolchain, card, build
# ---------------------------------------------------------------------------

def phase_toolchain(torch, K) -> None:
    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    # the host library the dev setup needs; built without OpenMP, whose
    # runtime the GPU machine's default compiler lacks (its two parallel
    # loops then run on one thread)
    native = subprocess.run(
        ["make", "-C", str(ROOT / "native"), "CXX=g++",
         "CXXFLAGS=-O3 -fPIC -shared -std=c++17 -march=native"],
        capture_output=True, text=True)
    if native.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{native.stderr[-2000:]}")
    t0 = time.perf_counter()
    lib = K.build()
    K._lib()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text() if \
        lib.with_suffix(".log").exists() else ""
    resources = {}
    func = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r"Function properties for (\w+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            resources.setdefault(func, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and func:
            resources.setdefault(func, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
    emit({"phase": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1], "nvidia_smi": smi_line(),
          "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s, "library": lib.name,
          "ptxas": resources})


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------

def _random_limbs(np, rng, shape):
    """Normalized limbs of values < 2^254 (what the path feeds mont_mul)."""
    x = rng.integers(0, 1 << 13, size=shape, dtype=np.int32)
    x[..., 19, :] &= 0x7F
    x[..., 20, :] = 0
    return x


def _point_inputs(np, torch, rng, kind, B, m, dev):
    """(p, q) projective planes (B, rows, m) and an affine plane
    (B, arows, m), drawn from a pool of real points, with identity lanes,
    doubling lanes and P + (-P) lanes mixed in."""
    from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, msm_lm
    from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    pool = [mul(int(k)) for k in rng.integers(1, 1 << 60, size=48)]
    proj = torch.as_tensor((ec_lm.g1_table if kind == "g1"
                            else ec_lm.g2_table)(pool).T, device=dev)
    aff = torch.as_tensor(ec_affine.affine_table(pool, kind).T, device=dev)

    def pick(table):
        idx = torch.as_tensor(rng.integers(0, len(pool), size=(B, m)),
                              device=dev)
        return table[:, idx].permute(1, 0, 2).contiguous()

    # sums of two pool points: projective with Z != 1 and redundant limbs
    p = K.padd_ref(pick(proj), pick(proj), kind)
    q = K.padd_ref(pick(proj), pick(proj), kind)
    lanes = torch.as_tensor(rng.permutation(m)[:4 * (m // 16)], device=dev)
    neg, dbl, idp, idq = lanes.chunk(4)
    q[..., neg] = msm_lm._neg_plane(p[..., neg], kind)
    q[..., dbl] = p[..., dbl]
    ident = ec_lm.identity_plane(kind, (B,), 1, dev)
    p[..., idp] = ident
    q[..., idq] = ident
    a = pick(aff)
    h = m // 2
    a[..., h + neg[neg < h]] = ec_affine.neg_affine(a[..., neg[neg < h]],
                                                    kind)
    a[..., h + dbl[dbl < h]] = a[..., dbl[dbl < h]]
    inf = ec_affine.identity_rows(kind, 1).T
    a[..., idp] = torch.as_tensor(inf, device=dev)
    return p, q, a


def phase_kernels(np, torch, K, dev) -> dict:
    from zkfranchise_tpu_torch.ops import ec_affine, ec_lm, lm

    rng = np.random.default_rng(2024)
    results, table = {}, {}

    def check(name, kernel, plain, nbytes, mads, key):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.long() - want.long()).abs().max().item())
        ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain)
        b_ms, b_by = bound(nbytes, mads)
        results[name] = {"equal": equal, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms}
        if key is not None:
            table[key] = {"shape": name, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
        if not equal:
            raise AssertionError(f"{name}: kernel differs from plain version "
                                 f"(max abs err {err})")

    for fs, fname in ((lm.FR, "fr"), (lm.FQ, "fq")):
        for n, bl in ((8192, 1), (4096, 128)):
            a = torch.as_tensor(_random_limbs(np, rng, (n, 21, 128)),
                                device=dev)
            b = torch.as_tensor(_random_limbs(np, rng, (n, 21, bl)),
                                device=dev)
            name = f"mont_mul/{fname}/{n}x21x128*{n}x21x{bl}"
            nbytes = 4 * (a.numel() + b.numel() + a.numel())
            check(name, lambda: K.mont_mul(a, b, fs),
                  lambda: K.mont_mul_ref(a, b, fs), nbytes,
                  MAD_MONT * a.numel() / 21,
                  "mont_mul" if (fname, bl) == ("fr", 1) else None)

    B, m = 128, 2048
    for kind in ("g1", "g2"):
        rows, arows = ec_lm.ROWS[kind], ec_affine.AROWS[kind]
        p, q, a = _point_inputs(np, torch, rng, kind, B, m, dev)
        key = (lambda k: k) if kind == "g1" else (lambda k: None)
        check(f"padd/{kind}/{B}x{rows}x{m}", lambda: K.padd(p, q, kind),
              lambda: K.padd_ref(p, q, kind), 4 * 3 * rows * B * m,
              MADS[("padd", kind)] * B * m, key("padd"))
        x = torch.cat([p[..., :m // 2], q[..., :m // 2]], -1).contiguous()
        check(f"fold_padd/{kind}/{B}x{rows}x{m}",
              lambda: K.fold_padd(x, kind),
              lambda: K.fold_padd_ref(x, kind),
              4 * (rows * m + rows * m // 2) * B,
              MADS[("padd", kind)] * B * m // 2, key("fold_padd"))
        check(f"fold_padd_aa/{kind}/{B}x{arows}x{m}",
              lambda: K.fold_padd_aa(a, kind),
              lambda: K.fold_padd_aa_ref(a, kind),
              4 * (arows * m + rows * m // 2) * B,
              MADS[("padd_aa", kind)] * B * m // 2, key("fold_padd_aa"))
        del p, q, a, x
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernels": results})
    return table


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

N_LEVELS, BATCH = 16, 128


def phase_main_path(np, torch, K, dev) -> dict:
    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit
    from zkfranchise_tpu_torch.ops import lm
    from zkfranchise_tpu_torch.utils import native

    if not native.available():
        raise RuntimeError("native/build/libzkhost.so is missing and did not "
                           "build: dev setup would take the pure-Python path")
    t0 = time.perf_counter()
    circuit = CensusCircuit(N_LEVELS)
    cs = circuit.cs
    pk, vk = gsetup.dev_setup(cs)
    vk_path = ROOT / "artifacts" / "zkCensus" / "dev" / str(N_LEVELS) / \
        "verification_key.json"
    vk_committed = json.loads(vk_path.read_text())
    setup_s = time.perf_counter() - t0
    emit({"phase": "setup", "nlevels": N_LEVELS, "wires": cs.num_vars,
          "constraints": cs.num_constraints, "domain": pk.domain,
          "libzkhost_used": native.available(), "setup_s": setup_s,
          "vk_equals_committed": vk.to_dict() == vk_committed})
    if vk.to_dict() != vk_committed:
        raise AssertionError("dev setup vk differs from the committed vk")
    vk = gverify.VerifyingKey(vk_committed)

    # the main path: counts start at 0 here and are read right after
    K.reset_launches()
    t0 = time.perf_counter()
    batch = inp.mock_batch(N_LEVELS, BATCH, seed=7, device=dev)
    arrs = inp.batch_to_arrays(batch, N_LEVELS)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover = DeviceProver(circuit, pk, device=dev)
    prover_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proofs, pubs = prover.prove_batch(arrs, seed=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    emit({"phase": "main_path", "inputs_s": inputs_s,
          "prover_init_s": prover_init_s, "first_prove_batch_s": first_s,
          "proofs": len(proofs), "launches": launches})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # second, timed run: per-stage seconds, launches per prove_arrays
    rng = np.random.default_rng(2)
    r, s = (torch.as_tensor(lm.ints_to_lm(
        [int.from_bytes(rng.bytes(31), "big") % lm.FR.p
         for _ in range(BATCH)]), device=dev) for _ in range(2))
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    stages = {}
    t0 = time.perf_counter()
    planes = prover.prove_arrays(arrs, r, s, stage_seconds=stages)
    t1 = time.perf_counter()
    proofs2, pubs2 = prover.finalize(*planes)
    stages["finalize"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    emit({"phase": "timed_prove", "nvidia_smi": smi_line(),
          "stage_seconds": stages, "total_s": total,
          "proofs_per_s": BATCH / total,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "launches_per_prove_arrays": dict(K.LAUNCHES)})

    # correctness by the repo's own means: the pairing verifier
    sample = [0, 42, 85, BATCH - 1]
    ok = {f"voter_{i}": gverify.verify(vk, proofs[i], pubs[i])
          for i in sample}
    ok["second_run_voter_0"] = gverify.verify(vk, proofs2[0], pubs2[0])
    cross = gverify.verify(vk, proofs[0], pubs[1])
    tampered_pub = list(pubs[0])
    tampered_pub[2] = (tampered_pub[2] + 1) % lm.FR.p
    tampered = gverify.verify(vk, proofs[0], tampered_pub)
    emit({"phase": "verify", "accepted": ok, "cross_voter_accepted": cross,
          "tampered_accepted": tampered})
    if not all(ok.values()) or cross or tampered:
        raise AssertionError("proof verification failed")
    phase_profile(torch, prover, arrs, r, s, stages)
    return launches


def phase_profile(torch, prover, arrs, r, s, stages) -> None:
    """One more prove_arrays under torch.profiler: device busy time per
    kernel name, and the device's idle share of the UNPROFILED step (the
    timed run's stages up to assemble; the profiler's own overhead
    inflates the profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prover.prove_arrays(arrs, r, s)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + ev.device_time_total
    busy_s = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    step_s = sum(v for k, v in stages.items() if k != "finalize")
    emit({"phase": "profile", "profiled_wall_s": wall_s,
          "device_busy_s": busy_s, "unprofiled_step_s": step_s,
          "device_idle_share": 1 - busy_s / step_s,
          "device_events": sum(1 for ev in prof.events()
                               if ev.device_type ==
                               torch.autograd.DeviceType.CUDA),
          "top_kernels_s": {k: v / 1e6 for k, v in top}})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "zkfranchise_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the zkfranchise_tpu_torch package is missing",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

    dev = torch.device("cuda", 0)
    phase_toolchain(torch, K)
    table = phase_kernels(np, torch, K, dev)
    launches = phase_main_path(np, torch, K, dev)
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    library_ms=None, **table[name])
               for name in ("mont_mul", "padd", "fold_padd", "fold_padd_aa")]
    print(smi_line())
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

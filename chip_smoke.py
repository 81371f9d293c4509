#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``zkfranchise_tpu_torch/csrc`` and then:

  1. prints the toolchain, the card, the build time, each kernel's
     registers and spills (from ``nvcc -Xptxas -v``; a cooperative add,
     the scalar_mul ladder, the Poseidon kernel, mont_mul, ntt_level, inv,
     mm2d, mont_chain or a batch_inv kernel that spills fails the run),
     the resident blocks per SM of the cooperative kernels and the SASS
     instruction mix of those kernels;
  2. holds every kernel against its plain PyTorch version on the card at
     the shapes its path gives it (mont_mul at its operand patterns,
     ntt_level at every level of the forward and inverse 2^14 schedules
     with 128 and 4 lanes (each level's device time at 128), inv at 1, 128 and
     129 lanes beside a mont_chain of as many products, batch_inv at
     (128, 21, 16384) launch by launch and as a whole, and at every width
     2^0 .. 2^14 the affine tree calls it with, padd at the five
     plane shapes of
     tools.padd_shapes, the folds at every width of the sum tree (level
     0 read through the sort's index, as the MSM launches it) and at
     every several-level launch of its plan, tools.fold_shapes, the
     Poseidon permutation at widths 3, 4, 5 with 128 and 4 lanes, the
     scalar_mul ladder with a scalar per lane and one for all), with
     exact equality (all arithmetic is integer), and times both: whole
     calls with CUDA events, and the kernel's own device time with
     torch.profiler through tools.device_reading, which marks a reading
     no card can give; the two ladders beside their critical-path
     yardsticks (a mont_chain of as many dependent products, 254 padd
     launches);
  3. folds a G1 affine plane of (128, 43, 32768) and a G2 plane of
     (128, 85, 8192) to width 1 with ec_affine.fold_affine (one batch
     inversion per level: fold_mul_levels, batch_inv_top and
     batch_inv_down, and mont_mul for the fold's own products) and
     holds all 128 totals against the projective tree (fold_padd_aa, then
     fold_padd), with seconds per tree for both routes;
  4. runs the three tools (tools.verify_kernels, tools.verify_lm,
     tools.micro_montmul) on the card against the host bigint oracle;
  5. runs the two layout experiments (tools.layout_expt,
     tools.layout_expt2) on the card at full size: every geometry held
     against its plain version, then timed;
  6. drives the main path at nlevels=16, batch 128: CensusCircuit(16),
     dev setup, mock_batch(16, 128, seed=7) -> batch_to_arrays ->
     DeviceProver -> prove_batch(seed=1), then a second timed prove_arrays
     with per-stage seconds, proofs/s and peak device memory (and the
     launches of mont_mul, padd and the folds by shape, the folds'
     held against the count from the MSM plan), verifies
     sampled proofs against the committed dev/16 verification key (a
     cross-voter check and a tampered signal must be rejected), and
     profiles one more prove_arrays: device busy time by kernel and the
     host's PyTorch ops and launch calls, of the step and of its
     witness;
  7. captures the main path's prover as one CUDA graph at batch 128
     (groth16.device.FusedStep, the counterpart of the JAX package's
     fused_step): prints the warm-up, capture and instantiation seconds,
     the graph's nodes by type and its launches by kernel, which must equal
     one prove_arrays'; the replay's planes must equal prove_arrays' for
     two (r, s) pairs, the first replay's clones must survive the second,
     sampled proofs through the graph must verify and a cross-voter and a
     tampered one be rejected; times eager prove_arrays and the replay in
     turns (eager, replay, replay, eager, two rounds; wall and CUDA-event
     seconds), profiles one replay, prints the memory with the graph alive
     and tools.bench's JSON line taken on the same prover; the allocator
     after two eager steps and at the capture's four points (before and
     after the warm-up, after the capture, after the instantiation):
     memory_stats' totals and peaks, and the segments by memory pool and
     stream with their blocks' bytes by state;
  8. drives the serving path at the same width: the dev key is exported
     as a producer-ordered snarkjs zkey, written to bytes, read back and
     ingested (A and B matrices only), and a DeviceProver keyed from it
     alone serves mock_batch(16, 300, seed=7) through ProofStream at
     batch 128 with a crash injected after the second batch (cursor 256)
     and a resume over the tail slices 32, 8, 4, every slice replayed on
     a captured step (groth16.device.ReplayProver: 128, 32, 8 and 4 each
     captured once into one shared pool, each capture's launches equal to
     one prove_arrays' at its size); then the same stream on the eager
     prover, whose files must equal the captured stream's byte for byte;
     sampled proof files verify against the committed dev/16 key; prints
     each capture's seconds, nodes and pool bytes, the peaks, and each
     stream's seconds and proofs/s by slice and over the 300 voters;
  9. drives the trusted-setup path at the same width (phase ceremony):
     a dev powers-of-tau transcript of power 15 on the host (with a timed
     native EC-iNTT stage, the yardstick of the host route),
     ceremony.pk_from_ptau on the card (EC-iNTTs and wire sums on
     scalar_mul and padd) equal to the main path's dev_setup key point for
     point and its vk to the committed one, a phase-1 chain (two
     contributions and a beacon) verified with and without the
     intermediate transcripts and a reordered one rejected, a key from the
     contributed transcript and a phase-2 chain on it, verified; a prover
     keyed from the final key proves mock_batch(16, 128, seed=7), sampled
     proofs verify under the contributed vk and fail under the earlier
     ones; tools.compile_circuit and tools.client_prove run at nlevels=4
     into a temporary directory with artifacts/ unchanged; then scalar_mul
     at the path's widths (8,192 to 165,476 lanes), device ms and bound;
 10. drives the sharded prover at the same width (phase sharded): the
     main path's key saved once into a temporary directory, four ranks
     sharing the card over gloo on a (data 1, model 4) mesh
     (parallel/launch.py), each loading the key and proving the main
     path's inputs with draw_rs(1, 128) on its shards (the distributed
     NTT at nm = 4, the tables cut four ways); the proofs must equal the
     main path's byte for byte, sampled ones verify and a cross-voter one
     is rejected; each rank's stage seconds with its collectives' seconds
     and bytes (one timed step after the first), peak memory and
     launches (summed over the ranks); one coset_evals_dist of a (16384,
     21, 128) plane on the four ranks, gathered, equal to the local NTT;
     whether the collectives were staged through the host; then on the
     same four ranks the step captured (ShardedProver.capture: one CUDA
     graph a stretch between collectives, 18 stretches at (1, 4)), whose
     proofs must equal the eager sharded step's and the main path's, with
     sampled ones verified and a cross-voter one rejected, and whose
     launches by kernel, summed over the stretches, must equal one eager
     step's on each rank; per rank the stretches and nodes, warm-up,
     capture and instantiation seconds, the pool's bytes and the peak
     with the graphs alive, eager and replay steps in turns with their
     collectives' seconds, and one replay's device busy time on rank 0;
     then tools.dryrun_multichip on 4 ranks (through the capture) and
     tools.scaling_sweep's full step at nlevels=4, batch 8, over (1,1)
     and (1,4), each equal to the single device;
 11. drives nlevels=160 at batch 16, the package's default configuration
     (phase nlevels160, after phase stream, the flagship's graphs and
     provers released): CensusCircuit(160) and dev_setup with the seconds
     of each part, the vk equal to the committed dev/160 one (no zkey is
     read); mock_batch(160, 16, seed=7) -> DeviceProver.prove_batch, a
     prove_arrays timed by stage (launches by kernel and shape, the folds
     held against the MSM plan at the 160 tables, peak memory); the step
     captured through ReplayProver (warm-up, capture and instantiation
     seconds, nodes, the pool's bytes, launches equal to one
     prove_arrays'), its proofs byte-equal to the eager prove_batch's for
     seeds 1 and 2, sampled proofs verified and a cross-voter and a
     tampered one rejected; eager and replay in turns (one round), one
     profiled replay, tools.bench's line; then the kernels at this path's
     shapes: ntt_level at every level of the 2^17 schedules at 16 lanes,
     the chunked sparse.spmv of A at 16 lanes against its plain version
     (mont_mul_ref), and the folds at every width the 160 tables give at
     batch 16;
 12. serves the default deployment (phase stream160, right after phase
     nlevels160, whose circuit and dev key it takes): config.Config()'s
     n_levels and batch_size (160, 16) and the key of
     Config().artifact_dir, rebuilt as native-ordered zkey bytes
     (zkey_from_pk, write_zkey) whose sha256 must equal the committed
     file's (circuits-info.md's digest; the 130 MB file does not ride to
     the card), ingested (A and B only) with its vk equal to the committed
     one; a DeviceProver keyed from it alone serves mock_batch(160, 47,
     seed=7) through ProofStream at batch 16 with a crash at cursor 32 and
     a resume over 8, 4, 2, 1, every slice on a captured step (16, 8, 4, 2
     and 1 each captured once into one pool, launches equal to one
     prove_arrays' at its size), then eagerly: the 95 files equal byte for
     byte, voters 0, 31, 32, 39, 40, 44, 46 verify and a cross-voter pair
     is rejected; the same line as phase stream's (captures, pool, peaks,
     each stream's seconds and proofs/s by slice and over the voters);
     then, untimed, the folds at every width the tail sizes launch that
     batch 16 does not, against their plain versions.

Launch counts are set to 0 just before each of the paths 3 to 12 and
read just after it; the run fails if a kernel of a path was not launched
on it.

Every phase prints JSON lines.  The last line is
{"ok": true, "device": {...}}; any failure exits non-zero before it.
It imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

N_LEVELS, BATCH = 16, 128              # the main path's configuration

_CSRC = "zkfranchise_tpu_torch/csrc/"
_PALLAS = "zkfranchise_tpu/ops/pallas/lm_kernels.py"
_EXPT = "scripts/layout_expt"
# kernel -> (source, the TPU kernel it replaces, the path that owns it,
# its LAUNCHES keys)
KERNELS = {
    "mont_mul": (_CSRC + "lm_kernels.cu", _PALLAS + ":217", "main_path",
                 ["mont_mul"]),
    "ntt_level": (_CSRC + "lm_ntt.cu", _PALLAS + ":217", "main_path",
                  ["ntt_level"]),
    "padd": (_CSRC + "lm_kernels.cu", _PALLAS + ":89", "main_path",
             ["padd/g1", "padd/g2"]),
    "fold_padd": (_CSRC + "lm_kernels.cu", _PALLAS + ":122", "main_path",
                  ["fold_padd/g1", "fold_padd/g2"]),
    "fold_padd_aa": (_CSRC + "lm_kernels.cu", _PALLAS + ":163", "main_path",
                     ["fold_padd_aa/g1", "fold_padd_aa/g2"]),
    # fold_mul at one level, and at several (batch_inv's walk up)
    "fold_mul": (_CSRC + "lm_chains.cu", _PALLAS + ":269", "affine_tree",
                 ["fold_mul"]),
    "inv": (_CSRC + "lm_chains.cu", _PALLAS + ":316", "verify_tools",
            ["inv"]),
    # its own top and walk down; the walk up counts as fold_mul
    "batch_inv": (_CSRC + "lm_chains.cu", _PALLAS + ":334", "affine_tree",
                  ["batch_inv/top", "batch_inv/down"]),
    "mont_chain": (_CSRC + "lm_chains.cu", "scripts/micro_montmul.py:36",
                   "verify_tools", ["mont_chain"]),
    "scalar_mul": (_CSRC + "lm_kernels.cu", "scripts/verify_lm_device.py:58",
                   "main_path", ["scalar_mul/g1", "scalar_mul/g2"]),
    "poseidon": (_CSRC + "lm_poseidon.cu", _PALLAS + ":217", "main_path",
                 ["poseidon/t3", "poseidon/t4", "poseidon/t5"]),
    # the witness's SMT chains: the levels at or below each lane's leaf
    # from a table, the levels above it hashed in one launch
    "smt": (_CSRC + "lm_poseidon.cu", "zkfranchise_tpu/models/census.py:300",
            "main_path", ["smt/fill", "smt/levels"]),
    "mm2d": (_CSRC + "lm_layout.cu", _EXPT + ".py:56", "layout_tools",
             ["mm2d"]),
    "mm3d": (_CSRC + "lm_layout.cu", _EXPT + ".py:83", "layout_tools",
             ["mm3d"]),
    "fold2d": (_CSRC + "lm_kernels.cu", _EXPT + ".py:111", "layout_tools",
               ["fold2d/g1", "fold2d/g2"]),
    "add_one": (_CSRC + "lm_layout.cu", _EXPT + "2.py:50", "layout_tools",
                ["add_one"]),
    "fused_upsweep": (_CSRC + "lm_layout.cu", _EXPT + "2.py:86",
                      "layout_tools", ["fused_upsweep"]),
}
# what each path must launch at least once
PATH_KERNELS = {
    "main_path": ["mont_mul", "ntt_level", "padd/g1", "padd/g2",
                  "fold_padd/g1",
                  "fold_padd/g2", "fold_padd_aa/g1", "fold_padd_aa/g2",
                  "poseidon/t4", "poseidon/t5", "smt/fill", "smt/levels",
                  "scalar_mul/g1"],
    "affine_tree": ["fold_mul", "batch_inv/top", "batch_inv/down",
                    "mont_mul"],
    "verify_tools": ["mont_chain", "scalar_mul/g1", "scalar_mul/g2",
                     "fold_mul", "inv", "batch_inv/top", "batch_inv/down",
                     "mont_mul", "padd/g1", "padd/g2",
                     "fold_padd/g1", "fold_padd/g2", "fold_padd_aa/g1",
                     "fold_padd_aa/g2"],
    "layout_tools": ["mm2d", "mm3d", "fold2d/g1", "add_one", "fused_upsweep",
                     "mont_mul", "fold_padd/g1"],
}
PATH_KERNELS["stream"] = PATH_KERNELS["main_path"]
PATH_KERNELS["fused_step"] = PATH_KERNELS["main_path"]
# the trusted setup: scalings and butterflies, and from_mont on the way out
PATH_KERNELS["ceremony"] = ["scalar_mul/g1", "scalar_mul/g2", "padd/g1",
                            "padd/g2", "mont_mul"]
PATH_KERNELS["ceremony_prove"] = PATH_KERNELS["main_path"]
# the sharded prover runs the main path's stages on every rank
PATH_KERNELS["sharded"] = PATH_KERNELS["main_path"]
PATH_KERNELS["sharded_capture"] = PATH_KERNELS["main_path"]
PATH_KERNELS["nlevels160"] = PATH_KERNELS["main_path"]
PATH_KERNELS["stream160"] = PATH_KERNELS["main_path"]


def require_launches(path: str, launches: dict) -> None:
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {path}: {missing}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# phase 1: toolchain, card, build
# ---------------------------------------------------------------------------

def phase_toolchain(torch, K) -> None:
    nvcc = K._nvcc_version().strip().splitlines()
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
    libs = K.build()
    K._libs()
    build_s = time.perf_counter() - t0
    log = "\n".join(lib.with_suffix(".log").read_text()
                    for lib in libs.values()
                    if lib.with_suffix(".log").exists())
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
    from zkfranchise_tpu_torch.tools.fold_shapes import sass_mix

    cooperative = ("add_kernel", "fold_levels_kernel", "flat_fold_kernel",
                   "flat_group", "ladder_kernel", "prod", "poseidon_kernel")
    # kernels that fail the run if they spill
    no_spill = cooperative + ("mont_mul_kernel", "ntt_level_kernel",
                              "inv_kernel", "mm2d_kernel",
                              "mont_chain_kernel", "fold_mul_levels_kernel",
                              "batch_inv_top_kernel",
                              "batch_inv_down_kernel")
    mix = {name: m for lib in ("lm_kernels", "lm_ntt", "lm_chains",
                               "lm_layout")
           for name, m in sass_mix(libs[lib]).items()
           if any(c in name for c in no_spill)}
    emit({"phase": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1], "nvidia_smi": smi_line(),
          "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s,
          "libraries": [lib.name for lib in libs.values()],
          "ptxas": resources,
          "resident_blocks_per_sm": {n: K.occupancy(n) for n in (1, 2, 3)},
          "sass_mix": mix})
    spills = {f: r for f, r in resources.items()
              if any(c in f for c in no_spill) and
              (r.get("spill_stores", 0) or r.get("spill_loads", 0))}
    if spills:
        raise AssertionError(f"kernels spill: {spills}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------

def _ratio(a, b):
    """a / b, or None where the reading b is 0 or missing (an invalid
    reading, marked as such beside the ratio)."""
    return a / b if b else None


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


def _checker(torch, results: dict, table: dict):
    """-> check(name, kernel, plain, nbytes, mads, key, plain_runs=3,
    library=None): a kernel held against its plain version and timed, its
    reading put into `results` under `name` and, given a key, into `table`
    (the kernels line's row) under `key`; a kernel that differs raises."""
    from zkfranchise_tpu_torch.tools import bound_ms, device_reading, \
        event_ms

    def check(name, kernel, plain, nbytes, mads, key, plain_runs=3,
              library=None):
        """library: one PyTorch call (or the honest chain of them) that
        computes the same function; timed beside the kernel, held against
        the plain version too, and used nowhere in the port.  ms is a whole
        call (CUDA events, the wrapper's host time included), device_ms
        the kernels' own time per call (torch.profiler, through
        tools.device_reading: "device_invalid" marks a reading no card can
        give, beside the event-burst ms); plain_ms the median of
        plain_runs timed calls of the plain version, or with plain_runs=1
        the check's own call."""
        got = kernel()
        if plain_runs == 1:
            # a plain version of hundreds of chained steps is timed once:
            # on the run that the check needs anyway
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            want = plain()
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
        else:
            want = plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.long() - want.long()).abs().max().item())
        del got
        ms = event_ms(kernel)
        reading = device_reading(name, kernel, nbytes, mads)
        dev_ms = reading["device_ms"]
        if plain_runs > 1:
            plain_ms = event_ms(plain, runs=plain_runs)
        library_ms = library_dev_ms = library_invalid = None
        if library is not None:
            if not torch.equal(library(), want):
                raise AssertionError(f"{name}: the library call differs "
                                     f"from the plain version")
            library_ms = event_ms(library)
            lib_reading = device_reading(name + " library", library, nbytes,
                                         mads)
            library_dev_ms = lib_reading["device_ms"]
            library_invalid = lib_reading["invalid"]
        b_ms, b_by = bound_ms(nbytes, mads)
        marks = {"device_invalid": reading["invalid"],
                 "burst_ms": reading["burst_ms"],
                 "library_device_invalid": library_invalid}
        results[name] = {"equal": equal, "ms": ms, "device_ms": dev_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "library_ms": library_ms,
                         "library_device_ms": library_dev_ms, **marks}
        if key is not None:
            table[key] = {"shape": name, "max_abs_err": err, "ms": ms,
                          "device_ms": dev_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": library_ms,
                          "library_device_ms": library_dev_ms, **marks}
        if not equal:
            raise AssertionError(f"{name}: kernel differs from plain version "
                                 f"(max abs err {err})")

    return check


def phase_kernels(np, torch, K, dev) -> dict:
    from zkfranchise_tpu_torch.ops import ec_affine, ec_lm, lm
    from zkfranchise_tpu_torch.tools import MAD_MONT, MAD_MONT_KARATSUBA, \
        add_mads, device_reading, mont_chain_work
    from zkfranchise_tpu_torch.tools import fold_shapes
    from zkfranchise_tpu_torch.tools.padd_shapes import SHAPES, padd_inputs

    rng = np.random.default_rng(2024)
    results, table = {}, {}
    # inv's products: 253 squares and one per set bit of p - 2 (110)
    chain = len(lm.FQ.p_minus_2_bits) - 1 + int(lm.FQ.p_minus_2_bits.sum())

    check = _checker(torch, results, table)

    # mont_mul at row 1's shape in both fields, and at the operand
    # patterns the port launches it with (MONT_SHAPES): a constant column
    # (n_inv), a column per row at 4 lanes (shift_pows in the stream's
    # last slice), a shared table, two full operands (the quotient's a*b)
    # and batch_inv's strided half-slices against a column; more than
    # three leading dims that do not merge are held for equality only
    def limbs(shape):
        return torch.as_tensor(_random_limbs(np, rng, shape), device=dev)

    patterns = [("fr", (8192, 21, 128), (8192, 21, 1), "mont_mul"),
                ("fq", (8192, 21, 128), (8192, 21, 1), None),
                ("fr", (16384, 21, 128), (21, 1), "mont_mul/const"),
                ("fr", (16384, 21, 4), (16384, 21, 1), "mont_mul/col_T4"),
                ("fq", (64, 21, 128), (21, 128), "mont_mul/table"),
                ("fr", (16384, 21, 128), (16384, 21, 128), "mont_mul/full")]
    for fname, sa, sb, key in patterns:
        fs = lm.FR if fname == "fr" else lm.FQ
        a, b = limbs(sa), limbs(sb)
        out = torch.broadcast_shapes(a.shape, b.shape)
        check(f"mont_mul/{fname}/{'x'.join(map(str, sa))}*"
              f"{'x'.join(map(str, sb))}", lambda: K.mont_mul(a, b, fs),
              lambda: K.mont_mul_ref(a, b, fs),
              4 * (a.numel() + b.numel() + math.prod(out)),
              MAD_MONT_KARATSUBA * math.prod(out) / 21, key)
        del a, b
    col, cur = limbs((128, 21, 1)), limbs((128, 21, 16384))
    check("mont_mul/fq/128x21x1*128x21x16384[8192:] (strided)",
          lambda: K.mont_mul(col, cur[..., 8192:], lm.FQ),
          lambda: K.mont_mul_ref(col, cur[..., 8192:], lm.FQ),
          4 * (col.numel() + 2 * cur.numel() // 2),
          MAD_MONT_KARATSUBA * 128 * 8192, "mont_mul/strided")
    y = limbs((3, 2, 5, 7, 21, 3))
    if not torch.equal(K.mont_mul(y, y[:, :1, :, :1], lm.FQ),
                       K.mont_mul_ref(y, y[:, :1, :, :1], lm.FQ)):
        raise AssertionError("mont_mul differs on six dims")
    del col, cur, y
    torch.cuda.empty_cache()
    _ntt_levels(np, torch, K, dev, rng, check, results, table, 14, BATCH,
                "ntt_level", read_each=True)
    _ntt_levels(np, torch, K, dev, rng, check, results, table, 14, 4,
                "ntt_level/T4", read_each=False)
    torch.cuda.empty_cache()

    # padd at the shapes the main path launches it with (walk: the
    # table's row), and the card filled (wide)
    for kind in ("g1", "g2"):
        rows = ec_lm.ROWS[kind]
        for sname, Bp, Tp in SHAPES:
            p, q = padd_inputs(kind, Bp, Tp, rng, dev)
            key = "padd" if sname == "walk" else f"padd/{sname}"
            if kind == "g2":
                key = "padd/g2" if sname == "walk" else f"{key}/g2"
            check(f"padd/{kind}/{sname}/{Bp}x{rows}x{Tp}",
                  lambda: K.padd(p, q, kind), lambda: K.padd_ref(p, q, kind),
                  4 * 3 * rows * Bp * Tp, add_mads("padd", kind) * Bp * Tp,
                  key)
            del p, q
    B, m = 128, 2048
    for kind in ("g1", "g2"):
        rows, arows = ec_lm.ROWS[kind], ec_affine.AROWS[kind]
        p, q, a = _point_inputs(np, torch, rng, kind, B, m, dev)
        key = (lambda k: k) if kind == "g1" else (lambda k: f"{k}/g2")
        x = torch.cat([p[..., :m // 2], q[..., :m // 2]], -1).contiguous()
        check(f"fold_padd/{kind}/{B}x{rows}x{m}",
              lambda: K.fold_padd(x, kind),
              lambda: K.fold_padd_ref(x, kind),
              4 * (rows * m + rows * m // 2) * B,
              add_mads("padd", kind) * B * m // 2, key("fold_padd"))
        # level 0 as the MSM launches it: a chunk's [P | -P] rows read
        # through each lane's index (G1 at nlevels=160's chunk of 16,384)
        ma = 16384 if kind == "g1" else m
        tab, idx = fold_shapes.fold_at_inputs(kind, B, ma, rng, dev)
        check(f"fold_padd_aa/{kind} table ({tab.shape[0]},{arows}) at "
              f"({B},{ma})", lambda: K.fold_padd_aa(tab, kind, idx=idx),
              lambda: K.fold_padd_aa_ref(
                  tab[idx.long()].transpose(-1, -2), kind),
              4 * (arows * ma + rows * ma // 2) * B,
              add_mads("padd_aa", kind) * B * ma // 2,
              key("fold_padd_aa"))
        del p, q, a, x, tab, idx
        torch.cuda.empty_cache()

    # the folds at every width of the main path's sum tree, one level and
    # as the plan launches them, and at ragged widths and one batch row
    failed: list = []
    edges = [("fold", "g1", 1, 33), ("aa", "g1", 1, 33),
             ("fold", "g2", 1, 33), ("aa", "g2", 1, 33)]
    edge_levels = [("g1", 3, 12, 3), ("g1", 1, 33, 1), ("g2", 32, 256, 2)]
    fold_results = fold_shapes.run(dev, fold_shapes.SHAPES,
                                   fold_shapes.LEVELS, failed)
    fold_shapes.run(dev, edges, edge_levels, failed, timed=False)
    fold_shapes.run_gathered(dev, fold_shapes.SMALL_GATHERED, failed,
                             timed=False)
    if failed:
        raise AssertionError(f"folds differ from their plain versions: "
                             f"{failed}")
    torch.cuda.empty_cache()

    # the batch inversion at the width of the affine tree's level 0: the
    # one-level fold_mul, batch_inv launch by launch and as a whole, and at
    # every width the tree calls it with
    x = torch.as_tensor(_random_limbs(np, rng, (B, 21, 32768)), device=dev)
    check(f"fold_mul/fq/{B}x21x32768", lambda: K.fold_mul(x, lm.FQ),
          lambda: K.fold_mul_ref(x, lm.FQ), 4 * 21 * (32768 + 16384) * B,
          MAD_MONT * B * 16384, "fold_mul")
    del x
    # the Fermat chain: 253 squares (the last is not needed) and a product
    # per set bit of p - 2, a warp a lane, at 1 lane, the batch's 128 and
    # 129 (a block more than the SMs a lane takes), a zero lane in each;
    # beside it the yardstick, a mont_chain of 364 dependent products at
    # 128 lanes, one thread a lane, as inv's chain ran before it took a warp
    # a lane (the Karatsuba register product since mont_chain runs mm2d's)
    for T in (1, B, B + 1):
        a = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
        a[:, T // 2] = 0                                 # inv(0) = 0
        name = f"inv/fq/21x{T}"
        check(name, lambda: K.inv(a, lm.FQ), lambda: K.inv_ref(a, lm.FQ),
              4 * (2 * 21 * T + 254), MAD_MONT * chain * T,
              "inv" if T == B else f"inv/T{T}", plain_runs=1)
    yard = device_reading(f"mont_chain/fq/21x{B}x364 (inv's yardstick)",
                          lambda: K.mont_chain(a[:, :B], a[:, :B], 364,
                                               lm.FQ),
                          *mont_chain_work(B, 364))
    for key in ("inv", "inv/T1", f"inv/T{B + 1}"):
        row = table[key]
        row.update(products=chain, product_us=row["device_ms"] / chain * 1e3,
                   chain_products=364, critical_path_ms=yard["device_ms"],
                   critical_path_invalid=yard["invalid"],
                   chain_product_us=yard["device_ms"] / 364 * 1e3)
        results[row["shape"]].update(row)
    _batch_inv(np, torch, K, dev, rng, check, results, table)
    # the chains of the tools
    T, iters = 128 * 1024, 20
    a = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
    b = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
    check(f"mont_chain/fq/21x{T}x{iters}",
          lambda: K.mont_chain(a, b, iters, lm.FQ),
          lambda: K.mont_chain_ref(a, b, iters, lm.FQ),
          *mont_chain_work(T, iters), "mont_chain")
    del a, b
    _ladders(np, torch, K, dev, rng, check, results, table)
    _poseidon(np, torch, K, dev, rng, check, results, table)
    _smt_chain(np, torch, K, dev, rng, check, results, table)
    torch.cuda.empty_cache()
    _layout_kernels(np, torch, K, dev, rng, check, results, table)
    emit({"phase": "kernels", "kernels": results,
          "fold_shapes": fold_results})
    return table


def _ntt_levels(np, torch, K, dev, rng, check, results, table, log_n: int,
                T: int, key: str, read_each: bool) -> None:
    """zk_ntt_level at every level of the forward and the inverse 2^log_n
    schedules at T lanes, each level fed the previous one's output, held
    against the plain version (ntt_level_ref with mont_mul_ref) with
    torch.equal.  The first forward level goes through `check`: the
    table's row under `key` (whole-call, device and plain ms, bound).
    With read_each, every level's device ms through tools.device_reading,
    and the row carries the slowest level.  One "ntt_levels" line."""
    from zkfranchise_tpu_torch.ops import lm, ntt
    from zkfranchise_tpu_torch.tools import MAD_MONT_KARATSUBA, \
        device_reading

    pl = ntt.plan(log_n)
    n = pl.n
    tabs = pl.on(str(dev))
    levels = []
    for sched in ("fwd", "inv"):
        gs, tws, _ = tabs[sched]
        x = lm.to_mont(torch.as_tensor(_random_limbs(np, rng, (n, 21, T)),
                                       device=dev))
        for lvl, (g, tw) in enumerate(zip(gs, tws)):
            nbytes = 4 * (2 * x.numel() + tw.numel()) + 8 * g.numel()
            mads = MAD_MONT_KARATSUBA * (n // 2) * T
            name = f"ntt_level/fr/{n}x21x{T}/{sched}{lvl}"

            def kernel():
                return K.ntt_level(x, g, tw)

            def plain():
                return ntt.ntt_level_ref(x, g, tw, mul=lm.mont_mul_ref)

            level = {"level": f"{sched}{lvl}"}
            if (sched, lvl) == ("fwd", 0):
                check(name, kernel, plain, nbytes, mads, key, plain_runs=3)
                level.update(device_ms=results[name]["device_ms"],
                             invalid=results[name]["device_invalid"])
            else:
                if not torch.equal(kernel(), plain()):
                    raise AssertionError(f"{name}: kernel differs from "
                                         f"plain version")
                if read_each:
                    r = device_reading(name, kernel, nbytes, mads)
                    level.update(device_ms=r["device_ms"],
                                 invalid=r["invalid"])
            levels.append(level)
            x = kernel()
        del x
    read = [v for v in levels if "device_ms" in v]
    summary = {"levels": len(levels), "levels_equal": len(levels),
               "levels_read": len(read),
               "max_device_ms": max(v["device_ms"] for v in read),
               "any_invalid": any(v["invalid"] for v in read)}
    emit({"phase": "kernels", "ntt_levels": key, **summary, "each": levels})
    table[key].update(summary)
    results[table[key]["shape"]].update(summary)


BATCH_INV_X = 16384                     # the affine tree's widest call


def _batch_inv(np, torch, K, dev, rng, check, results, table) -> None:
    """batch_inv at (128, 21, 16384), the G1 tree's level 0: the whole call
    against batch_inv_ref (the table's row, with its launches a call, the
    latency floor: the chain's reading plus the products at the integer
    ceiling); each launch of batch_inv_plan against its plain version from
    the same buffer, and its device ms; then every width 2^0 .. 2^14 at
    B = 128 (the widths the affine tree calls it with), each held against
    batch_inv_ref with torch.equal and read, one "batch_inv_widths"
    line."""
    from zkfranchise_tpu_torch.ops import lm
    from zkfranchise_tpu_torch.tools import MAD_MONT_KARATSUBA, \
        batch_inv_step_work, batch_inv_work, bound_ms, device_reading, \
        int_ceiling_ms, max_sm_mhz

    B = BATCH
    steps = {"fold_mul_levels": (K.fold_mul_levels, K.fold_mul_levels_ref),
             "top": (K.batch_inv_top, K.batch_inv_top_ref),
             "down": (K.batch_inv_down, K.batch_inv_down_ref)}

    def inputs(X):
        d = torch.as_tensor(_random_limbs(np, rng, (B, 21, X)), device=dev)
        d[:, 0, :] |= 1               # no zero lane: the caller maps them
        return d

    X = BATCH_INV_X
    d = inputs(X)
    check(f"batch_inv/fq/{B}x21x{X}", lambda: K.batch_inv(d, lm.FQ),
          lambda: K.batch_inv_ref(d, lm.FQ), *batch_inv_work(B, X),
          "batch_inv", plain_runs=1)
    K.reset_launches()
    K.batch_inv(d, lm.FQ)
    per_call = {k: v for k, v in K.LAUNCHES.items() if v}
    heap, each = torch.empty_like(d), []
    for kernel, lo, levels, grid, threads, smem in K.batch_inv_plan(B, X):
        run, plain = steps[kernel]
        args = (lo,) if kernel == "top" else (lo, levels)
        mine, want = heap.clone(), heap.clone()
        run(d, mine, *args, lm.FQ)
        plain(d, want, *args, lm.FQ)
        if not torch.equal(mine, want):
            raise AssertionError(f"batch_inv {kernel} from level {lo}: "
                                 f"kernel differs from plain version")
        scratch = mine.clone()
        work = batch_inv_step_work(kernel, lo, levels, B, X)
        r = device_reading(f"batch_inv/{kernel}/lo{lo}/n{levels}",
                           lambda: run(d, scratch, *args, lm.FQ), *work)
        each.append({"kernel": kernel, "lo": lo, "levels": levels,
                     "grid": list(grid), "threads": threads,
                     "shared_bytes": smem, "device_ms": r["device_ms"],
                     "invalid": r["invalid"], "bound_ms": bound_ms(*work),
                     "int_ceiling_ms": r["int_ceiling_ms"]})
        heap = mine
        del want, scratch
    mhz = max_sm_mhz()
    _, mads = batch_inv_work(B, X)
    products_ms = int_ceiling_ms(MAD_MONT_KARATSUBA * 3 * (X - 1) * B, mhz)
    row = {"launches_per_call": per_call, "each_launch": each,
           "int_ceiling_ms": int_ceiling_ms(mads, mhz),
           "latency_floor_ms": table["inv"]["device_ms"] + products_ms,
           "products_int_ceiling_ms": products_ms}
    table["batch_inv"].update(row)
    results[table["batch_inv"]["shape"]].update(row)
    del d, heap, mine
    widths = []
    for n in range(BATCH_INV_X.bit_length()):
        X = 1 << n
        d = inputs(X)
        K.reset_launches()
        got = K.batch_inv(d, lm.FQ)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        equal = bool(torch.equal(got, K.batch_inv_ref(d, lm.FQ)))
        r = device_reading(f"batch_inv/fq/{B}x21x{X}",
                           lambda: K.batch_inv(d, lm.FQ),
                           *batch_inv_work(B, X))
        widths.append({"X": X, "equal": equal,
                       "launches": sum(launches.values()),
                       "by_kernel": launches, "device_ms": r["device_ms"],
                       "invalid": r["invalid"]})
        del d, got
    emit({"phase": "kernels", "batch_inv_widths": widths})
    table["batch_inv"]["widths_device_ms"] = {w["X"]: w["device_ms"]
                                              for w in widths}
    bad = [w["X"] for w in widths if not w["equal"]]
    if bad:
        raise AssertionError(f"batch_inv differs from batch_inv_ref at "
                             f"widths {bad}")


def _ladders(np, torch, K, dev, rng, check, results, table) -> None:
    """scalar_mul at the assembly's shape, 128 lanes and 254 bits, with a
    scalar per lane (the table's row) and one for all lanes (the tools'),
    G1 and G2.  The ladder's critical path is 254 dependent cooperative
    adds; its yardstick is 254 times the device time of one padd launch
    at the assembly's plane shape (1, rows, 128), timed here."""
    from zkfranchise_tpu_torch.ops import ec_lm
    from zkfranchise_tpu_torch.tools import add_mads, device_reading
    from zkfranchise_tpu_torch.tools.padd_shapes import padd_inputs

    B, nbits = BATCH, 254
    for kind in ("g1", "g2"):
        rows = ec_lm.ROWS[kind]
        p, _, _ = _point_inputs(np, torch, rng, kind, 1, B, dev)
        pts = p[0]
        pa, qa = padd_inputs(kind, 1, B, rng, dev)
        one_add = device_reading(f"padd/{kind}/1x{rows}x{B} (the ladder's "
                                 f"step)", lambda: K.padd(pa, qa, kind),
                                 4 * 3 * rows * B,
                                 add_mads("padd", kind) * B)
        for per_lane in (True, False):
            bits = rng.integers(0, 2, size=(nbits, B) if per_lane else nbits)
            bits = torch.as_tensor(bits.astype(np.int32), device=dev)
            # the adds these scalars need: a doubling a bit and an add a
            # set bit, for every lane
            adds = (nbits * B + int(bits.sum()) * (1 if per_lane else B))
            name = f"scalar_mul/{kind}/{rows}x{B}x{nbits}bits/" + \
                ("per_lane" if per_lane else "shared")
            key = "scalar_mul" if kind == "g1" else "scalar_mul/g2"
            check(name, lambda: K.scalar_mul(pts, bits, kind),
                  lambda: K.scalar_mul_ref(pts, bits, kind),
                  4 * (2 * rows * B + bits.numel()),
                  add_mads("padd", kind) * adds,
                  key if per_lane else key + "/shared", plain_runs=1)
            yard = {"critical_path_ms": nbits * one_add["device_ms"],
                    "one_add_device_ms": one_add["device_ms"],
                    "one_add_invalid": one_add["invalid"]}
            results[name].update(yard)
            table[key if per_lane else key + "/shared"].update(yard)
        del p, pts, pa, qa


def _poseidon(np, torch, K, dev, rng, check, results, table) -> None:
    """The Poseidon kernel at the witness's widths t = 3, 4, 5, at 128
    lanes (the batch) and 4 (the stream's last slice), with its trace,
    against the plain version.  The yardstick is the critical path: a
    mont_chain of as many dependent products (a round's S-box and its row
    of the mix, 3 + t) at the same width, timed here (the Karatsuba
    register product, one thread a lane)."""
    from zkfranchise_tpu_torch.ops import lm
    from zkfranchise_tpu_torch.ops.poseidon_constants import N_ROUNDS_F, \
        N_ROUNDS_P
    from zkfranchise_tpu_torch.tools import MAD_MONT, device_reading, \
        mont_chain_work

    for T in (BATCH, 4):
        for t in K.POSEIDON_WIDTHS:
            x = lm.to_mont(torch.as_tensor(_random_limbs(np, rng,
                                                         (t - 1, 21, T)),
                                           device=dev))
            rounds, r_p = N_ROUNDS_F + N_ROUNDS_P[t - 2], N_ROUNDS_P[t - 2]
            products = 3 * (N_ROUNDS_F * t + r_p) + t * t * rounds
            rows = K.poseidon_trace_rows(t)
            name = f"poseidon/t{t}/{t - 1}x21x{T}"
            key = f"poseidon/t{t}/T{T}" if T != BATCH else \
                "poseidon" if t == 3 else f"poseidon/t{t}"
            out, trace = K.poseidon_trace(x)
            want_out, want_trace = K.poseidon_trace_ref(x)
            if not torch.equal(out, want_out):
                raise AssertionError(f"{name}: the hash differs from the "
                                     f"plain version's")
            del out, trace, want_out, want_trace
            # the trace holds every S-box output; the hash was held above
            check(name, lambda: K.poseidon_trace(x)[1],
                  lambda: K.poseidon_trace_ref(x)[1],
                  4 * 21 * T * (t - 1 + 1 + rows) + 4 * 21 * t * (rounds + t),
                  MAD_MONT * products * T, key, plain_runs=3)
            depth = rounds * (3 + t)
            a = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
            chain = device_reading(
                f"mont_chain/fr/21x{T}x{depth} (the permutation's chain)",
                lambda: K.mont_chain(a, a, depth, lm.FR),
                *mont_chain_work(T, depth))
            yard = {"chain_products": depth,
                    "critical_path_ms": chain["device_ms"],
                    "critical_path_invalid": chain["invalid"],
                    "vs_critical_path": _ratio(results[name]["device_ms"],
                                               chain["device_ms"])}
            results[name].update(yard)
            table[key].update(yard)
            del x, a


SMT_LANES = 16                          # the deployment's batch


def _smt_chain(np, torch, K, dev, rng, check, results, table) -> None:
    """The witness's SMT chains at nlevels=160 (L = 161) for both trees of
    16 voters: smt_walk (the head rows, smt_fill, smt_levels) against the
    plain per-level loop on the same card (smt_chain_ref: a permutation
    launch and three products a level), with the lanes' deepest leaf at
    14 (the table's row; depths 0 .. 14) and at 161 (every lane: no level
    from the table).  The yardstick is the critical path: a mont_chain of
    as many dependent products (d_max levels of 65 rounds of 3 + 3, and
    the level's m_sw and m2) at the same 32 lanes."""
    from zkfranchise_tpu_torch.ops import lm
    from zkfranchise_tpu_torch.ops.poseidon_constants import N_ROUNDS_F, \
        N_ROUNDS_P
    from zkfranchise_tpu_torch.tools import MAD_MONT, device_reading, \
        mont_chain_work, smt_inputs

    L, T, n = 161, SMT_LANES, 2
    rounds = N_ROUNDS_F + N_ROUNDS_P[1]
    per_level = 3 * (N_ROUNDS_F * 3 + N_ROUNDS_P[1]) + 9 * rounds + 2
    for d_max, key in ((14, "smt"), (L, "smt/d161")):
        depths = np.full(n * T, L) if d_max == L else \
            rng.integers(0, d_max + 1, n * T)
        depths[0] = d_max
        args = smt_inputs(L, T, depths.tolist(), int(rng.integers(1 << 30)),
                          dev)
        root, _, hashed = K.smt_walk(*args)
        want_root, _, _ = K.smt_chain_ref(*args)
        if not torch.equal(root, want_root) or \
                hashed.tolist() != depths.tolist():
            raise AssertionError(f"smt d_max {d_max}: roots or counts "
                                 f"differ from the plain loop's")
        name = f"smt/161x21x{n}x{T}/dmax{d_max}"
        rows = K.smt_block_rows(L)
        hashed_levels = int(depths.sum())
        check(name, lambda: K.smt_walk(*args)[1],
              lambda: K.smt_chain_ref(*args)[1],
              4 * (21 * (n * rows * T + 2 * L * n * T) + L * T),
              MAD_MONT * per_level * hashed_levels, key, plain_runs=1)
        depth = d_max * (rounds * 6 + 2)
        a = torch.as_tensor(_random_limbs(np, rng, (21, n * T)), device=dev)
        chain = device_reading(
            f"mont_chain/fr/21x{n * T}x{depth} (the chain's critical path)",
            lambda: K.mont_chain(a, a, depth, lm.FR),
            *mont_chain_work(n * T, depth))
        yard = {"d_max": d_max, "hashed_levels": hashed_levels,
                "levels": n * L * T, "chain_products": depth,
                "critical_path_ms": chain["device_ms"],
                "critical_path_invalid": chain["invalid"],
                "vs_critical_path": _ratio(results[name]["device_ms"],
                                           chain["device_ms"])}
        results[name].update(yard)
        table[key].update(yard)
        del args, a
    torch.cuda.empty_cache()


def _layout_kernels(np, torch, K, dev, rng, check, results, table) -> None:
    """The five kernels of the layout experiments at the experiments'
    sizes, at two or three geometries each (the first is the table's row).
    fold2d's row also carries its readings at tiles 32 and 4096 and the
    reading of fold_padd on the same points as a segmented (B, rows, m)
    plane (vs_segmented: fold2d's device ms over fold_padd's)."""
    from zkfranchise_tpu_torch.ops import ec_lm, lm
    from zkfranchise_tpu_torch.tools import MAD_MONT, MAD_MONT_KARATSUBA, \
        device_reading, fold2d_work, mont_chain_work
    from zkfranchise_tpu_torch.tools.layout_expt2 import level_adds

    T = 1 << 20
    a = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
    b = torch.as_tensor(_random_limbs(np, rng, (21, T)), device=dev)
    for chain, tiles in ((1, (512, 8192)), (8, (512, 2048))):
        for i, tile in enumerate(tiles):
            key = None if i else ("mm2d" if chain == 1 else "mm2d/chain8")
            check(f"mm2d/fq/21x{T}/chain{chain}/tile{tile}",
                  lambda: K.mm2d(a, b, tile, chain),
                  lambda: K.mm2d_ref(a, b, tile, chain),
                  *mont_chain_work(T, chain), key, plain_runs=3)
    a3, b3 = a.reshape(128, 21, T // 128), b.reshape(128, 21, T // 128)
    for i, (tile, blk) in enumerate(((512, 1), (512, 8), (8192, 1))):
        check(f"mm3d/fq/128x21x{T // 128}/tile{tile}/blk{blk}",
              lambda: K.mm3d(a3, b3, tile, blk),
              lambda: K.mm3d_ref(a3, b3, tile, blk), 4 * 3 * 21 * T,
              MAD_MONT * T, None if i else "mm3d")
    check(f"mont_mul/fq/128x21x{T // 128} (beside mm3d)",
          lambda: K.mont_mul(a3, b3, lm.FQ),
          lambda: K.mont_mul_ref(a3, b3, lm.FQ), 4 * 3 * 21 * T,
          MAD_MONT_KARATSUBA * T, None)
    for i, tile in enumerate((512, 8192)):
        check(f"add_one/21x{T}/tile{tile}", lambda: K.add_one(a, tile),
              lambda: K.add_one_ref(a, tile), 4 * 2 * 21 * T, 0,
              None if i else "add_one", library=lambda: a + 1)
    del a, b, a3, b3
    x = torch.as_tensor(rng.integers(0, 1 << 13, (63, 1 << 16),
                                     dtype=np.int32), device=dev)
    check("fused_upsweep/63x65536", lambda: K.fused_upsweep(x, 512),
          lambda: K.fused_upsweep_ref(x, 512), 4 * 63 * (2 * 65536 - 1), 0,
          "fused_upsweep", library=lambda: level_adds(x))
    del x
    # one fold level of real points on the flat lane axis: segment b of
    # the flat plane is row b of the segmented (B, rows, m) plane
    B, m = 128, 8192
    for kind in ("g1", "g2"):
        rows = ec_lm.ROWS[kind]
        p, q, _ = _point_inputs(np, torch, rng, kind, B, m, dev)
        seg = torch.cat([p[..., :m // 2], q[..., :m // 2]], -1).contiguous()
        del p, q
        x = seg.permute(1, 0, 2).reshape(rows, B * m).contiguous()
        key = "fold2d" if kind == "g1" else "fold2d/g2"
        work = fold2d_work(kind, B, m)
        for i, tile in enumerate((512, 32, 4096)):
            name = f"fold2d/{kind}/{rows}x{B * m}/m{m}/tile{tile}"
            check(name, lambda: K.fold2d(x, tile, kind, m),
                  lambda: K.fold2d_ref(x, tile, kind, m), *work,
                  None if i else key, plain_runs=3)
            if i:
                table[key].update({
                    f"tile{tile}_device_ms": results[name]["device_ms"],
                    f"tile{tile}_invalid": results[name]["device_invalid"]})
        flat = K.fold2d(x, 512, kind, m).reshape(rows, B, m // 2)
        if not torch.equal(K.fold_padd(seg, kind),
                           flat.permute(1, 0, 2)):
            raise AssertionError(f"fold2d/{kind}: differs from fold_padd on "
                                 f"the segmented plane")
        del flat
        segr = device_reading(f"fold_padd/{kind}/{B}x{rows}x{m} (fold2d's "
                              f"points, segmented)",
                              lambda: K.fold_padd(seg, kind), *work)
        row = {"segmented_device_ms": segr["device_ms"],
               "segmented_invalid": segr["invalid"],
               "vs_segmented": _ratio(table[key]["device_ms"],
                                      segr["device_ms"])}
        table[key].update(row)
        results[table[key]["shape"]].update(row)
        del x, seg
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the batch-affine sum tree at the width of the MSM's chunks
# ---------------------------------------------------------------------------

TREES = {"g1": 32768, "g2": 8192}       # the C and B2 chunks at batch 128


def _affine_plane(np, torch, rng, kind, B, m, dev):
    """(B, arows, m) affine plane gathered from a pool of real points and
    their negatives, with infinity lanes, equal pairs, opposite pairs and
    infinity pairs forced at level 0 (lanes j and j + m/2)."""
    from zkfranchise_tpu_torch.ops import ec, ec_affine

    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    grp = ec.G1 if kind == "g1" else ec.G2
    pool = [mul(int(k)) for k in rng.integers(1, 1 << 60, size=24)]
    pool += [grp.neg(pt) for pt in pool]
    aff = torch.as_tensor(ec_affine.affine_table(pool, kind).T, device=dev)
    idx = torch.as_tensor(rng.integers(0, len(pool), size=(B, m)),
                          device=dev)
    a = aff[:, idx].permute(1, 0, 2).contiguous()
    del idx
    h = m // 2
    lanes = torch.as_tensor(rng.permutation(h)[:5 * (h // 32)], device=dev)
    neg, dbl, inf1, inf2, both = lanes.chunk(5)
    a[..., h + neg] = ec_affine.neg_affine(a[..., neg], kind)
    a[..., h + dbl] = a[..., dbl]
    inf = torch.as_tensor(ec_affine.identity_rows(kind, 1).T, device=dev)
    a[..., inf1] = inf
    a[..., h + inf2] = inf
    a[..., both] = inf
    a[..., h + both] = inf
    return a


def _level0_cases(torch, a, kind) -> dict:
    """How many lanes of level 0 take each branch of fold_affine."""
    from zkfranchise_tpu_torch.ops import ec_affine

    k = 1 if kind == "g1" else 2
    h = a.shape[-1] // 2
    x1, y1, i1 = ec_affine._split(a[..., :h], kind)
    x2, y2, i2 = ec_affine._split(a[..., h:], kind)
    eq_x = ec_affine._eq_rows(x1, x2)
    opp = ec_affine._is_neg_pair(y1, y2, k)
    inf1, inf2 = (i1 == 1), (i2 == 1)
    real = ~(inf1 | inf2)
    cases = {"add": real & ~eq_x, "double": real & eq_x & ~opp,
             "opposite": real & eq_x & opp, "inf_left": inf1 & ~inf2,
             "inf_right": inf2 & ~inf1, "inf_both": inf1 & inf2}
    return {name: int(mask.sum().item()) for name, mask in cases.items()}


def phase_affine_tree(np, torch, K, dev) -> dict:
    from zkfranchise_tpu_torch.ops import ec_affine, ec_lm
    from zkfranchise_tpu_torch.tools.verify_kernels import \
        affine_plane_to_host

    rng = np.random.default_rng(77)
    B = BATCH
    report = {}
    launches = {k: 0 for k in K.LAUNCHES}

    def affine_tree(a, kind):
        while a.shape[-1] > 1:
            a = ec_affine.fold_affine(a, kind)
        return a

    def projective_tree(a, kind):
        x = K.fold_padd_aa(a, kind)
        while x.shape[-1] > 1:
            x = K.fold_padd(x, kind)
        return x

    def timed(tree, a, kind):
        """(result, seconds of the first and the second run, launches of
        the second)."""
        secs = []
        for _ in range(2):
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tree(a, kind)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = dict(K.LAUNCHES)
        return out, secs, counts

    torch.cuda.reset_peak_memory_stats(dev)
    for kind, m in TREES.items():
        a = _affine_plane(np, torch, rng, kind, B, m, dev)
        cases = _level0_cases(torch, a, kind)
        if min(cases.values()) == 0:
            raise AssertionError(f"affine_tree {kind}: a branch of "
                                 f"fold_affine is not taken: {cases}")
        aff, aff_s, aff_n = timed(affine_tree, a, kind)
        proj, proj_s, proj_n = timed(projective_tree, a, kind)
        for k, v in aff_n.items():
            launches[k] += v
        to_aff = (ec_lm.g1_plane_to_affine if kind == "g1"
                  else ec_lm.g2_plane_to_affine)
        got = affine_plane_to_host(aff[..., 0].T.contiguous(), kind)
        want = to_aff(proj[..., 0].T.contiguous())
        agree = sum(g == w for g, w in zip(got, want))
        report[kind] = {
            "shape": list(a.shape), "levels": m.bit_length() - 1,
            "level0_cases": cases, "totals_equal": agree, "totals": B,
            "totals_at_infinity": sum(g is None for g in got),
            "affine_tree_s": aff_s, "projective_tree_s": proj_s,
            "affine_launches": {k: v for k, v in aff_n.items() if v},
            "projective_launches": {k: v for k, v in proj_n.items() if v}}
        del a, aff, proj
        torch.cuda.empty_cache()
        if agree != B or len(got) != B:
            emit({"phase": "affine_tree", **report})
            raise AssertionError(f"affine_tree {kind}: {agree} of {B} totals "
                                 f"equal the projective tree's")
    emit({"phase": "affine_tree", "nvidia_smi": smi_line(), **report,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": {k: v for k, v in launches.items() if v}})
    require_launches("affine_tree", launches)
    return launches


# ---------------------------------------------------------------------------
# phases 4 and 5: the tools against the host bigint oracle, and the layout
# experiments against the plain versions
# ---------------------------------------------------------------------------

def phase_tools(torch, K, dev, path: str, names: list) -> dict:
    """Run the named tools on the card at full size as the path `path`;
    a tool that returns non-zero ends the run."""
    import importlib

    K.reset_launches()
    seconds = {}
    for name in names:
        tool = importlib.import_module(f"zkfranchise_tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        rc = tool.main(dev)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"tools.{name} returned {rc}")
    launches = dict(K.LAUNCHES)
    emit({"phase": path, "nvidia_smi": smi_line(), "seconds": seconds,
          "launches": {k: v for k, v in launches.items() if v}})
    require_launches(path, launches)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the main path
# ---------------------------------------------------------------------------


def phase_main_path(np, torch, K, dev) -> tuple[dict, tuple, tuple]:
    """-> (launches of the main path, (circuit, dev-setup pk, committed
    vk) for the serving path, (prover, vk, inputs, r, s) of the timed run
    for phase fused_step)."""
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
    folds = dict(sorted(K.FOLD_SHAPES.items()))
    planned = _planned_folds(prover.msm_rows().values(), BATCH,
                             prover.window_group)
    emit({"phase": "main_path", "inputs_s": inputs_s,
          "prover_init_s": prover_init_s, "first_prove_batch_s": first_s,
          "proofs": len(proofs), "launches": launches,
          "mont_launches_by_shape": dict(sorted(K.MONT_SHAPES.items())),
          "padd_launches_by_shape": dict(sorted(K.PADD_SHAPES.items())),
          "fold_launches_by_shape": folds,
          "fold_launches": sum(folds.values())})
    require_launches("main_path", launches)
    if folds != planned:
        raise AssertionError(f"fold launches differ from the MSM plan's "
                             f"count: {planned}")

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
    proofs2, pubs2 = prover.finalize(*planes[:4])
    stages["finalize"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    emit({"phase": "timed_prove", "nvidia_smi": smi_line(),
          "stage_seconds": stages, "total_s": total,
          "proofs_per_s": BATCH / total,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "launches_per_prove_arrays": dict(K.LAUNCHES),
          "mont_launches_by_shape": dict(sorted(K.MONT_SHAPES.items()))})

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
    return launches, (circuit, pk, vk), (prover, vk, arrs, r, s), \
        [json.dumps(p.to_dict()) for p in proofs]


def phase_profile(torch, prover, arrs, r, s, stages) -> None:
    """One more prove_arrays under torch.profiler: device busy time per
    kernel name, and the device's idle share of the UNPROFILED step (the
    timed run's stages up to assemble; the profiler's own overhead
    inflates the profiled wall time).  Also the host's side: the PyTorch
    ops and kernel launch calls that one prove_arrays, and its witness
    alone (profiled apart), issue from the host."""
    from torch.profiler import ProfilerActivity, profile

    from zkfranchise_tpu_torch.groth16.device import witness_stage

    def host_counts(events) -> dict:
        cpu = [ev for ev in events
               if ev.device_type == torch.autograd.DeviceType.CPU]
        return {"ops": sum(1 for ev in cpu if ev.name.startswith("aten::")
                           and ev.cpu_parent is None),
                "launch_calls": sum(1 for ev in cpu
                                    if "LaunchKernel" in ev.name),
                "events": len(cpu)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prover.prove_arrays(arrs, r, s)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    inputs = prover._inputs(arrs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as wprof:
        witness_stage(prover.circuit, inputs)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + ev.device_time_total
    busy_s = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    # the sum tree's kernels: fold_padd (every level count) and the mixed
    # add of fold_padd_aa
    folds = {k: v / 1e6 for k, v in kernels.items()
             if "fold_levels_kernel" in k or "PaddAa" in k}
    step_s = sum(v for k, v in stages.items() if k != "finalize")
    emit({"phase": "profile", "profiled_wall_s": wall_s,
          "device_busy_s": busy_s, "unprofiled_step_s": step_s,
          "device_idle_share": 1 - busy_s / step_s,
          "device_events": sum(1 for ev in prof.events()
                               if ev.device_type ==
                               torch.autograd.DeviceType.CUDA),
          "host_prove_arrays": host_counts(prof.events()),
          "host_witness": host_counts(wprof.events()),
          "top_kernels_s": {k: v / 1e6 for k, v in top},
          "fold_kernels_s": folds, "fold_total_s": sum(folds.values())})


# ---------------------------------------------------------------------------
# phase 7: the main path's step as one CUDA graph, and the bench entry
# ---------------------------------------------------------------------------

ROUNDS = 2                              # eager, replay, replay, eager


def _segments(torch, dev, pool=None) -> dict:
    """The caching allocator's segments on `dev` (only those of `pool`, a
    graph_pool_handle, when given), by memory pool and stream: segments,
    their bytes, and their blocks' bytes by state (active_allocated,
    active_pending_free, inactive) beside the bytes the callers asked for
    (requested)."""
    pools: dict = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        if seg["device"] != dev.index or pool is not None and \
                tuple(seg["segment_pool_id"]) != tuple(pool):
            continue
        key = (f"pool {tuple(seg['segment_pool_id'])} "
               f"stream {seg['stream']}")
        group = pools.setdefault(key, {"segments": 0, "bytes": 0,
                                       "blocks": {}})
        group["segments"] += 1
        group["bytes"] += seg["total_size"]
        for block in seg["blocks"]:
            state = group["blocks"].setdefault(
                block["state"], {"count": 0, "bytes": 0, "requested": 0})
            state["count"] += 1
            state["bytes"] += block["size"]
            state["requested"] += block.get("requested_size", 0)
    return pools


def _pool_bytes(torch, dev, pool) -> dict:
    """Segments and bytes of one graph pool, and the bytes of its blocks
    that are allocated."""
    groups = _segments(torch, dev, pool).values()
    return {"segments": sum(g["segments"] for g in groups),
            "bytes": sum(g["bytes"] for g in groups),
            "allocated_bytes": sum(g["blocks"].get("active_allocated", {})
                                   .get("bytes", 0) for g in groups)}


def _allocator(torch, dev) -> dict:
    """The allocator now: memory_stats' current totals and the peak
    allocated since the last reading (the peak is reset here), and the
    segments by pool and stream."""
    stats = torch.cuda.memory_stats(dev)
    out = {k: stats.get(f"{k}.all.current", 0)
           for k in ("allocated_bytes", "reserved_bytes", "active_bytes",
                     "inactive_split_bytes", "segment")}
    out["peak_allocated_bytes"] = stats.get("allocated_bytes.all.peak", 0)
    out["peak_reserved_bytes"] = stats.get("reserved_bytes.all.peak", 0)
    out["alloc_retries"] = stats.get("num_alloc_retries", 0)
    out["segments_by_pool"] = _segments(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return out


def _turns(torch, dev, prover, step, arrs, r, s,
           rounds: int = ROUNDS) -> tuple[dict, dict]:
    """The eager prove_arrays and the replayed step in turns (eager,
    replay, replay, eager; `rounds` rounds), wall and CUDA-event seconds
    of each -> (runs, their medians and proofs/s)."""
    batch = int(r.shape[-1])

    def timed(fn):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn(arrs, r, s)
        end.record()
        torch.cuda.synchronize(dev)
        return {"wall_s": time.perf_counter() - t0,
                "event_s": start.elapsed_time(end) / 1e3}

    runs = {"eager": [], "replay": []}
    for _ in range(rounds):
        for name in ("eager", "replay", "replay", "eager"):
            runs[name].append(timed(prover.prove_arrays if name == "eager"
                                    else step))
    summary = {name: {"wall_s_median": statistics.median(
        x["wall_s"] for x in v), "event_s_median": statistics.median(
        x["event_s"] for x in v)} for name, v in runs.items()}
    for name in runs:
        summary[name]["proofs_per_s"] = batch / summary[name]["wall_s_median"]
    summary["replay_over_eager_wall"] = (summary["replay"]["wall_s_median"]
                                         / summary["eager"]["wall_s_median"])
    return runs, summary


def phase_fused_step(torch, K, dev, prover, vk, arrs, r, s) -> dict:
    """The prover of the main path captured as one CUDA graph at batch 128
    (groth16.device.FusedStep): capture, instantiation, the graph's nodes
    and launches (equal to one prove_arrays' by kernel), its planes equal
    to prove_arrays' for two (r, s) pairs, clones that survive the next
    replay, sampled proofs through the graph, eager and replay timed in
    turns, a replay's device time, memory with the graph alive, and
    tools.bench's line on the same prover.  -> the launches of the path
    (the warm-up run and the capture: a replay ticks no counter)."""
    from torch.profiler import ProfilerActivity, profile

    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import draw_rs
    from zkfranchise_tpu_torch.ops import lm
    from zkfranchise_tpu_torch.tools import bench

    r2, s2 = (torch.as_tensor(x, device=dev) for x in draw_rs(4, BATCH))
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    _allocator(torch, dev)                      # resets the peak
    K.reset_launches()
    want = prover.prove_arrays(arrs, r, s)
    eager_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    want2 = prover.prove_arrays(arrs, r2, s2)
    torch.cuda.synchronize(dev)
    # two eager steps from an emptied cache, then the capture's four
    # points: before the warm-up, after it, after the capture and after
    # the instantiation (each with its peak since the one before)
    memory = {"eager_steps": _allocator(torch, dev)}
    torch.cuda.empty_cache()

    def probe(stage):
        torch.cuda.synchronize(dev)
        memory[stage] = _allocator(torch, dev)

    # the path: counts start at 0 here and are read right after the capture
    K.reset_launches()
    t0 = time.perf_counter()
    step = prover.capture(BATCH, cut=prover.takes_cut(arrs), probe=probe)
    build_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    nodes = step.node_counts()
    emit({"phase": "fused_step", "batch": BATCH, "build_s": build_s,
          "warmup_s": step.warmup_s, "capture_s": step.capture_s,
          "instantiate_s": step.instantiate_s, "graph_nodes": nodes,
          "graph_nodes_total": sum(nodes.values()),
          "graph_launches": step.launches,
          "prove_arrays_launches": eager_launches})
    emit({"phase": "fused_step_memory", "nvidia_smi": smi_line(),
          "graph_pool": str(tuple(step.graph.pool())),
          "current_stream": torch.cuda.current_stream(dev).cuda_stream,
          "readings": memory})
    if step.launches != eager_launches:
        raise AssertionError("the graph's launches differ from one "
                             "prove_arrays'")
    require_launches("fused_step", launches)

    # the replay against prove_arrays, two (r, s) pairs in turn; the
    # clones of the first replay must survive the second
    got = step(arrs, r, s)
    kept = [g.clone() for g in got]
    got2 = step(arrs, r2, s2)
    equal = {"first": all(torch.equal(a, b) for a, b in zip(got, want)),
             "second": all(torch.equal(a, b) for a, b in zip(got2, want2)),
             "first_kept": all(torch.equal(a, b) for a, b in zip(got, kept)),
             "pairs_differ": not torch.equal(got[0], got2[0])}
    emit({"phase": "fused_step", "planes_equal": equal})
    if not all(equal.values()):
        raise AssertionError(f"replay against prove_arrays: {equal}")
    del got, got2, kept, want, want2

    # proofs through the graph, against the committed key
    t0 = time.perf_counter()
    proofs, pubs = step.prove_batch(arrs, seed=1)
    prove_batch_s = time.perf_counter() - t0
    ok = {f"voter_{i}": gverify.verify(vk, proofs[i], pubs[i])
          for i in (0, 42, 85, BATCH - 1)}
    cross = gverify.verify(vk, proofs[0], pubs[1])
    tampered_pub = list(pubs[0])
    tampered_pub[2] = (tampered_pub[2] + 1) % lm.FR.p
    tampered = gverify.verify(vk, proofs[0], tampered_pub)
    emit({"phase": "fused_step", "prove_batch_s": prove_batch_s,
          "accepted": ok, "cross_voter_accepted": cross,
          "tampered_accepted": tampered})
    if not all(ok.values()) or cross or tampered:
        raise AssertionError("fused_step: proof verification failed")

    runs, summary = _turns(torch, dev, prover, step, arrs, r, s)

    # one replay under the profiler: its device busy time
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(arrs, r, s)
        torch.cuda.synchronize(dev)
    dev_events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(ev.device_time_total for ev in dev_events) / 1e6
    emit({"phase": "fused_step", "nvidia_smi": smi_line(), "runs": runs,
          "summary": summary,
          "replay_device_busy_s": busy_s if dev_events else None,
          "replay_device_events": len(dev_events),
          "replay_idle_share": 1 - busy_s / summary["replay"]["wall_s_median"]
          if dev_events else None,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
          "allocated_bytes": torch.cuda.memory_allocated(dev),
          "reserved_bytes": torch.cuda.memory_reserved(dev)})

    # the bench entry's line, on the same prover and graph
    result = bench.measure(prover, vk, arrs, bench.settings()[2], step=step)
    print(json.dumps(result), flush=True)
    if not result["verified"]:
        raise AssertionError("bench: the sampled proof did not verify")
    del step
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: the serving path: a zkey-keyed prover behind ProofStream
# ---------------------------------------------------------------------------

N_VOTERS = 300                          # 2 x 128, then the ladder 32, 8, 4


class _RecordingProver:
    """Stands between ProofStream and a prover (a DeviceProver, or a
    ReplayProver over one): records each slice's size, seed and the kernel
    launches that proved it, and raises in place of slice number
    `fail_after` (a crash between two batches).  Behind a DeviceProver the
    launches are the counts the slice ticked; behind a ReplayProver they
    are those of the captured step that the slice replayed (a replay ticks
    no counter), and `issued` holds what the slice ticked (finalize, and
    the warm-up and capture when the slice's size was new)."""

    def __init__(self, prover, K, fail_after=None):
        self.prover, self.K, self.fail_after = prover, K, fail_after
        self.circuit, self.device = prover.circuit, prover.device
        self.slices = []

    def prove_batch(self, arrs, seed=0):
        if self.fail_after is not None and \
                len(self.slices) >= self.fail_after:
            raise RuntimeError("injected crash")
        steps = getattr(self.prover, "steps", None)
        batch = int(arrs["address"].shape[-1])
        key = (batch, self.prover.prover.takes_cut(arrs)) \
            if steps is not None else None
        new = steps is not None and key not in steps
        before = dict(self.K.LAUNCHES)
        out = self.prover.prove_batch(arrs, seed=seed)
        issued = {k: v - before[k] for k, v in self.K.LAUNCHES.items()
                  if v != before[k]}
        record = {"batch": len(out[0]), "seed": seed, "launches": issued}
        if steps is not None:
            record.update(launches=steps[key].launches, issued=issued,
                          captured=new)
        self.slices.append(record)
        return out


def _tree_bytes(root: pathlib.Path) -> dict:
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _serve(torch, K, prover, voters, out, sink, batch, tail) -> dict:
    """ProofStream over `prover` (wrapped in _RecordingProver) at `batch` on
    a fresh directory: a crash in place of the third slice (cursor 2 x
    batch), a resume over the slices `tail` and a third run that must be a
    no-op.  -> the two recorders and the wall seconds from the first run's
    start to the resumed run's end."""
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    n = len(voters)
    first = _RecordingProver(prover, K, fail_after=2)
    s1 = ProofStream(first, out, batch_size=batch, metrics=Metrics(sink=sink))
    crashed = False
    t0 = time.perf_counter()
    try:
        s1.run(voters, seed=1)
    except RuntimeError as e:
        crashed = str(e) == "injected crash"
    if not crashed or s1.cursor != 2 * batch:
        raise AssertionError(f"stream: expected a crash at cursor "
                             f"{2 * batch}, got cursor {s1.cursor}")
    # a fresh stream on the same directory resumes over the tail
    second = _RecordingProver(prover, K)
    s2 = ProofStream(second, out, batch_size=batch, metrics=Metrics(sink=sink))
    produced = s2.run(voters, seed=1)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    sizes = [x["batch"] for x in second.slices]
    done = sorted(d.name for d in out.iterdir() if d.is_dir())
    if (produced, sizes, s2.cursor) != (sum(tail), tail, n) or \
            done != [f"proof_{i:08d}" for i in range(n)]:
        raise AssertionError(f"stream resume: produced {produced}, "
                             f"slices {sizes}, cursor {s2.cursor}, "
                             f"{len(done)} proof directories")
    launches = dict(K.LAUNCHES)
    third = _RecordingProver(prover, K)
    if ProofStream(third, out, batch_size=batch,
                   metrics=Metrics(sink=sink)).run(voters, seed=1) or \
            third.slices or dict(K.LAUNCHES) != launches:
        raise AssertionError("stream: a third run was not a no-op")
    return {"first": first, "second": second, "stream_s": stream_s}


def _rates(sink) -> list:
    """The stream's prove_batch records, one a slice that was proven: of
    two with one base (a crash in place of a slice, then its resume) the
    later."""
    by_base = {r["base"]: r
               for r in map(json.loads, sink.getvalue().splitlines())
               if r["kind"] == "stage" and r["stage"] == "prove_batch"}
    return [{"batch": r["batch"], "seconds": r["seconds"],
             "proofs_per_s": r["batch"] / r["seconds"]}
            for r in by_base.values()]


def phase_stream(torch, K, dev, circuit, pk, vk) -> dict:
    """The serving path: a prover keyed from zkey bytes alone behind
    ProofStream, proving every slice on a captured step (ReplayProver:
    sizes 128, 32, 8 and 4 each captured once, across the crash, into one
    pool), then the same stream on the eager prover in the same process:
    the two trees of files must be equal byte for byte (_stream_pair).
    -> the launches of the captured stream's run (its warm-ups, captures
    and finalize)."""
    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.utils import serialize, zkey_compat

    vk_path = ROOT / "artifacts" / "zkCensus" / "dev" / str(N_LEVELS) / \
        "verification_key.json"
    # (a) the dev key as a producer-ordered zkey, through bytes and back
    seconds = {}
    t0 = time.perf_counter()
    z = zkey_compat.export_in_ordering(
        zkey_compat.zkey_from_pk(circuit.cs, pk, vk),
        zkey_compat.census_circom_perm(circuit.cs))
    seconds["zkey_export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = serialize.write_zkey(z)
    seconds["zkey_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = serialize.read_zkey(data)
    seconds["zkey_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zpk, zvk, arrays = zkey_compat.ingest_zkey(data, cs=circuit.cs,
                                               ordering="census-circom")
    seconds["zkey_ingest"] = time.perf_counter() - t0   # reads again
    if "c" in arrays:
        raise AssertionError("an ingested zkey carries no C matrix")
    if raw.a_g1 == zpk.a_g1:
        raise AssertionError("the producer ordering did not reorder A")
    if zvk.to_dict() != json.loads(vk_path.read_text()):
        raise AssertionError("ingested vk differs from the committed vk")
    t0 = time.perf_counter()
    prover = DeviceProver(circuit, zpk, arrays=arrays, device=dev)
    seconds["prover_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    voters = inp.mock_batch(N_LEVELS, N_VOTERS, seed=7, device=dev)
    seconds["mock_batch"] = time.perf_counter() - t0
    emit({"phase": "stream_setup", "zkey_bytes": len(data),
          "zkey_points": sum(len(t) for t in (z.a_g1, z.b_g1, z.b_g2,
                                              z.c_g1, z.h_g1, z.ic)),
          "zkey_coeffs": len(z.coeffs),
          "nnz": {k: int(arrays[k][0].shape[0]) for k in ("a", "b")},
          "seconds": seconds})
    del z, raw, data
    # the first batch, the batch before the crash, and each slice of the
    # resumed tail
    return _stream_pair(torch, K, dev, "stream", prover, voters, BATCH,
                        [32, 8, 4], vk_path,
                        (0, 200, 256, 287, 288, 295, 296, 299))


def _stream_pair(torch, K, dev, name, prover, voters, batch, tail, vk_path,
                 sample) -> dict:
    """Phase `name`'s stream: `voters` through ProofStream at `batch` with a
    crash and a resume over the slices `tail` (_serve), every slice on a
    captured step (ReplayProver: batch and each size of tail captured once,
    in that order, into one pool), then the same stream on the eager
    `prover` in the same process: the two trees of files must be equal
    byte for byte; each size's captured launches equal one eager
    prove_arrays' at that size; the proof files of the voters in `sample`
    verify against the key at `vk_path` and a cross-voter pair does not.
    One line: each capture's seconds, nodes and pool bytes, the peaks,
    each stream's seconds and proofs/s by slice and over all voters.  The
    counts are set to 0 before the captured stream and read after its
    no-op run.  -> those launches (its warm-ups, captures and
    finalize)."""
    import io
    import tempfile

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import ReplayProver, draw_rs

    n_levels, n_voters = prover.circuit.n_levels, len(voters)
    # the shared pool and the process after each capture
    pool_after = {}

    def probe(size, stage):
        if stage == "instantiate":
            pool_after[size] = {
                "pool": _pool_bytes(torch, dev, replay.pool),
                "reserved_bytes": torch.cuda.memory_reserved(dev),
                "allocated_bytes": torch.cuda.memory_allocated(dev)}

    replay = ReplayProver(prover, probe=probe)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # (b) the path: counts start at 0 here and are read right after
        # the captured stream's crash, resume and no-op run
        graph_sink, eager_sink = io.StringIO(), io.StringIO()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        graph = _serve(torch, K, replay, voters, tmp / "graph", graph_sink,
                       batch, tail)
        launches = dict(K.LAUNCHES)
        graph_memory = {
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
            "pool": _pool_bytes(torch, dev, replay.pool)}
        cut = prover.cut is not None
        if list(replay.steps) != [(b, cut) for b in (batch, *tail)]:
            raise AssertionError(f"{name}: steps captured "
                                 f"{list(replay.steps)}, expected each of "
                                 f"{[batch, *tail]} once, cut {cut}")
        # (c) the same stream on the eager prover, same voters and seed
        torch.cuda.reset_peak_memory_stats(dev)
        eager = _serve(torch, K, prover, voters, tmp / "eager", eager_sink,
                       batch, tail)
        eager_memory = {
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)}
        trees = [_tree_bytes(tmp / run) for run in ("graph", "eager")]
        if trees[0] != trees[1] or len(trees[0]) != 2 * n_voters + 1:
            differ = sorted(k for k in set(trees[0]) | set(trees[1])
                            if trees[0].get(k) != trees[1].get(k))
            raise AssertionError(f"{name}: the captured stream's files "
                                 f"differ from the eager stream's: "
                                 f"{differ[:8]} ({len(differ)} in all)")
        # (d) each size's captured launches against one eager prove_arrays
        # at that size on the same prover
        eager_step = {}
        for size, _ in replay.steps:
            arrs = inp.batch_to_arrays(voters[:size], n_levels)
            r, s = (torch.as_tensor(x, device=dev)
                    for x in draw_rs(1, size))
            before = dict(K.LAUNCHES)
            prover.prove_arrays(arrs, r, s)
            eager_step[size] = {k: v - before[k]
                                for k, v in K.LAUNCHES.items()
                                if v != before[k]}
        torch.cuda.synchronize(dev)

        # (e) sampled proof files against the committed key
        def files(i):
            d = tmp / "graph" / f"proof_{i:08d}"
            return str(d / "proof.json"), str(d / "signals.json")

        t0 = time.perf_counter()
        accepted = {f"voter_{i}": gverify.verify_files(str(vk_path),
                                                       *files(i))
                    for i in sample}
        cross = gverify.verify_files(str(vk_path), files(0)[0], files(1)[1])
        verify_s = time.perf_counter() - t0
    capture_s = {b: st.warmup_s + st.capture_s + st.instantiate_s
                 for (b, _), st in replay.steps.items()}
    captures = {b: {"warmup_s": st.warmup_s, "capture_s": st.capture_s,
                    "instantiate_s": st.instantiate_s,
                    "total_s": capture_s[b],
                    "graph_nodes": st.node_counts(),
                    "launches": st.launches,
                    "launches_equal_prove_arrays":
                        st.launches == eager_step[b],
                    **pool_after[b]}
                for (b, _), st in replay.steps.items()}
    captures_s = sum(capture_s.values())
    streams = {}
    for run, served, sink in (("graph", graph, graph_sink),
                              ("eager", eager, eager_sink)):
        streams[run] = {
            "slices": served["first"].slices + served["second"].slices,
            "rates": _rates(sink), "stream_s": served["stream_s"],
            "proofs_per_s": n_voters / served["stream_s"]}
    # a slice that met a new size paid its capture: the seconds without it
    for rate, sl in zip(streams["graph"]["rates"],
                        streams["graph"]["slices"]):
        if sl["captured"]:
            rate["capture_s"] = capture_s[sl["batch"]]
            rate["without_capture_s"] = rate["seconds"] - rate["capture_s"]
    proving_s = graph["stream_s"] - captures_s
    streams["graph"].update(captures_s=captures_s, proving_s=proving_s,
                            proofs_per_s_without_captures=n_voters /
                            proving_s)
    emit({"phase": name, "nvidia_smi": smi_line(), "nlevels": n_levels,
          "batch": batch, "voters": n_voters,
          "captured_sizes": [b for b, _ in replay.steps],
          "captured_cut": [c for _, c in replay.steps], "captures": captures,
          "graph_memory": graph_memory, "eager_memory": eager_memory,
          "files_equal": True, "files": len(trees[0]),
          "streams": streams,
          "launches": {k: v for k, v in launches.items() if v},
          "accepted": accepted, "cross_voter_accepted": cross,
          "verify_s": verify_s})
    if not all(accepted.values()) or cross:
        raise AssertionError(f"{name}: proof verification failed")
    unequal = [b for b, c in captures.items()
               if not c["launches_equal_prove_arrays"]]
    if unequal:
        raise AssertionError(f"{name}: the captured launches at sizes "
                             f"{unequal} differ from one prove_arrays'")
    require_launches(name, launches)
    del replay, graph
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: nlevels=160 at batch 16, the package's default configuration
# ---------------------------------------------------------------------------

N_LEVELS_160, BATCH_160 = 160, 16       # config.Config's defaults


def _counts(K) -> dict:
    """The launch counters now, by kernel and by shape."""
    return {"launches": dict(K.LAUNCHES), "mont": dict(K.MONT_SHAPES),
            "padd": dict(K.PADD_SHAPES), "fold": dict(K.FOLD_SHAPES)}


def _since(K, before: dict) -> dict:
    """What the counters gained since `before` (_counts), zeros left out."""
    now = _counts(K)
    return {name: {k: v - before[name].get(k, 0)
                   for k, v in sorted(now[name].items())
                   if v != before[name].get(k, 0)}
            for name in now}


def _spmv_chunks(nnz: int) -> int:
    """The chunks sparse.spmv streams nnz nonzeros in."""
    from zkfranchise_tpu_torch.ops.sparse import MAX_NNZ_CHUNK

    return 1 if nnz <= 2 * MAX_NNZ_CHUNK else -(-nnz // MAX_NNZ_CHUNK)


def _planned_folds(tables, B: int, G=None) -> dict:
    """msm_lm.msm_fold_launches summed over the MSM tables [(rows, kind)]
    (DeviceProver.msm_rows) at batch B, keys sorted."""
    from zkfranchise_tpu_torch.ops import msm_lm

    planned: dict = {}
    for rows, kind in tables:
        for key, v in msm_lm.msm_fold_launches(rows, B, kind, G).items():
            planned[key] = planned.get(key, 0) + v
    return dict(sorted(planned.items()))


def _fold_widths(planned: dict) -> tuple[list, list, list]:
    """msm_lm.msm_fold_launches keys -> fold_shapes.run's shapes (one
    level) and levels (several a launch), and run_gathered's shapes (level
    0, fold_padd_aa through the index)."""
    shapes, levels, gathered = [], [], []
    for key in planned:
        name, kind, b, h, n = key.split("/")
        B, h, n = int(b[1:]), int(h[1:]), int(n[1:])
        if name == "fold_padd_aa":
            gathered.append((kind, B, h))
        elif n == 1:
            shapes.append(("fold", kind, B, h))
        else:
            levels.append((kind, B, h, n))
    return shapes, levels, gathered


def _check_folds(dev, planned: dict, failed: list) -> None:
    """Every fold launch of `planned` (msm_fold_launches keys) against its
    plain version, untimed, in the form the MSM launches it."""
    from zkfranchise_tpu_torch.tools import fold_shapes

    shapes, levels, gathered = _fold_widths(planned)
    fold_shapes.run(dev, shapes, levels, failed, timed=False)
    fold_shapes.run_gathered(dev, gathered, failed, timed=False)


def phase_nlevels160(np, torch, K, dev) -> tuple[dict, dict, tuple]:
    """nlevels=160 at batch 16 (config.Config's defaults) through the
    entry points a user calls: the circuit and its dev key derived here
    (the vk equal to the committed dev/160 one; no zkey is read), the eager
    DeviceProver, its step captured through ReplayProver, proofs equal
    byte for byte and verified, eager and replay timed in turns, the
    bench's line; then the kernels at this path's shapes against their
    plain versions.  -> (the path's launches, kernels-line rows, the
    circuit and its dev key (circuit, pk, vk) for phase stream160)."""
    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import qap
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import (DeviceProver,
                                                      ReplayProver, draw_rs)
    from zkfranchise_tpu_torch.models.census import CensusCircuit
    from zkfranchise_tpu_torch.ops import lm, msm_lm, sparse
    from zkfranchise_tpu_torch.tools import bench, kernel_events
    from zkfranchise_tpu_torch.utils.native import Laps

    nl, B = N_LEVELS_160, BATCH_160
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds: dict = {}
    lap = Laps(seconds)
    circuit = CensusCircuit(nl)
    cs = circuit.cs
    lap("circuit")
    arrays = cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public))
    lap("export_arrays")
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    setup_parts: dict = {}
    pk, dev_vk = gsetup.dev_setup(cs, seconds=setup_parts)
    lap("dev_setup")
    vk_committed = json.loads(
        (ROOT / "artifacts" / "zkCensus" / "dev" / str(nl) /
         "verification_key.json").read_text())
    vk_equal = dev_vk.to_dict() == vk_committed
    prover = DeviceProver(circuit, pk, arrays=arrays, device=dev)
    lap("prover_init")
    # the mock voters' leaves lie far above the cut depth: every step of
    # this phase and of stream160 runs on the cut tables
    tables = prover.msm_rows(cut=True)
    emit({"phase": "nlevels160_setup", "nlevels": nl, "batch": B,
          "wires": cs.num_vars, "constraints": cs.num_constraints,
          "domain": pk.domain,
          "nnz": {k: int(arrays[k][0].shape[0]) for k in ("a", "b", "c")},
          "spmv_chunks": {k: _spmv_chunks(int(arrays[k][0].shape[0]))
                          for k in ("a", "b", "c")},
          "msm_tables_full": {k: rows for k, (rows, _) in
                              prover.msm_rows().items()},
          "msm_tables": {k: rows for k, (rows, _) in tables.items()},
          "msm_leaves": prover.msm_leaves(cut=True),
          "msm_chunks": {k: [{"real": real, "padded": m,
                              "window_group": msm_lm.default_window_group(
                                  m, B, dev)}
                             for _, real, m in msm_lm._chunks(rows)]
                         for k, (rows, _) in tables.items()},
          "seconds": seconds, "dev_setup_parts": setup_parts,
          "vk_equals_committed": vk_equal})
    if not vk_equal:
        raise AssertionError("nlevels160: the dev setup's vk differs from "
                             "the committed dev/160 vk")
    vk = gverify.VerifyingKey(vk_committed)

    # the path: counts start at 0 here and are read right after the
    # captured step's proofs
    K.reset_launches()
    t0 = time.perf_counter()
    arrs = inp.batch_to_arrays(inp.mock_batch(nl, B, seed=7, device=dev), nl)
    seconds["inputs"] = time.perf_counter() - t0
    if not prover.takes_cut(arrs):
        raise AssertionError("nlevels160: the mock voters do not take the "
                             "cut tables")
    t0 = time.perf_counter()
    proofs, pubs = prover.prove_batch(arrs, seed=1)
    torch.cuda.synchronize(dev)
    seconds["first_prove_batch"] = time.perf_counter() - t0
    r, s = (torch.as_tensor(x, device=dev) for x in draw_rs(3, B))
    before = _counts(K)
    stages: dict = {}
    t0 = time.perf_counter()
    prover.prove_arrays(arrs, r, s, stage_seconds=stages)
    seconds["timed_prove_arrays"] = time.perf_counter() - t0
    one = _since(K, before)
    eager_memory = {"peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
                    "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)}
    proofs2, pubs2 = prover.prove_batch(arrs, seed=2)
    planned = _planned_folds(tables.values(), B, prover.window_group)
    emit({"phase": "nlevels160_eager", "nvidia_smi": smi_line(),
          "stage_seconds": stages, "step_s": sum(stages.values()),
          "proofs_per_s": B / sum(stages.values()),
          "launches_per_prove_arrays": one["launches"],
          "mont_launches_by_shape": one["mont"],
          "padd_launches_by_shape": one["padd"],
          "fold_launches_by_shape": one["fold"],
          "fold_launches_planned": planned, **eager_memory,
          "seconds": seconds})
    if one["fold"] != planned:
        raise AssertionError("nlevels160: fold launches differ from the MSM "
                             "plan's count")

    # the step captured at first use, into the ReplayProver's pool
    pool_after = {}

    def probe(batch, stage):
        if stage == "instantiate":
            pool_after.update(_pool_bytes(torch, dev, replay.pool),
                              reserved_bytes=torch.cuda.memory_reserved(dev))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    replay = ReplayProver(prover, probe=probe)
    t0 = time.perf_counter()
    got, got_pubs = replay.prove_batch(arrs, seed=1)
    seconds["first_replay_prove_batch"] = time.perf_counter() - t0
    got2, got_pubs2 = replay.prove_batch(arrs, seed=2)
    launches = dict(K.LAUNCHES)
    step = replay.steps[B, True]
    nodes = step.node_counts()

    def text(ps):
        return [json.dumps(p.to_dict()) for p in ps]

    equal = {"seed_1": text(got) == text(proofs) and got_pubs == pubs,
             "seed_2": text(got2) == text(proofs2) and got_pubs2 == pubs2,
             "seeds_differ": text(proofs) != text(proofs2)}
    emit({"phase": "nlevels160_capture", "warmup_s": step.warmup_s,
          "capture_s": step.capture_s, "instantiate_s": step.instantiate_s,
          "graph_nodes": nodes, "graph_nodes_total": sum(nodes.values()),
          "graph_launches": step.launches,
          "launches_equal_prove_arrays": step.launches == one["launches"],
          "pool": pool_after,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
          "proofs_equal_eager": equal})
    if step.launches != one["launches"]:
        raise AssertionError("nlevels160: the captured launches differ from "
                             "one prove_arrays'")
    if not all(equal.values()):
        raise AssertionError(f"nlevels160: captured proofs against the eager "
                             f"prove_batch's: {equal}")
    require_launches("nlevels160", launches)

    # the same slice on the full tables, after the path's counts were read:
    # the same proofs and signals
    full = prover.finalize(*prover.prove_arrays(
        arrs, *(torch.as_tensor(x, device=dev) for x in draw_rs(1, B)),
        cut=False)[:4])
    cut_equals_full = text(full[0]) == text(proofs) and full[1] == pubs
    torch.cuda.empty_cache()

    # correctness by the repo's own means: the pairing verifier, against
    # the committed key
    t0 = time.perf_counter()
    ok = {f"voter_{i}": gverify.verify(vk, got[i], got_pubs[i])
          for i in (0, B - 1)}
    cross = gverify.verify(vk, got[0], got_pubs[1])
    tampered_pub = list(got_pubs[0])
    tampered_pub[2] = (tampered_pub[2] + 1) % lm.FR.p
    tampered = gverify.verify(vk, got[0], tampered_pub)
    seconds["verify"] = time.perf_counter() - t0
    emit({"phase": "nlevels160_verify", "accepted": ok,
          "cross_voter_accepted": cross, "tampered_accepted": tampered,
          "cut_proofs_equal_full": cut_equals_full})
    if not all(ok.values()) or cross or tampered:
        raise AssertionError("nlevels160: proof verification failed")
    if not cut_equals_full:
        raise AssertionError("nlevels160: the cut tables' proofs differ from "
                             "the full tables'")

    # eager and replay in turns (one round: phase stream160's per-slice
    # rates repeat the reading), one profiled replay, the bench's line
    t0 = time.perf_counter()
    runs, summary = _turns(torch, dev, prover, step, arrs, r, s, rounds=1)
    seconds["turns"] = time.perf_counter() - t0
    for attempt in range(1, 4):
        events, (lead, tail) = kernel_events(lambda: step(arrs, r, s),
                                             runs=1)
        if events:
            break
    busy: dict = {}
    for name, us in events:
        name = name.split("(")[0]
        busy[name] = busy.get(name, 0.0) + us / 1e6
    busy_s = sum(busy.values())
    replay_s = summary["replay"]["wall_s_median"]
    emit({"phase": "nlevels160_turns", "nvidia_smi": smi_line(),
          "runs": runs, "summary": summary,
          "replay_device_busy_s": busy_s, "replay_device_events": len(events),
          "profile_attempts": attempt,
          "sentinels": f"lead {lead}, tail {tail}",
          "replay_idle_share": 1 - busy_s / replay_s if events else None,
          "seconds": seconds,
          "top_kernels_s": dict(sorted(busy.items(),
                                       key=lambda kv: -kv[1])[:10])})
    t0 = time.perf_counter()
    result = bench.measure(prover, vk, arrs, 2, step=step)
    seconds["bench"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)
    if not result["verified"]:
        raise AssertionError("nlevels160: the bench's proof did not verify")
    del replay, step, got, got2
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()

    # the kernels at this path's shapes, against their plain versions
    t0 = time.perf_counter()
    results, table = {}, {}
    check = _checker(torch, results, table)
    rng = np.random.default_rng(160)
    _ntt_levels(np, torch, K, dev, rng, check, results, table,
                n.bit_length() - 1, B, f"ntt_level/{n}x{B}", read_each=False)
    # the chunked spmv of A (6 chunks) against its plain version, both on
    # the card: the plain spmv on the host takes 30-50 s at 16 lanes
    # (tests/test_torch_cuda.py holds the card's against it)
    w = torch.as_tensor(_random_limbs(np, rng, (cs.num_vars, 21, B)),
                        device=dev)
    spmv_equal = bool(torch.equal(
        sparse.spmv(*prover._arrays_dev["a"], n, w),
        sparse.spmv(*prover._arrays_dev["a"], n, w, mul=lm.mont_mul_ref)))
    failed: list = []
    _check_folds(dev, planned, failed)
    seconds["kernel_checks"] = time.perf_counter() - t0
    emit({"phase": "nlevels160_kernels",
          "ntt_levels": table[f"ntt_level/{n}x{B}"]["levels"],
          "spmv_a_equal_plain": spmv_equal,
          "fold_widths": len(planned), "folds_failed": failed,
          "seconds": seconds})
    if not spmv_equal:
        raise AssertionError("nlevels160: the chunked spmv differs from "
                             "its plain version")
    if failed:
        raise AssertionError(f"nlevels160: folds differ from their plain "
                             f"versions: {failed}")
    del prover, w
    torch.cuda.empty_cache()
    return launches, table, (circuit, pk, dev_vk)


# ---------------------------------------------------------------------------
# phase 12: the default deployment served: ProofStream at config.Config()'s
# defaults, keyed from the deployment's zkey bytes
# ---------------------------------------------------------------------------

# 2 batches of 16, then the whole ladder 8, 4, 2, 1
STREAM160_VOTERS, STREAM160_TAIL = 47, [8, 4, 2, 1]
# both full batches, the first voter of each tail slice, the 1-voter slice
STREAM160_SAMPLE = (0, 31, 32, 39, 40, 44, 46)


def _manifest_digest(key_dir: pathlib.Path, name: str) -> str:
    """The sha256 the committed manifest (circuits-info.md beside the
    nlevels directories) gives file `name` of key_dir."""
    text = (key_dir.parent / "circuits-info.md").read_text()
    section = re.search(rf"^### \S+ {key_dir.name}\n((?:- .*\n)+)", text,
                        re.M)
    found = section and re.search(
        rf"^- {re.escape(name)}: `([0-9a-f]{{64}})`", section.group(1), re.M)
    if not found:
        raise AssertionError(f"no digest of {key_dir.name}/{name} in "
                             f"{key_dir.parent / 'circuits-info.md'}")
    return found.group(1)


def phase_stream160(torch, K, dev, circuit, pk, vk) -> dict:
    """The deployment an operator runs as shipped: ProofStream at
    config.Config()'s defaults (nlevels=160, batch 16) from the key of
    Config().artifact_dir.  That key is rebuilt from phase nlevels160's dev
    key as native-ordered zkey bytes (zkey_from_pk, write_zkey) whose
    sha256 must equal the committed file's (the manifest's digest; the
    130 MB file itself does not ride to the card), then ingested (A and B
    only) with its vk equal to the committed one; a DeviceProver keyed from
    it alone serves mock_batch(160, 47, seed=7): a crash at cursor 32 and
    a resume over 8, 4, 2, 1, so every size of the batch-16 ladder is
    captured once into one pool (_stream_pair).  Then the folds at the
    widths the tail sizes launch and batch 16 does not, untimed, against
    their plain versions.  -> the launches of the captured stream's run."""
    import hashlib

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.config import Config
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.utils import serialize, zkey_compat
    from zkfranchise_tpu_torch.utils.native import Laps

    cfg = Config()
    nl, B, key_dir = cfg.n_levels, cfg.batch_size, cfg.artifact_dir
    if circuit.n_levels != nl:
        raise AssertionError(f"stream160: phase nlevels160's circuit has "
                             f"nlevels={circuit.n_levels}, Config() {nl}")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    seconds: dict = {}
    lap = Laps(seconds)
    z = zkey_compat.zkey_from_pk(circuit.cs, pk, vk)
    lap("zkey_from_pk")
    data = serialize.write_zkey(z)
    lap("write_zkey")
    del z
    digest = hashlib.sha256(data).hexdigest()
    lap("sha256")
    committed = _manifest_digest(key_dir, "proving_key.zkey")
    zpk, zvk, arrays = zkey_compat.ingest_zkey(data, cs=circuit.cs,
                                               ordering="native")
    lap("zkey_ingest")
    vk_path = key_dir / "verification_key.json"
    vk_equal = zvk.to_dict() == json.loads(vk_path.read_text())
    has_c = "c" in arrays
    prover = DeviceProver(circuit, zpk, arrays=arrays, device=dev)
    lap("prover_init")
    voters = inp.mock_batch(nl, STREAM160_VOTERS, seed=7, device=dev)
    lap("mock_batch")
    emit({"phase": "stream160_setup", "nlevels": nl, "batch": B,
          "key_dir": str(key_dir),
          "zkey_bytes": len(data), "zkey_sha256": digest,
          "committed_sha256": committed, "zkey_equals_committed":
              digest == committed, "vk_equals_committed": vk_equal,
          "has_c_matrix": has_c,
          "nnz": {k: int(arrays[k][0].shape[0]) for k in ("a", "b")},
          "seconds": seconds})
    del data, zpk, arrays
    if digest != committed:
        raise AssertionError("stream160: the rebuilt zkey differs from the "
                             "committed one")
    if not vk_equal:
        raise AssertionError("stream160: the ingested vk differs from the "
                             "committed dev/160 vk")
    if has_c:
        raise AssertionError("stream160: an ingested zkey carries no C "
                             "matrix")
    launches = _stream_pair(torch, K, dev, "stream160", prover, voters, B,
                            STREAM160_TAIL, vk_path, STREAM160_SAMPLE)

    # the folds the tail sizes launch at the 160 tables that batch 16 does
    # not (phase nlevels160 checks those), against their plain versions
    t0 = time.perf_counter()
    tables = prover.msm_rows(cut=True).values()
    checked = _planned_folds(tables, B, prover.window_group)
    new: dict = {}
    for size in STREAM160_TAIL:
        for key in _planned_folds(tables, size, prover.window_group):
            if key not in checked and key not in new:
                new[key] = size
    del prover
    torch.cuda.empty_cache()
    failed: list = []
    _check_folds(dev, new, failed)
    emit({"phase": "stream160_folds", "sizes": STREAM160_TAIL,
          "fold_widths": len(new),
          "by_size": {b: sum(v == b for v in new.values())
                      for b in STREAM160_TAIL},
          "folds_failed": failed, "seconds": time.perf_counter() - t0})
    if failed:
        raise AssertionError(f"stream160: folds differ from their plain "
                             f"versions: {failed}")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the trusted-setup path: ptau -> proving key on the card, the
# contribution chains, a prove under the contributed key, the entry tools
# ---------------------------------------------------------------------------

# H needs tau^(n+i) for i < n, 2n G1 powers: a transcript of power p
# serves domains up to 2^(p-1), so the flagship's 2^14 takes power 15
PTAU_POWER = 15
# scalar_mul at the path's widths: (group, lanes, scalar per lane)
CEREMONY_LADDERS = [("g1", 8192, True), ("g1", 16384, False),
                    ("g1", 88218, True), ("g1", 165476, True),
                    ("g2", 8192, True), ("g2", 165476, True)]


def _tree_digest(root: pathlib.Path) -> str:
    import hashlib

    h = hashlib.sha256()
    for path in sorted(root.rglob("*")):
        if path.is_file():
            st = path.stat()
            h.update(f"{path.relative_to(root)} {st.st_size} "
                     f"{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


def _host_estimate(ptau, cs, n: int) -> dict:
    """The native route's seconds for one pk_from_ptau at this size,
    worked out from timed native batches on this machine's host: one
    EC-iNTT stage at n/2 G1 lanes (a scaling batch by the stage's
    twiddles and two add batches), and a G2 scaling and add batch at 1024
    lanes; times the scalings and adds the route makes (five EC-iNTTs of
    log2 n stages and a final scale, the six wire sums, the k, pre and H
    scalings, K's adds and the tau^(n+i) - tau^i subtraction)."""
    import random

    from zkfranchise_tpu_torch.groth16 import ceremony, qap
    from zkfranchise_tpu_torch.utils import native

    rng = random.Random(5)
    half, g2_lanes = n // 2, 1024
    tws = [rng.randrange(ceremony.P) for _ in range(half)]
    t0 = time.perf_counter()
    t = native.g1_scale_batch(tws, ptau.tau_g1[half:n])
    t1 = time.perf_counter()
    native.g1_add_batch(ptau.tau_g1[:half], t)
    native.g1_add_batch(ptau.tau_g1[:half],
                        [ceremony._g1_neg(p) for p in t])
    t2 = time.perf_counter()
    t = native.g2_scale_batch(tws[:g2_lanes], ptau.tau_g2[:g2_lanes])
    t3 = time.perf_counter()
    native.g2_add_batch(ptau.tau_g2[:g2_lanes], t)
    t4 = time.perf_counter()
    per = {"g1_scale": (t1 - t0) / half, "g1_add": (t2 - t1) / (2 * half),
           "g2_scale": (t3 - t2) / g2_lanes, "g2_add": (t4 - t3) / g2_lanes}
    ent = [len(e[1]) for e in ceremony._entries(cs)]
    m, npub = cs.num_vars, cs.num_public
    log_n = n.bit_length() - 1
    intt_scale, intt_add = log_n * half + n, log_n * n
    counts = {
        "g1_scale": 4 * intt_scale + 2 * ent[0] + 2 * ent[1] + ent[2] +
        (m - npub - 1) + 2 * n,
        "g2_scale": intt_scale + ent[1],
        "g1_add": 4 * intt_add + 2 * ent[0] + 2 * ent[1] + ent[2] + 2 * m + n,
        "g2_add": intt_add + ent[1]}
    assert qap.domain_size(cs.num_constraints, npub) == n
    return {"ceremony_host_estimate_s": sum(per[k] * counts[k]
                                            for k in counts),
            "per_point_s": per, "counts": counts,
            "timed": {"g1_stage_lanes": half, "g1_stage_s": t2 - t0,
                      "g2_lanes": g2_lanes, "g2_s": t4 - t2}}


def _ceremony_ladders(np, torch, K, dev, ptau) -> list:
    """scalar_mul at the ceremony's widths, 254 bits: device ms from
    torch.profiler (two calls), whole-call ms by CUDA events, the bound
    from the adds the scalars need (a doubling a bit and an add a set bit
    a lane); at 8192 lanes also held against the plain version."""
    from zkfranchise_tpu_torch.ops import ec_batch
    from zkfranchise_tpu_torch.tools import EMPTY_PAUSE_S, EMPTY_WINDOWS, \
        add_mads, bound_ms, event_ms, kernel_events

    rng = np.random.default_rng(11)
    rows_out = []
    for kind, T, per_lane in CEREMONY_LADDERS:
        rows = 63 if kind == "g1" else 126
        src = ptau.tau_g1 if kind == "g1" else ptau.tau_g2
        base = ec_batch.to_plane(src[:min(T, 8192)], kind, dev)
        pts = base.repeat(1, -(-T // base.shape[1]))[:, :T].contiguous()
        scalars = [int.from_bytes(rng.bytes(32), "big") % (1 << 254)
                   for _ in range(T if per_lane else 1)]
        bits = ec_batch.scalar_bits(scalars, 254)
        bits_t = torch.as_tensor(bits if per_lane else bits[:, 0].copy(),
                                 device=dev)
        set_bits = int(bits.sum()) * (1 if per_lane else T)
        adds = 254 * T + set_bits

        def fn():
            return K.scalar_mul(pts, bits_t, kind)

        row = {"kernel": "scalar_mul", "kind": kind, "lanes": T,
               "bits": 254, "per_lane": per_lane}
        if T == 8192:
            want = K.scalar_mul_ref(pts, bits_t, kind)
            row["equal_to_plain"] = bool(torch.equal(fn(), want))
            if not row["equal_to_plain"]:
                raise AssertionError(f"scalar_mul {kind} at {T} lanes "
                                     f"differs from scalar_mul_ref")
            del want
        # a window the profiler failed to trace is profiled again, as
        # tools.device_reading does; a reading still short is None
        for attempt in range(1, EMPTY_WINDOWS + 1):
            events, _ = kernel_events(fn, runs=2)
            ours = [us for name, us in events if "ladder" in name]
            if len(ours) == 2:
                break
            time.sleep(EMPTY_PAUSE_S)
        row["device_ms"] = sum(ours) / 2 / 1e3 if len(ours) == 2 else None
        row["device_attempts"] = attempt
        row["ms"] = event_ms(fn, runs=2, warmup=0)
        nbytes = 4 * (2 * rows * T + bits_t.numel())
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, add_mads("padd", kind) * adds)
        row["adds"] = adds
        row["bound_share"] = _ratio(row["bound_ms"], row["device_ms"])
        row["blocks"] = -(-T // 32)
        rows_out.append(row)
        emit({"phase": "ceremony_ladder", **row})
        del pts, base, bits_t
    return rows_out


def phase_ceremony(np, torch, K, dev, circuit, pk_dev, vk) -> dict:
    """The trusted-setup path at the flagship's width (CensusCircuit(16),
    domain 2^14), with no cut: a dev transcript of power 15 on the host;
    pk_from_ptau on the card equal to the main path's dev_setup key point
    for point and its vk to the committed one; a phase-1 chain on the card
    (two contributions and a beacon) verified with and without the
    intermediate transcripts, a reordered chain rejected; a key from the
    contributed transcript and a phase-2 chain on it (two contributions and
    a beacon), verified; a prover keyed from the final key proving
    mock_batch(16, 128, seed=7), sampled proofs accepted under the
    contributed vk and rejected under the earlier ones; the two entry tools
    at nlevels=4 into a temporary directory, artifacts/ unchanged.
    Launches are counted over the key derivations and the chains (path
    "ceremony") and over the prove and the tools (path "ceremony_prove")."""
    import tempfile

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import ceremony, contribute
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.tools import client_prove, compile_circuit

    torch.cuda.empty_cache()
    cs = circuit.cs
    n = pk_dev.domain
    seconds = {}
    t0 = time.perf_counter()
    ptau = ceremony.dev_ptau(PTAU_POWER)
    seconds["dev_ptau_host"] = time.perf_counter() - t0
    estimate = _host_estimate(ptau, cs, n)
    emit({"phase": "ceremony_host_estimate", "nvidia_smi": smi_line(),
          **estimate})

    # the path: counts start at 0 here
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = {}
    t0 = time.perf_counter()
    pk0, vk0 = ceremony.pk_from_ptau(ptau, cs, device=dev,
                                     seconds=steps)
    seconds["pk_from_ptau"] = time.perf_counter() - t0
    same = {f: getattr(pk0, f) == getattr(pk_dev, f)
            for f in ceremony.PK_FIELDS}
    vk_same = vk0.to_dict() == vk.to_dict()
    emit({"phase": "ceremony_pk", "nlevels": N_LEVELS, "domain": n,
          "wires": cs.num_vars, "ptau_power": PTAU_POWER,
          "entries": [len(e[1]) for e in ceremony._entries(cs)],
          "seconds": seconds["pk_from_ptau"], "steps": steps,
          "equal_to_dev_setup": same, "vk_equals_committed": vk_same,
          "host_estimate_over_card": _ratio(
              estimate["ceremony_host_estimate_s"],
              seconds["pk_from_ptau"])})
    if not all(same.values()) or not vk_same:
        raise AssertionError("ceremony: the card's key differs from "
                             "dev_setup's")

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    h0 = contribute.GENESIS
    p1, c1 = timed("phase1_contribute_1", contribute.phase1_contribute,
                   ptau, b"entropy-A", h0, device=dev)
    p2, c2 = timed("phase1_contribute_2", contribute.phase1_contribute,
                   p1, b"entropy-B", c1.new_hash, device=dev)
    p3, c3 = timed("phase1_beacon", contribute.phase1_beacon, p2,
                   "00deadbeef", c2.new_hash, n_iters=64, device=dev)
    cons = [c1, c2, c3]
    ok1 = timed("verify_phase1_intermediate",
                contribute.verify_phase1_chain, ptau, p3, cons,
                intermediate=[p1, p2])
    ok1b = timed("verify_phase1", contribute.verify_phase1_chain, ptau, p3,
                 cons)
    swapped = timed("verify_phase1_reordered",
                    contribute.verify_phase1_chain, ptau, p3,
                    [c2, c1, c3], intermediate=[p1, p2])
    del p1, p2
    # the key from the contributed transcript, under torch.profiler: the
    # derivation's device busy time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pk_c, vk_c = timed("pk_from_contributed_ptau_profiled",
                           ceremony.pk_from_ptau, p3, cs, device=dev)
    busy = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.split("(")[0]
            busy[name] = busy.get(name, 0.0) + ev.device_time_total / 1e6
    busy_s = sum(busy.values())
    emit({"phase": "ceremony_profile", "device_busy_s": busy_s,
          "profiled_wall_s": seconds["pk_from_contributed_ptau_profiled"],
          "device_idle_share_of_unprofiled": 1 - busy_s /
          seconds["pk_from_ptau"],
          "top_kernels_s": dict(sorted(busy.items(),
                                       key=lambda kv: -kv[1])[:10])})
    del prof
    pk1, d1 = timed("phase2_contribute_1", contribute.phase2_contribute,
                    pk_c, b"delta-A", c3.new_hash, device=dev)
    pk2, d2 = timed("phase2_contribute_2", contribute.phase2_contribute,
                    pk1, b"delta-B", d1.new_hash, device=dev)
    pk3, d3 = timed("phase2_beacon", contribute.phase2_beacon, pk2,
                    "00cafe", d2.new_hash, n_iters=64, device=dev)
    ok2 = timed("verify_phase2", contribute.verify_phase2_chain, pk_c, pk3,
                [d1, d2, d3], c3.new_hash)
    launches = dict(K.LAUNCHES)
    by_shape = {"scalar_mul": dict(sorted(K.SCALAR_SHAPES.items())),
                "padd": dict(sorted(K.PADD_SHAPES.items())),
                "mont_mul": dict(sorted(K.MONT_SHAPES.items()))}
    peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "ceremony_chains", "phase1_verified": ok1,
          "phase1_verified_without_intermediates": ok1b,
          "reordered_accepted": swapped, "phase2_verified": ok2,
          "pk_contributed_equals_dev": pk_c.a_g1 == pk_dev.a_g1,
          "launches": {k: v for k, v in launches.items() if v},
          "launches_by_shape": by_shape, "peak_memory_bytes": peak})
    if not (ok1 and ok1b and ok2) or swapped:
        raise AssertionError("ceremony: chain verification failed")
    if pk_c.a_g1 == pk_dev.a_g1:
        raise AssertionError("ceremony: contributions left the key as it was")
    require_launches("ceremony", launches)
    del pk1, pk2, p3

    # a prover keyed from the final key; counts start at 0 again
    K.reset_launches()
    vk_final = gverify.VerifyingKey(
        {**vk_c.to_dict(), "vk_delta_2": gsetup._g2j(pk3.delta_g2)})
    prover = timed("prover_init", DeviceProver, circuit, pk3, device=dev)
    batch = inp.mock_batch(N_LEVELS, BATCH, seed=7, device=dev)
    arrs = inp.batch_to_arrays(batch, N_LEVELS)
    proofs, pubs = timed("prove", prover.prove_batch, arrs, seed=1)
    t0 = time.perf_counter()
    accepted = {f"voter_{i}": gverify.verify(vk_final, proofs[i], pubs[i])
                for i in (0, BATCH // 2, BATCH - 1)}
    rejected_pre_phase2 = not gverify.verify(vk_c, proofs[0], pubs[0])
    rejected_dev_vk = not gverify.verify(vk0, proofs[0], pubs[0])
    seconds["verify_proofs"] = time.perf_counter() - t0
    del prover, arrs
    torch.cuda.empty_cache()
    # the two entry tools, into a temporary directory only
    art = ROOT / "artifacts"
    before = _tree_digest(art)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        rc_compile = timed("compile_circuit_nl4", compile_circuit.main,
                           ["--out", str(tmp / "c"), "--nlevels", "4"])
        rc_client = timed("client_prove_nl4", client_prove.main,
                          ["--out", str(tmp / "p"), "--key-dir",
                           str(tmp / "c" / "zkCensus" / "dev" / "4"),
                           "--nlevels", "4"])
        written = sorted(str(p.relative_to(tmp)) for p in tmp.rglob("*")
                         if p.is_file())
    unchanged = _tree_digest(art) == before
    prove_launches = dict(K.LAUNCHES)
    emit({"phase": "ceremony_prove", "accepted": accepted,
          "rejected_under_pre_phase2_vk": rejected_pre_phase2,
          "rejected_under_dev_vk": rejected_dev_vk,
          "tools_rc": [rc_compile, rc_client], "tools_wrote": written,
          "artifacts_unchanged": unchanged,
          "launches": {k: v for k, v in prove_launches.items() if v}})
    if not all(accepted.values()) or not rejected_pre_phase2 or \
            not rejected_dev_vk:
        raise AssertionError("ceremony: proofs under the contributed key")
    if rc_compile or rc_client or not unchanged:
        raise AssertionError("ceremony: entry tools failed or wrote into "
                             "artifacts/")
    require_launches("ceremony_prove", prove_launches)

    ladders = _ceremony_ladders(np, torch, K, dev, ptau)
    emit({"phase": "ceremony", "nvidia_smi": smi_line(),
          "seconds": seconds, "pk_from_ptau_steps": steps,
          "ceremony_host_estimate_s": estimate["ceremony_host_estimate_s"],
          "peak_memory_bytes": peak,
          "ladder_resident_blocks_per_sm": K.ladder_occupancy(),
          "ladders": ladders})
    return {"ceremony": launches, "ceremony_prove": prove_launches}


# ---------------------------------------------------------------------------
# phase 10: the sharded prover, four ranks sharing the card
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4                       # a (data 1, model 4) mesh
# (1, 2) left out to pay for the captured step and (2, 2) for phase
# stream160: (1, 4) runs the same model-axis collectives, and the data
# axis is held on the CPU (tests/test_torch_sharded_prover.py at (2, 2))
SWEEP_MESHES = [(1, 1), (1, 4)]
# 12 all_to_all of the distributed NTT, the quotient's all_gather and one
# an MSM: 17 collectives, so 18 stretches at (1, 4)
SHARDED_STRETCHES = 18


def phase_sharded(torch, K, dev, circuit, pk, vk, arrs,
                  main_proofs) -> tuple:
    """The main path's configuration through parallel.prove.ShardedProver
    on four ranks that share the card over gloo: the proofs equal the main
    path's; launches summed over the ranks (each counts from 0 just before
    its prove_batch and reads just after).  Then, on the same ranks, the
    step captured (_sharded_capture), and the two entry tools.  -> (the
    eager launches, the capture's), each summed over the ranks."""
    import tempfile

    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.parallel import jobs, launch
    from zkfranchise_tpu_torch.tools import dryrun_multichip, scaling_sweep

    torch.cuda.empty_cache()
    n = pk.domain
    with tempfile.TemporaryDirectory() as tmp:
        key = pathlib.Path(tmp) / "proving_key.pkl"
        t0 = time.perf_counter()
        pk.save(key)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        job = functools.partial(
            jobs.prove_job, steps=1, ntt_check=(n.bit_length() - 1, BATCH, 5),
            capture=True)
        ranks = launch.run(
            job, SHARDED_RANKS, backend="gloo", timeout_s=600,
            args=(str(key), N_LEVELS, arrs, 1, SHARDED_RANKS, "cuda"))
        wall_s = time.perf_counter() - t0
    launches: dict = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    proofs = ranks[0]["proofs"]
    pubs = ranks[0]["publics"]
    same = proofs == main_proofs
    sample = [0, BATCH // 2, BATCH - 1]
    accepted = {f"voter_{i}": gverify.verify(
        vk, gverify.Proof.from_json(proofs[i]), pubs[i]) for i in sample}
    cross = gverify.verify(vk, gverify.Proof.from_json(proofs[0]), pubs[1])
    check = ranks[0]["ntt_check"]
    staged = any(r["staged_through_host"] for r in ranks)
    handed = sorted({d for r in ranks for d in r["collective_tensor_devices"]})
    emit({"phase": "sharded", "nvidia_smi": smi_line(),
          "mesh": ranks[0]["mesh"], "ranks": SHARDED_RANKS,
          "backend": "gloo", "ranks_per_card": SHARDED_RANKS,
          "staged_through_host": staged,
          "collective_tensor_devices": handed, "key_save_s": save_s,
          "wall_s": wall_s, "proofs_equal_main_path": same,
          "accepted": accepted, "cross_voter_accepted": cross,
          "ntt_check": check,
          "table_rows": ranks[0]["table_rows"],
          "padded_rows": ranks[0]["padded_rows"],
          "per_rank": [{k: r[k] for k in (
              "model_index", "init_s", "prove_batch_s",
              "stage_seconds_median", "peak_memory_bytes")}
              for r in ranks],
          "launches": {k: v for k, v in launches.items() if v}})
    if not same or not all(accepted.values()) or cross:
        raise AssertionError("sharded: proofs differ from the main path's "
                             "or fail verification")
    if not (check["inverse_equal"] and check["roundtrip_equal"]
            and check["coset_equal"]):
        raise AssertionError(f"sharded: the distributed NTT differs: {check}")
    require_launches("sharded", launches)
    captured = _sharded_capture(K, vk, ranks, proofs, pubs)

    t0 = time.perf_counter()
    dry = dryrun_multichip.dryrun(SHARDED_RANKS, dev, "gloo")
    emit({"phase": "sharded_dryrun", "wall_s": time.perf_counter() - t0,
          **dry})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sw = scaling_sweep.sweep(pathlib.Path(tmp), SWEEP_MESHES, ["full"],
                                 4, 8, 1, dev, "gloo")
    emit({"phase": "sharded_sweep", "nvidia_smi": smi_line(),
          "wall_s": time.perf_counter() - t0,
          **{k: sw[k] for k in ("nlevels", "batch", "iters", "device",
                                "backend", "world", "sweeps")}})
    return launches, captured


def _sharded_capture(K, vk, ranks, proofs, pubs) -> dict:
    """Phase sharded's captured step (prove_job's "capture" record of each
    rank): checks and one line -> the capture's launches summed over the
    ranks, by kernel."""
    from zkfranchise_tpu_torch.groth16 import verify as gverify

    caps = [r["capture"] for r in ranks]
    got, got_pubs = ranks[0]["replay_proofs"], ranks[0]["replay_publics"]
    same = got == proofs and got_pubs == pubs
    sample = [0, BATCH // 2, BATCH - 1]
    accepted = {f"voter_{i}": gverify.verify(
        vk, gverify.Proof.from_json(got[i]), got_pubs[i]) for i in sample}
    cross = gverify.verify(vk, gverify.Proof.from_json(got[0]), got_pubs[1])
    launches = {k: sum(c["launches"].get(k, 0) for c in caps)
                for k in K.LAUNCHES}
    per_rank = []
    for r, c in zip(ranks, caps):
        turns = {}
        for kind in ("eager", "replay"):
            runs = [t for t in c["turns"] if t["kind"] == kind]
            turns[kind] = {"s": [t["s"] for t in runs],
                           "collective_s": [t["collective_s"] for t in runs],
                           "collective_share": [t["collective_s"] / t["s"]
                                                for t in runs]}
        per_rank.append({
            "model_index": r["model_index"], "stretches": c["stretches"],
            "collectives": len(c["schedule"]), "nodes": c["nodes"],
            "launches_equal_eager_step":
                c["launches"] == c["eager_launches"],
            **{k: c[k] for k in (
                "warmup_s", "capture_s", "instantiate_s", "pool_bytes",
                "memory", "peak_allocated_with_graphs", "peak_reserved_with_graphs",
                "replay_prove_batch_s", "part_s")},
            "ntt_check_s": r["ntt_check_s"],
            "turns": turns})
    emit({"phase": "sharded_capture", "nvidia_smi": smi_line(),
          "proofs_equal_eager_and_main_path": same, "accepted": accepted,
          "cross_voter_accepted": cross, "per_rank": per_rank,
          "schedule": caps[0]["schedule"],
          "kernel_nodes_by_stretch": [n.get("kernel", 0) for n in
                                      caps[0]["nodes_by_stretch"]],
          "mismatch_refused": [c.get("mismatch") for c in caps],
          "replay_busy_rank0": caps[0]["replay_busy"],
          "launches": {k: v for k, v in launches.items() if v}})
    if not same or not all(accepted.values()) or cross:
        raise AssertionError("sharded_capture: the replay's proofs differ "
                             "from the eager step's or fail verification")
    for c in caps:
        if c["stretches"] != len(c["schedule"]) + 1 or \
                c["stretches"] != SHARDED_STRETCHES:
            raise AssertionError(f"sharded_capture: {c['stretches']} "
                                 f"stretches for {len(c['schedule'])} "
                                 f"collectives")
        if c["launches"] != c["eager_launches"]:
            raise AssertionError(
                f"sharded_capture: the capture launched {c['launches']}, "
                f"an eager step {c['eager_launches']}")
        if "step inputs" not in c.get("mismatch", ""):
            raise AssertionError("sharded_capture: a mismatched input was "
                                 "not refused")
    require_launches("sharded_capture", launches)
    return launches


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
    # wall seconds of each phase: what the run's time limit is spent on
    wall: dict = {}
    start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t0
        return out

    timed("toolchain", phase_toolchain, torch, K)
    table = timed("kernels", phase_kernels, np, torch, K, dev)
    launches = {
        "affine_tree": timed("affine_tree", phase_affine_tree, np, torch, K,
                             dev),
        "verify_tools": timed("verify_tools", phase_tools, torch, K, dev,
                              "verify_tools", ["verify_kernels", "verify_lm",
                                               "micro_montmul"]),
        "layout_tools": timed("layout_tools", phase_tools, torch, K, dev,
                              "layout_tools", ["layout_expt",
                                               "layout_expt2"])}
    launches["main_path"], keys, held, main_proofs = timed(
        "main_path", phase_main_path, np, torch, K, dev)
    launches["fused_step"] = timed("fused_step", phase_fused_step, torch, K,
                                   dev, *held)
    main_arrs = held[2]
    del held
    launches["stream"] = timed("stream", phase_stream, torch, K, dev, *keys)
    launches["nlevels160"], rows160, key160 = timed(
        "nlevels160", phase_nlevels160, np, torch, K, dev)
    table.update(rows160)
    launches["stream160"] = timed("stream160", phase_stream160, torch, K,
                                  dev, *key160)
    del key160
    launches.update(timed("ceremony", phase_ceremony, np, torch, K, dev,
                          *keys))
    launches["sharded"], launches["sharded_capture"] = timed(
        "sharded", phase_sharded, torch, K, dev, *keys, main_arrs,
        main_proofs)
    emit({"phase": "wall_seconds", "phases": wall,
          "total_s": time.perf_counter() - start})
    kernels = []
    for name, (source, replaces, path, keys) in KERNELS.items():
        # `launches` is the count on the path that owns the kernel (G1 and
        # G2 together); launches_by_path has every path and group
        by_path = {pth: {k: n[k] for k in keys} for pth, n in launches.items()}
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, path=path,
                     launches=sum(by_path[path].values()),
                     launches_by_path=by_path, **table[name])
        # further rows of the same kernel: its G2 form, a longer chain
        for key in table:
            if key.startswith(name + "/"):
                entry[key.split("/", 1)[1]] = table[key]
        kernels.append(entry)
    print(smi_line())
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

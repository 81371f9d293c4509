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
     with 128 and 4 lanes beside the level it replaced, inv at 1, 128 and
     129 lanes beside a mont_chain of as many products, batch_inv at
     (128, 21, 16384) launch by launch and as a whole, and at every width
     2^0 .. 2^14 the affine tree calls it with, padd at the five
     plane shapes of
     tools.padd_shapes, the folds at every width of the sum tree and at
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
     turns (eager, replay, replay, eager, three rounds; wall and CUDA-event
     seconds), profiles one replay, prints the memory with the graph alive
     and tools.bench's JSON line taken on the same prover;
  8. drives the serving path at the same width: the dev key is exported
     as a producer-ordered snarkjs zkey, written to bytes, read back and
     ingested (A and B matrices only), and a DeviceProver keyed from it
     alone serves mock_batch(16, 300, seed=7) through ProofStream at
     batch 128 with a crash injected after the second batch (cursor 256)
     and a resume over the tail slices 32, 8, 4; sampled proof files
     verify against the committed dev/16 key;
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
     at the path's widths (8,192 to 165,476 lanes), device ms and bound.

Launch counts are set to 0 just before each of the paths 3 to 9 and
read just after it; the run fails if a kernel of a path was not launched
on it.

Every phase prints JSON lines.  The last line is
{"ok": true, "device": {...}}; any failure exits non-zero before it.
It imports nothing of JAX.
"""
from __future__ import annotations

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
                  "poseidon/t3", "poseidon/t4", "poseidon/t5",
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
    """a / b, or None where the reading b is 0 (an invalid reading, marked
    as such beside the ratio)."""
    return a / b if b > 0 else None


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
    from zkfranchise_tpu_torch.tools import MAD_MONT, MAD_MONT_KARATSUBA, \
        add_mads, bound_ms, device_reading, event_ms, mont_chain_work
    from zkfranchise_tpu_torch.tools import fold_shapes
    from zkfranchise_tpu_torch.tools.padd_shapes import SHAPES, padd_inputs

    rng = np.random.default_rng(2024)
    results, table = {}, {}
    # inv's products: 253 squares and one per set bit of p - 2 (110)
    chain = len(lm.FQ.p_minus_2_bits) - 1 + int(lm.FQ.p_minus_2_bits.sum())

    def check(name, kernel, plain, nbytes, mads, key, plain_runs=10,
              library=None):
        """library: one PyTorch call (or the honest chain of them) that
        computes the same function; timed beside the kernel, held against
        the plain version too, and used nowhere in the port.  ms is a whole
        call (CUDA events, the wrapper's host time included), device_ms
        the kernels' own time per call (torch.profiler, through
        tools.device_reading: "device_invalid" marks a reading no card can
        give, beside the event-burst ms)."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.long() - want.long()).abs().max().item())
        del got
        ms = event_ms(kernel)
        reading = device_reading(name, kernel, nbytes, mads)
        dev_ms = reading["device_ms"]
        # a plain version of hundreds of chained steps is timed once
        plain_ms = event_ms(plain, runs=plain_runs,
                            warmup=2 if plain_runs > 1 else 0)
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
    _ntt_levels(np, torch, K, dev, rng, check, results, table)
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
        check(f"fold_padd_aa/{kind}/{B}x{arows}x{m}",
              lambda: K.fold_padd_aa(a, kind),
              lambda: K.fold_padd_aa_ref(a, kind),
              4 * (arows * m + rows * m // 2) * B,
              add_mads("padd_aa", kind) * B * m // 2,
              key("fold_padd_aa"))
        del p, q, a, x
        torch.cuda.empty_cache()

    # the folds at every width of the main path's sum tree, one level and
    # as the plan launches them, and at ragged widths and one batch row
    failed: list = []
    edges = [("fold", "g1", 1, 33), ("aa", "g1", 1, 33),
             ("fold", "g2", 1, 33), ("aa", "g2", 1, 33)]
    edge_levels = [("g1", 3, 12, 3), ("g1", 1, 33, 1), ("g2", 32, 256, 2)]
    fold_results = fold_shapes.run(dev, fold_shapes.SHAPES + edges,
                                   fold_shapes.LEVELS + edge_levels, failed)
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
              "inv" if T == B else f"inv/T{T}",
              plain_runs=3 if T == B else 1)
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
    torch.cuda.empty_cache()
    _layout_kernels(np, torch, K, dev, rng, check, results, table)
    emit({"phase": "kernels", "kernels": results,
          "fold_shapes": fold_results})
    return table


def _ntt_levels(np, torch, K, dev, rng, check, results, table) -> None:
    """zk_ntt_level at every level of the forward and the inverse 2^14
    schedules, at 128 lanes (the batch) and 4 (the stream's last slice),
    each level fed the previous one's output: held against the plain
    version (ntt_level_ref with mont_mul_ref) with torch.equal and read
    through tools.device_reading beside the level as it ran before this
    kernel (ntt_level_ref with the general mont_mul kernel and PyTorch's
    gather, adds and cat), read the same way at 128 lanes.  The first
    forward level is the table's row (with whole-call and plain times);
    the row also carries the slowest level and the least speed-up."""
    from zkfranchise_tpu_torch.ops import lm, ntt
    from zkfranchise_tpu_torch.tools import MAD_MONT_KARATSUBA, \
        device_reading

    pl = ntt.plan(14)
    n = pl.n
    tabs = pl.on(str(dev))
    for T in (BATCH, 4):
        key = "ntt_level" if T == BATCH else f"ntt_level/T{T}"
        levels = []
        for sched in ("fwd", "inv"):
            gs, tws, _ = tabs[sched]
            x = lm.to_mont(torch.as_tensor(
                _random_limbs(np, rng, (n, 21, T)), device=dev))
            for lvl, (g, tw) in enumerate(zip(gs, tws)):
                nbytes = 4 * (2 * x.numel() + tw.numel()) + 8 * g.numel()
                mads = MAD_MONT_KARATSUBA * (n // 2) * T
                name = f"ntt_level/fr/{n}x21x{T}/{sched}{lvl}"

                def kernel():
                    return K.ntt_level(x, g, tw)

                def plain():
                    return ntt.ntt_level_ref(x, g, tw, mul=lm.mont_mul_ref)

                if (sched, lvl) == ("fwd", 0):
                    check(name, kernel, plain, nbytes, mads, key,
                          plain_runs=3)
                    dev_ms = results[name]["device_ms"]
                    invalid = results[name]["device_invalid"]
                else:
                    if not torch.equal(kernel(), plain()):
                        raise AssertionError(f"{name}: kernel differs from "
                                             f"plain version")
                    r = device_reading(name, kernel, nbytes, mads)
                    dev_ms, invalid = r["device_ms"], r["invalid"]
                level = {"level": f"{sched}{lvl}", "device_ms": dev_ms,
                         "invalid": invalid}
                if T == BATCH:
                    was = device_reading(
                        name + " (before: ntt_level_ref, mont_mul kernel)",
                        lambda: ntt.ntt_level_ref(x, g, tw), nbytes, mads)
                    level.update(before_device_ms=was["device_ms"],
                                 before_invalid=was["invalid"],
                                 speedup=_ratio(was["device_ms"], dev_ms))
                levels.append(level)
                x = kernel()
            del x
        summary = {"levels": len(levels),
                   "max_device_ms": max(v["device_ms"] for v in levels),
                   "any_invalid": any(v["invalid"] or
                                      v.get("before_invalid", False)
                                      for v in levels)}
        if T == BATCH:
            summary["min_speedup"] = min(v["speedup"] for v in levels)
            summary["before_device_ms"] = [min(v["before_device_ms"]
                                               for v in levels),
                                           max(v["before_device_ms"]
                                               for v in levels)]
        emit({"phase": "kernels", "ntt_levels": key, **summary,
              "each": levels})
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
          "batch_inv", plain_runs=3)
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
    from zkfranchise_tpu_torch.ops import lm, msm_lm
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
    planned: dict = {}
    for tab, kind in ((prover.a_tab, "g1"), (prover.b1_tab, "g1"),
                      (prover.b2_tab, "g2"), (prover.c_tab, "g1")):
        for key, v in msm_lm.msm_fold_launches(
                tab.shape[0], BATCH, kind, prover.window_group).items():
            planned[key] = planned.get(key, 0) + v
    emit({"phase": "main_path", "inputs_s": inputs_s,
          "prover_init_s": prover_init_s, "first_prove_batch_s": first_s,
          "proofs": len(proofs), "launches": launches,
          "mont_launches_by_shape": dict(sorted(K.MONT_SHAPES.items())),
          "padd_launches_by_shape": dict(sorted(K.PADD_SHAPES.items())),
          "fold_launches_by_shape": folds,
          "fold_launches": sum(folds.values())})
    require_launches("main_path", launches)
    if folds != dict(sorted(planned.items())):
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
    proofs2, pubs2 = prover.finalize(*planes)
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
    return launches, (circuit, pk, vk), (prover, vk, arrs, r, s)


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

ROUNDS = 3                              # eager, replay, replay, eager


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
    K.reset_launches()
    want = prover.prove_arrays(arrs, r, s)
    eager_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    want2 = prover.prove_arrays(arrs, r2, s2)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = {"allocated": torch.cuda.memory_allocated(dev),
              "reserved": torch.cuda.memory_reserved(dev)}
    torch.cuda.reset_peak_memory_stats(dev)

    # the path: counts start at 0 here and are read right after the capture
    K.reset_launches()
    t0 = time.perf_counter()
    step = prover.capture(BATCH)
    build_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    nodes = step.node_counts()
    captured = {"allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev)}
    emit({"phase": "fused_step", "batch": BATCH, "build_s": build_s,
          "warmup_s": step.warmup_s, "capture_s": step.capture_s,
          "instantiate_s": step.instantiate_s, "graph_nodes": nodes,
          "graph_nodes_total": sum(nodes.values()),
          "graph_launches": step.launches,
          "prove_arrays_launches": eager_launches,
          "memory_before_capture": before,
          "memory_after_capture": captured})
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

    # eager and replay in turns, wall seconds and CUDA-event seconds
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
    for _ in range(ROUNDS):
        for name in ("eager", "replay", "replay", "eager"):
            runs[name].append(timed(prover.prove_arrays if name == "eager"
                                    else step))
    summary = {name: {"wall_s_median": statistics.median(
        x["wall_s"] for x in v), "event_s_median": statistics.median(
        x["event_s"] for x in v)} for name, v in runs.items()}
    for name in runs:
        summary[name]["proofs_per_s"] = BATCH / summary[name]["wall_s_median"]
    summary["replay_over_eager_wall"] = (summary["replay"]["wall_s_median"]
                                         / summary["eager"]["wall_s_median"])

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
    """Stands between ProofStream and the DeviceProver: records each
    slice's size and kernel launches, and raises in place of slice number
    `fail_after` (a crash between two batches)."""

    def __init__(self, prover, K, fail_after=None):
        self.prover, self.K, self.fail_after = prover, K, fail_after
        self.circuit, self.device = prover.circuit, prover.device
        self.slices = []

    def prove_batch(self, arrs, seed=0):
        if self.fail_after is not None and \
                len(self.slices) >= self.fail_after:
            raise RuntimeError("injected crash")
        before = dict(self.K.LAUNCHES)
        out = self.prover.prove_batch(arrs, seed=seed)
        self.slices.append({
            "batch": len(out[0]), "seed": seed,
            "launches": {k: v - before[k] for k, v in self.K.LAUNCHES.items()
                         if v != before[k]}})
        return out


def phase_stream(torch, K, dev, circuit, pk, vk) -> dict:
    import io
    import tempfile

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils import serialize, zkey_compat
    from zkfranchise_tpu_torch.utils.metrics import Metrics

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

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "proofs"
        sink = io.StringIO()
        # (b) the stream crashes in place of its third batch; counts
        # start at 0 here and are read right after the resumed run
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        first = _RecordingProver(prover, K, fail_after=2)
        s1 = ProofStream(first, out, batch_size=BATCH,
                         metrics=Metrics(sink=sink))
        crashed = False
        t0 = time.perf_counter()
        try:
            s1.run(voters, seed=1)
        except RuntimeError as e:
            crashed = str(e) == "injected crash"
        if not crashed or s1.cursor != 2 * BATCH:
            raise AssertionError(f"stream: expected a crash at cursor "
                                 f"{2 * BATCH}, got cursor {s1.cursor}")
        # (c) a fresh stream on the same directory resumes over the tail
        second = _RecordingProver(prover, K)
        s2 = ProofStream(second, out, batch_size=BATCH,
                         metrics=Metrics(sink=sink))
        produced = s2.run(voters, seed=1)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        sizes = [x["batch"] for x in second.slices]
        done = sorted(d.name for d in out.iterdir() if d.is_dir())
        if (produced, sizes, s2.cursor) != (44, [32, 8, 4], N_VOTERS) or \
                done != [f"proof_{i:08d}" for i in range(N_VOTERS)]:
            raise AssertionError(f"stream resume: produced {produced}, "
                                 f"slices {sizes}, cursor {s2.cursor}, "
                                 f"{len(done)} proof directories")
        third = _RecordingProver(prover, K)
        if ProofStream(third, out, batch_size=BATCH,
                       metrics=Metrics(sink=sink)).run(voters, seed=1) or \
                third.slices or dict(K.LAUNCHES) != launches:
            raise AssertionError("stream: a third run was not a no-op")
        # (d) sampled proof files against the committed key: first batch,
        # the batch before the crash, and each slice of the resumed tail
        def files(i):
            d = out / f"proof_{i:08d}"
            return str(d / "proof.json"), str(d / "signals.json")

        t0 = time.perf_counter()
        accepted = {f"voter_{i}": gverify.verify_files(str(vk_path),
                                                       *files(i))
                    for i in (0, 200, 256, 287, 288, 295, 296, 299)}
        cross = gverify.verify_files(str(vk_path), files(0)[0], files(1)[1])
        verify_s = time.perf_counter() - t0
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    rates = [{"batch": r["items"], "seconds": r["seconds"],
              "proofs_per_s": r["per_second"]}
             for r in records if r["kind"] == "throughput"]
    emit({"phase": "stream", "nvidia_smi": smi_line(), "voters": N_VOTERS,
          "slices": first.slices + second.slices, "rates": rates,
          "stream_s": stream_s, "proofs_per_s": N_VOTERS / stream_s,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": {k: v for k, v in launches.items() if v},
          "accepted": accepted, "cross_voter_accepted": cross,
          "verify_s": verify_s})
    if not all(accepted.values()) or cross:
        raise AssertionError("stream: proof verification failed")
    require_launches("stream", launches)
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
    from zkfranchise_tpu_torch.tools import add_mads, bound_ms, \
        event_ms, kernel_events

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
        events, _ = kernel_events(fn, runs=2)
        ours = [us for name, us in events if "ladder" in name]
        row["device_ms"] = sum(ours) / 2 / 1e3 if len(ours) == 2 else None
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
    launches = {"affine_tree": phase_affine_tree(np, torch, K, dev),
                "verify_tools": phase_tools(
                    torch, K, dev, "verify_tools",
                    ["verify_kernels", "verify_lm", "micro_montmul"]),
                "layout_tools": phase_tools(
                    torch, K, dev, "layout_tools",
                    ["layout_expt", "layout_expt2"])}
    launches["main_path"], keys, held = phase_main_path(np, torch, K, dev)
    launches["fused_step"] = phase_fused_step(torch, K, dev, *held)
    del held
    launches["stream"] = phase_stream(torch, K, dev, *keys)
    launches.update(phase_ceremony(np, torch, K, dev, *keys))
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

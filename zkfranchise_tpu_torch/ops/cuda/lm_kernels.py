"""CUDA kernels over the limb-major core: build, bind, launch, count.

Twenty kernels, written by hand for Hopper in ``csrc/lm_kernels.cu``
(mont_mul, the cooperative adds, scalar_mul and the layout experiments'
fold2d), ``csrc/lm_ntt.cu`` (one NTT butterfly level),
``csrc/lm_chains.cu`` (fold_mul at one and at several levels, inv,
batch_inv's top and walk down, mont_chain), ``csrc/lm_poseidon.cu`` (the
Poseidon permutation and the witness's SMT chains on it) and
``csrc/lm_layout.cu`` (the other four of the layout experiments):

  ============  ============================================  =============
  wrapper       what it computes                              plain version
  ============  ============================================  =============
  mont_mul      a*b*R^-1 mod p, elementwise, Fr or Fq         mont_mul_ref
  ntt_level     one butterfly level of the NTT over Fr: the   ntt.ntt_level_
                row gather, a product by the twiddles, the      ref
                lazy add and the spread subtract
  padd          p + q, RCB15 complete add, G1 or G2           padd_ref
  fold_padd     x[..., :m/2] + x[..., m/2:], projective       fold_padd_ref
  fold_padd_    n levels of that halving tree in ONE launch   fold_padd_
    levels      (fold_padd is its one-level case)               levels_ref
  fold_padd_aa  the same from AFFINE planes -> projective,     fold_padd_aa_ref
                or from a table's rows through an index
  fold_mul      x[..., :m/2] * x[..., m/2:], Fr or Fq         fold_mul_ref
  fold_mul_     levels of batch_inv's product tree into its   fold_mul_
    levels      buffer, up to 5 in ONE launch                   levels_ref
  inv           a^(p-2) = 1/a (inv(0) = 0), Fr or Fq          inv_ref
  batch_inv_    batch_inv's narrow levels (<= 32 lanes), the  batch_inv_
    top         root's Fermat chain and the walk back down      top_ref
  batch_inv_    batch_inv's walk down, up to 5 levels a        batch_inv_
    down        launch                                          down_ref
  mont_chain    a * b^iters, one product after another        mont_chain_ref
  scalar_mul    k*P, a base per lane, its scalar's bits one   scalar_mul_ref
                per lane or shared by all
  permutation   the Poseidon permutation of width t = 3, 4,   permutation_ref
                5, one launch for every lane
  poseidon_     the same from the k = t - 1 inputs, with      poseidon_
    trace       the S-box trace the witness keeps               trace_ref
  smt_fill      the witness's SMT levels at or below each     smt_fill_ref
                lane's leaf, from a table, for n trees
  smt_levels    the SMT levels above each lane's leaf: the    smt_levels_ref
                chain of t = 3 permutations, for n trees
  mm2d          a * b^chain on a flat (21, T) lane axis,      mm2d_ref
                `tile` lanes per block
  mm3d          a * b on (B, 21, T), (blk, tile) per block    mm3d_ref
  fold2d        fold_padd on a flat (rows, B*m) lane axis     fold2d_ref
  add_one       a + 1, int32 (launch-and-copy floor)          add_one_ref
  fused_upsweep every level of a halving int32 sum tree in    fused_upsweep_ref
                one launch
  batch_inv     1/d for every lane: the launches of           batch_inv_ref
                batch_inv_plan (fold_mul_levels, the top,
                batch_inv_down) in one buffer
  ============  ============================================  =============

Dispatch is by the tensors' device only: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises.  There is no
switch and no fallback: if a kernel library does not build or a launch
fails, the call raises.

Each source is compiled on its own with ``nvcc`` at first use (all sources
at the same time), into ``zkfranchise_tpu_torch/build/`` under a name
keyed by a hash of the source, the shared header, the flags and ``nvcc
--version`` (an edit or another toolkit rebuilds), and loaded with
ctypes.  Each wrapper adds one to its ``LAUNCHES`` entry
per kernel launch and nowhere else; the EC kernels count G1 and G2 apart
(``"padd/g1"``, ``"padd/g2"``); fold_mul_levels counts as
``"fold_mul"``; ``MONT_SHAPES`` counts mont_mul's
launches by operand pattern and shape, ``PADD_SHAPES`` padd's by plane
shape, ``FOLD_SHAPES`` the folds' by batch, width and levels and
``SCALAR_SHAPES`` scalar_mul's by lanes, bits and scalar form.
``fold_plan`` decides how many levels a fold launch takes,
``batch_inv_plan`` the launches of a batch inversion; ``lane_block``
how the kernels that take a lane axis of any width shape their blocks.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .. import ec_lm, lm, ntt, poseidon
from ..poseidon_constants import N_ROUNDS_F, N_ROUNDS_P

PKG = pathlib.Path(__file__).resolve().parents[2]
SOURCES = [PKG / "csrc" / "lm_kernels.cu", PKG / "csrc" / "lm_chains.cu",
           PKG / "csrc" / "lm_layout.cu", PKG / "csrc" / "lm_poseidon.cu",
           PKG / "csrc" / "lm_ntt.cu"]
HEADERS = [PKG / "csrc" / "lm_device.cuh"]
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont_mul": 0, "ntt_level": 0, "padd/g1": 0, "padd/g2": 0, "fold_padd/g1": 0,
            "fold_padd/g2": 0, "fold_padd_aa/g1": 0, "fold_padd_aa/g2": 0,
            "fold_mul": 0, "inv": 0, "batch_inv/top": 0, "batch_inv/down": 0,
            "mont_chain": 0, "scalar_mul/g1": 0,
            "scalar_mul/g2": 0, "mm2d": 0, "mm3d": 0, "fold2d/g1": 0,
            "fold2d/g2": 0, "add_one": 0, "fused_upsweep": 0,
            "poseidon/t3": 0, "poseidon/t4": 0, "poseidon/t5": 0,
            "smt/fill": 0, "smt/levels": 0}
# mont_mul launches by operand pattern and shape: "full*col/R8192/T128"
# counts launches of an (8192, 21, 128) plane by a column per row
# (mont_pattern names the patterns; R is the product of the leading dims)
MONT_SHAPES: dict = {}
# padd launches by plane shape: "g1/B128/T1" counts G1 launches on
# (128, 63, 1) planes (B adds per lane, T lanes)
PADD_SHAPES: dict = {}
# fold launches by shape: "fold_padd/g1/B128/h8192/n3" counts launches of
# fold_padd_levels on (128, 63, 16384) planes with 3 levels (first output
# width h); fold_padd_aa's are "fold_padd_aa/g1/B128/h16384/n1"
FOLD_SHAPES: dict = {}
# scalar_mul launches by shape: "g1/T8192/b254/lane" counts G1 launches on
# 8192 lanes with 254 bits, a scalar per lane ("shared": one for all)
SCALAR_SHAPES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    MONT_SHAPES.clear()
    PADD_SHAPES.clear()
    FOLD_SHAPES.clear()
    SCALAR_SHAPES.clear()


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    """What ``nvcc --version`` prints, read once a process."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def library_path(src: pathlib.Path) -> pathlib.Path:
    """Where the library of `src` is built: keyed by the source, the shared
    header, the flags and the compiler's version, so that an edit or
    another toolkit builds anew and never loads a library built
    before."""
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version().encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose hash has no library yet, all at the same
    time, one ``nvcc`` each -> {source stem: library path}.  The compiler's
    resource report (-Xptxas -v) is kept beside each library as
    ``<library>.log``."""
    libs = {src.stem: library_path(src) for src in SOURCES}
    jobs = []
    for src in SOURCES:
        out = libs[src.stem]
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) on {out.name}:\n"
                          f"{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def _libs() -> tuple:
    """(lm_kernels, lm_chains, lm_layout, lm_poseidon, lm_ntt) libraries,
    built if need be."""
    paths = build()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(paths["lm_kernels"]))
    lib.zk_mont_mul.argtypes = [P, P, P, P] + [L] * 4 + [I] + [L] * 11 + [P]
    lib.zk_padd.argtypes = [I, P, P, P] + [L] * 8 + [P]
    lib.zk_fold_padd_levels.argtypes = [I, P, P, L, L, I, P]
    lib.zk_fold_padd_aa.argtypes = [I, P, P, P, L, L, P]
    lib.zk_occupancy.argtypes = [I, P]
    lib.zk_ladder_occupancy.argtypes = [P]
    lib.zk_scalar_mul.argtypes = [I, P, P, P, L, L, I, L, P]
    lib.zk_fold2d.argtypes = [I, P, P, L, L, L, P]
    chains = ctypes.CDLL(str(paths["lm_chains"]))
    chains.zk_fold_mul.argtypes = [P, P, P, L, L, P]
    chains.zk_inv.argtypes = [P, P, P, P, I] + [L] * 5 + [P]
    chains.zk_mont_chain.argtypes = [P, P, P, P, L, I, P]
    chains.zk_fold_mul_levels.argtypes = [P, P, P, L, L, I, I, I, I, P]
    chains.zk_batch_inv_down.argtypes = [P, P, P, L, L, I, I, I, I, P]
    chains.zk_batch_inv_top.argtypes = [P, P, P, P, I, L, L, I, I, P]
    layout = ctypes.CDLL(str(paths["lm_layout"]))
    layout.zk_mm2d.argtypes = [P, P, P, P, L, L, I, P]
    layout.zk_mm3d.argtypes = [P, P, P, P, L, L, L, L, P]
    layout.zk_add_one.argtypes = [P, P, L, L, L, P]
    layout.zk_fused_upsweep.argtypes = [P, P, L, L, P]
    pos = ctypes.CDLL(str(paths["lm_poseidon"]))
    pos.zk_poseidon.argtypes = [I, P, P, P, P, P, P, I, L, I, I, P]
    pos.zk_smt_fill.argtypes = [P, P, P, P, I, I, L, I, L, P]
    pos.zk_smt_levels.argtypes = [P] * 11 + [I, I, L, I, L, P]
    nttl = ctypes.CDLL(str(paths["lm_ntt"]))
    nttl.zk_ntt_level.argtypes = [P, P, P, P, P, L, L, I, P]
    for fn in (lib.zk_mont_mul, nttl.zk_ntt_level, lib.zk_padd, lib.zk_fold_padd_levels,
               lib.zk_fold_padd_aa, lib.zk_occupancy,
               lib.zk_ladder_occupancy, lib.zk_scalar_mul,
               chains.zk_fold_mul, chains.zk_inv, chains.zk_mont_chain,
               chains.zk_fold_mul_levels, chains.zk_batch_inv_down,
               chains.zk_batch_inv_top,
               lib.zk_fold2d, layout.zk_mm2d, layout.zk_mm3d,
               layout.zk_add_one, layout.zk_fused_upsweep, pos.zk_poseidon,
               pos.zk_smt_fill, pos.zk_smt_levels):
        fn.restype = ctypes.c_int
    return lib, chains, layout, pos, nttl


def _lib() -> ctypes.CDLL:
    return _libs()[0]


def _chains() -> ctypes.CDLL:
    return _libs()[1]


def _layout() -> ctypes.CDLL:
    return _libs()[2]


def _poseidon_lib() -> ctypes.CDLL:
    return _libs()[3]


def _ntt_lib() -> ctypes.CDLL:
    return _libs()[4]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_FIELD_CONSTS = {lm.FR.p: lm.pack_consts(lm.FR),
                 lm.FQ.p: lm.pack_consts(lm.FQ)}
# p and n' of each field in host memory: mont_mul passes them by value
_FIELD_PN = {k: np.ascontiguousarray(v[:2 * lm.N_LIMBS, 0])
             for k, v in _FIELD_CONSTS.items()}


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA int32 tensors, False for CPU ones; raises otherwise."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


# ---------------------------------------------------------------------------
# mont_mul
# ---------------------------------------------------------------------------

mont_mul_ref = lm.mont_mul_ref

THREADS = 128                     # threads a block (csrc/lm_device.cuh)
# mont_mul's grid: at most this many blocks an SM, two rounds of its four
# resident ones (csrc/lm_kernels.cu zk_mont_mul)
MONT_BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lane_block(T: int) -> tuple:
    """(lanes, rows) of a block of THREADS threads over a lane axis of T
    (mont_mul, ntt_level): the least power of two >= T up to THREADS
    lanes, and as many rows as make up the block, so a narrow lane axis
    still fills the warps."""
    tx = 1
    while tx < min(T, THREADS):
        tx *= 2
    return tx, THREADS // tx


def _collapse(shape, sa, sb):
    """Merge leading dims that are contiguous in both operands and drop
    size-1 dims -> list of (size, stride_a, stride_b)."""
    dims = [(n, x, y) for n, x, y in zip(shape, sa, sb) if n != 1]
    out = []
    for n, x, y in dims:
        if out and out[-1][1] == x * n and out[-1][2] == y * n:
            m, _, _ = out[-1]
            out[-1] = (m * n, x, y)
        else:
            out.append((n, x, y))
    return out


def mont_pattern(shape, strides) -> str:
    """How an operand of a (..., 21, T) product is read, from its
    expanded strides: "const" (one column for every row and lane),
    "col" (a column per row: lane stride 0), "table" (one plane for
    several rows: a leading stride 0), "strided" (a view that is not
    laid out contiguously) or "full"."""
    lead = [s for n, s in zip(shape[:-2], strides[:-2]) if n != 1]
    col = shape[-1] > 1 and strides[-1] == 0
    if col:
        return "const" if not any(lead) else "col"
    if 0 in lead:
        return "table"
    want = 1
    for n, s in reversed(list(zip(shape, strides))):
        if n != 1 and s != want:
            return "strided"
        want *= n
    return "full"


def mont_launch(shape, sa, sb) -> tuple:
    """The launch of mont_mul on operands of the broadcast `shape`, read
    through the expanded strides sa and sb -> (leading dims (d0, d1, d2)
    as (size, stride a, stride b), or None when more than three leading
    dims stay apart (the wrapper then copies both operands contiguous),
    lanes a block, its MONT_SHAPES key)."""
    dims = _collapse(shape[:-2], sa[:-2], sb[:-2])
    key = f"{mont_pattern(shape, sa)}*{mont_pattern(shape, sb)}/R" \
        f"{math.prod(shape[:-2])}/T{shape[-1]}"
    if len(dims) > 3:
        return None, lane_block(shape[-1])[0], key
    return [(1, 0, 0)] * (3 - len(dims)) + dims, lane_block(shape[-1])[0], \
        key


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             fs: lm.FieldSpec = lm.FR) -> torch.Tensor:
    """(..., 21, T) x (..., 21, T) (broadcastable) -> (..., 21, T)
    Montgomery product over Fr or Fq.  On the card, broadcast operands
    (a (..., 21, 1) column, a shared table) are read in place through
    stride 0, never expanded in memory; only more than three leading dims
    that do not merge are copied."""
    if not _on_card("mont_mul", a, b):
        return mont_mul_ref(a, b, fs)
    if a.shape[-2] != lm.N_LIMBS or b.shape[-2] != lm.N_LIMBS:
        raise ValueError(f"mont_mul: limb axis must be 21: {a.shape} "
                         f"{b.shape}")
    if fs.p not in _FIELD_CONSTS:
        raise ValueError("mont_mul: kernel takes Fr or Fq only")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    ae, be = a.expand(shape), b.expand(shape)
    dims, tx, key = mont_launch(shape, ae.stride(), be.stride())
    if dims is None:
        ae, be = ae.contiguous(), be.contiguous()
        dims, tx, _ = mont_launch(shape, ae.stride(), be.stride())
    if dims[0][0] * dims[1][0] >= 1 << 32:
        raise ValueError(f"mont_mul: too many leading rows: {shape}")
    rc = _lib().zk_mont_mul(
        ae.data_ptr(), be.data_ptr(), out.data_ptr(),
        _FIELD_PN[fs.p].ctypes.data,
        dims[0][0], dims[1][0], dims[2][0], shape[-1], tx,
        MONT_BLOCKS_PER_SM * _sms(a.device), dims[0][1], dims[1][1], dims[2][1], ae.stride(-2), ae.stride(-1),
        dims[0][2], dims[1][2], dims[2][2], be.stride(-2), be.stride(-1),
        _stream(a.device))
    _check(rc, "mont_mul")
    LAUNCHES["mont_mul"] += 1
    MONT_SHAPES[key] = MONT_SHAPES.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------------
# ntt_level: one butterfly level of the NTT
# ---------------------------------------------------------------------------

def ntt_level(x: torch.Tensor, g: torch.Tensor,
              tw: torch.Tensor) -> torch.Tensor:
    """One butterfly level of ops/ntt.py over Fr: x (n, 21, T) Montgomery,
    the level's gather g (n,) int64 and twiddles tw (n/2, 21, 1) -> y
    (n, 21, T), y[j] = weak_norm(lo + hi), y[n/2 + j] = sub_n(lo, hi) with
    lo = x[g[j]] and hi = x[g[n/2 + j]] * tw[j].  On the card one launch;
    x[g] is never written out."""
    on_card = _on_card("ntt_level", x, tw)
    if x.dim() != 3 or x.shape[1] != lm.N_LIMBS or x.shape[0] % 2:
        raise ValueError(f"ntt_level: expected x (even n, 21, T), got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if g.dtype != torch.int64 or tuple(g.shape) != (n,) or \
            g.device != x.device:
        raise ValueError(f"ntt_level: expected g ({n},) int64 on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    if tuple(tw.shape) != (n // 2, lm.N_LIMBS, 1):
        raise ValueError(f"ntt_level: expected tw ({n // 2}, 21, 1), got "
                         f"{tuple(tw.shape)}")
    if not on_card:
        return ntt.ntt_level_ref(x, g, tw)
    x, g, tw = x.contiguous(), g.contiguous(), tw.contiguous()
    y = torch.empty_like(x)
    if y.numel():
        consts = lm.const(_FIELD_CONSTS[lm.FR.p], x.device)
        rc = _ntt_lib().zk_ntt_level(
            x.data_ptr(), g.data_ptr(), tw.data_ptr(), y.data_ptr(),
            consts.data_ptr(), n // 2, x.shape[2], lane_block(x.shape[2])[0],
            _stream(x.device))
        _check(rc, "ntt_level")
        LAUNCHES["ntt_level"] += 1
    return y


# ---------------------------------------------------------------------------
# EC kernels
# ---------------------------------------------------------------------------

def padd_ref(p: torch.Tensor, q: torch.Tensor, kind: str) -> torch.Tensor:
    return ec_lm.padd_g1(p, q) if kind == "g1" else ec_lm.padd_g2(p, q)


def fold_padd_ref(x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x.shape[-1] // 2
    return padd_ref(x[..., :h], x[..., h:], kind)


def fold_padd_aa_ref(x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x.shape[-1] // 2
    return ec_lm.padd_aa(x[..., :h], x[..., h:], kind)


def _k(kind: str) -> int:
    if kind not in ("g1", "g2"):
        raise ValueError(f"unknown group {kind!r}")
    return 1 if kind == "g1" else 2


def padd(p: torch.Tensor, q: torch.Tensor, kind: str) -> torch.Tensor:
    """p, q: (..., rows, T) projective planes (broadcastable) -> p + q.
    On the card the kernel reads both through their strides as (B, rows,
    T) views, so a broadcast operand (one point, one column) is read in
    place; only batch dims that do not merge into one are copied."""
    k = _k(kind)
    if not _on_card("padd", p, q):
        return padd_ref(p, q, kind)
    rows = ec_lm.ROWS[kind]
    shape = torch.broadcast_shapes(p.shape, q.shape)
    if shape[-2] != rows:
        raise ValueError(f"padd: {kind} planes have {rows} rows: {shape}")
    T = shape[-1]
    pe = p.expand(shape).reshape(-1, rows, T)
    qe = q.expand(shape).reshape(-1, rows, T)
    B = pe.shape[0]
    out = torch.empty((B, rows, T), dtype=torch.int32, device=p.device)
    if out.numel():
        rc = _lib().zk_padd(k, pe.data_ptr(), qe.data_ptr(), out.data_ptr(),
                            B, T, *pe.stride(), *qe.stride(),
                            _stream(p.device))
        _check(rc, "padd")
        LAUNCHES[f"padd/{kind}"] += 1
        key = f"{kind}/B{B}/T{T}"
        PADD_SHAPES[key] = PADD_SHAPES.get(key, 0) + 1
    return out.reshape(shape)


def _fold_args(name: str, x: torch.Tensor, rows_in: int):
    if x.dim() != 3 or x.shape[1] != rows_in or x.shape[2] % 2:
        raise ValueError(f"{name}: expected (B, {rows_in}, even m), got "
                         f"{tuple(x.shape)}")
    return x.contiguous(), x.shape[0], x.shape[2] // 2


def _count_fold(name: str, kind: str, B: int, h: int, n: int) -> None:
    LAUNCHES[f"{name}/{kind}"] += 1
    key = f"{name}/{kind}/B{B}/h{h}/n{n}"
    FOLD_SHAPES[key] = FOLD_SHAPES.get(key, 0) + 1


def fold_padd_levels_ref(x: torch.Tensor, kind: str, n: int) -> list:
    out = []
    for _ in range(n):
        x = fold_padd_ref(x, kind)
        out.append(x)
    return out


def fold_padd_levels(x: torch.Tensor, kind: str, n: int) -> list:
    """x: (B, rows, m) projective -> the n planes of widths m/2, m/4, ...,
    m/2^n of the halving sum tree, level l + 1's lane j = level l's lane j
    + lane j + width (x for l = 0).  m must be a multiple of 2^n.  On the
    card up to FOLD_LEVELS[kind] levels (G1 3, G2 1) run in ONE launch
    (more take more launches): a block owns a closed subtree and adds it
    level by level, writing every level out once; the planes of a launch
    are views of one allocation."""
    k = _k(kind)
    rows = ec_lm.ROWS[kind]
    on_card = _on_card("fold_padd_levels", x)
    if n < 1 or x.dim() != 3 or x.shape[1] != rows or \
            x.shape[2] % (1 << n):
        raise ValueError(f"fold_padd_levels: expected (B, {rows}, m) with m "
                         f"a multiple of 2^{n}, got {tuple(x.shape)}")
    if not on_card:
        return fold_padd_levels_ref(x, kind, n)
    out = []
    while len(out) < n:                 # more levels than fit: launches
        x = x.contiguous()
        B, h = x.shape[0], x.shape[2] // 2
        widths = [h >> i for i in range(min(n - len(out),
                                            FOLD_LEVELS[kind]))]
        buf = torch.empty(B * rows * sum(widths), dtype=torch.int32,
                          device=x.device)
        if buf.numel():
            rc = _lib().zk_fold_padd_levels(k, x.data_ptr(), buf.data_ptr(),
                                            B, h, len(widths),
                                            _stream(x.device))
            _check(rc, "fold_padd_levels")
            _count_fold("fold_padd", kind, B, h, len(widths))
        at = 0
        for w in widths:
            out.append(buf[at:at + B * rows * w].view(B, rows, w))
            at += B * rows * w
        x = out[-1]
    return out


def fold_padd(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (B, rows, m) projective, m even -> (B, rows, m/2):
    out[..., j] = x[..., j] + x[..., j + m/2].  One level of
    fold_padd_levels, on the same kernel."""
    return fold_padd_levels(x, kind, 1)[0]


# One launch of the fold kernel takes 1 to FOLD_LEVELS[kind] levels (it is
# compiled for each; G2's kernel for more than one level spills).  A level
# costs it no shared memory: the block stages its operands back from the
# lanes it stored one level down.  Its shared memory, after
# csrc/lm_kernels.cu: the cooperative add's region (32 adds of STRIDE
# ints, then its constants) beside its static offsets.
FOLD_LEVELS = {"g1": 3, "g2": 1}
FOLD_REGION = {"g1": (317, 21), "g2": (883, 63)}      # (STRIDE, constants)
FOLD_STATIC_BYTES = 528
BLOCK_SHARED_MAX = 232448                            # 227 KB a block
# A level wider than this runs alone.  On the card (tools/fold_shapes.py,
# PERF.md) a whole call of three G1 levels at batch 128 takes longer than
# its levels' three whole calls when the first is 4096 or 8192 wide (1.68-
# 1.73 against 1.62-1.66 ms; 3.42-3.45 against 3.16-3.19) and less from
# 2048 down (0.84 against 0.86-0.89 ms; 0.25-0.26 against 0.28-0.29 at 512)
FOLD_WIDE = 2048


def fold_smem_bytes(kind: str) -> int:
    """Shared memory of one block of a fold launch, any number of levels."""
    stride, consts = FOLD_REGION[kind]
    return 4 * (32 * stride + consts) + FOLD_STATIC_BYTES


def fold_plan(kind: str, h: int, floor: int) -> list:
    """Levels per launch that fold a (B, rows, h) plane down to width
    `floor` (widths halve while above it): one a launch while a level is
    wider than FOLD_WIDE, then FOLD_LEVELS[kind] a launch, greedily; e.g.
    G1 16384 -> 128 is [1, 1, 3, 2]."""
    _k(kind)
    widths, w = [], h
    while w > floor:
        if w % 2:
            raise ValueError(f"fold_plan: width {w} is odd")
        w //= 2
        widths.append(w)
    plan = []
    while len(widths) > sum(plan):
        wide = widths[sum(plan)] > FOLD_WIDE
        plan.append(1 if wide else min(FOLD_LEVELS[kind],
                                       len(widths) - sum(plan)))
    return plan


def fold_padd_aa(x: torch.Tensor, kind: str,
                 idx: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, arows, m) AFFINE planes -> (B, rows, m/2) PROJECTIVE:
    out[..., j] = x[..., j] (+) x[..., j + m/2] (level 0 of the MSM sum
    tree: 10 products instead of 12, 43/85-row reads instead of 63/126).
    On the card a cooperative add of two product rounds.

    With idx (B, m) int32, x is a (rows, arows) table of affine points,
    one a row, and the plane is the table read through idx: out[b, :, j] =
    x[idx[b, j]] (+) x[idx[b, j + m/2]], as fold_padd_aa(x[idx].transpose(
    -1, -2)) gives.  On the card the same kernel stages each add's two
    operands straight from the rows idx names, a row's words side by side;
    the plane is never written.  Counted as the plane's launch would be.
    Every index lies in [0, rows of x), else IndexError, on the card as
    off it: checked before the launch (a read of idx's least and greatest
    entry), except while a CUDA graph is captured, where an index out of
    range would read outside the table (the MSM's are in range by
    construction)."""
    k = _k(kind)
    rows, arows = ec_lm.ROWS[kind], 2 * k * lm.N_LIMBS + 1
    if idx is None:
        if not _on_card("fold_padd_aa", x):
            return fold_padd_aa_ref(x, kind)
        x, B, h = _fold_args("fold_padd_aa", x, arows)
    else:
        on_card = _on_card("fold_padd_aa", x, idx)
        if x.dim() != 2 or x.shape[1] != arows or idx.dim() != 2 or \
                idx.shape[1] % 2:
            raise ValueError(f"fold_padd_aa: expected a table (n, {arows}) "
                             f"and idx (B, even m), got {tuple(x.shape)} "
                             f"and {tuple(idx.shape)}")
        if idx.numel() and not (on_card and
                                torch.cuda.is_current_stream_capturing()):
            lo, hi = (int(v) for v in torch.aminmax(idx))
            if lo < 0 or hi >= x.shape[0]:
                raise IndexError(f"fold_padd_aa: idx spans [{lo}, {hi}], "
                                 f"the table has {x.shape[0]} rows")
        if not on_card:
            return fold_padd_aa_ref(x[idx.long()].transpose(-1, -2), kind)
        x, idx = x.contiguous(), idx.contiguous()
        B, h = idx.shape[0], idx.shape[1] // 2
    out = torch.empty((B, rows, h), dtype=torch.int32, device=x.device)
    if out.numel():
        rc = _lib().zk_fold_padd_aa(k, x.data_ptr(), None if idx is None
                                    else idx.data_ptr(), out.data_ptr(), B,
                                    h, _stream(x.device))
        _check(rc, "fold_padd_aa")
        _count_fold("fold_padd_aa", kind, B, h, 1)
    return out


def occupancy(levels: int = 1) -> dict:
    """Resident blocks per SM the card reports for each cooperative
    kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the kernel's
    shared memory; the fold kernel at `levels` levels)."""
    blocks = (ctypes.c_int * 6)()
    _check(_lib().zk_occupancy(levels, blocks), "occupancy")
    names = ["padd/g1", "padd/g2", "fold_padd_aa/g1", "fold_padd_aa/g2",
             f"fold_padd/g1/n{levels}", f"fold_padd/g2/n{levels}"]
    return dict(zip(names, blocks))


def ladder_occupancy() -> dict:
    """Resident blocks per SM of the scalar_mul ladder (two teams a
    block), G1 and G2, at its shared memory."""
    blocks = (ctypes.c_int * 2)()
    _check(_lib().zk_ladder_occupancy(blocks), "ladder_occupancy")
    return {"scalar_mul/g1": blocks[0], "scalar_mul/g2": blocks[1]}


# ---------------------------------------------------------------------------
# batch inversion: fold_mul, inv, and batch_inv's own kernels
# ---------------------------------------------------------------------------

def _field_consts(name: str, fs: lm.FieldSpec, device) -> torch.Tensor:
    if fs.p not in _FIELD_CONSTS:
        raise ValueError(f"{name}: kernel takes Fr or Fq only")
    return lm.const(_FIELD_CONSTS[fs.p], device)


def fold_mul_ref(x: torch.Tensor, fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    h = x.shape[-1] // 2
    return lm.mont_mul_ref(x[..., :h], x[..., h:], fs)


def fold_mul(x: torch.Tensor, fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """x: (B, 21, m), m even -> (B, 21, m/2): the Montgomery product of
    the two halves of the lane axis.  On the card every width down to
    m/2 = 1 runs in the kernel."""
    if not _on_card("fold_mul", x):
        return fold_mul_ref(x, fs)
    x, B, h = _fold_args("fold_mul", x, lm.N_LIMBS)
    consts = _field_consts("fold_mul", fs, x.device)
    out = torch.empty((B, lm.N_LIMBS, h), dtype=torch.int32, device=x.device)
    if out.numel():
        rc = _chains().zk_fold_mul(x.data_ptr(), out.data_ptr(),
                                   consts.data_ptr(), B, h,
                                   _stream(x.device))
        _check(rc, "fold_mul")
        LAUNCHES["fold_mul"] += 1
    return out


inv_ref = lm.inv


def inv(a: torch.Tensor, fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """a: (21, T) Montgomery form -> 1/a by Fermat (inv(0) = 0).  On the
    card `a` is read in place through its strides, whatever they are (the
    root column of batch_inv arrives as a transposed view), and the result
    has the same layout."""
    if not _on_card("inv", a):
        return inv_ref(a, fs)
    if a.dim() != 2 or a.shape[0] != lm.N_LIMBS:
        raise ValueError(f"inv: expected (21, T), got {tuple(a.shape)}")
    consts = _field_consts("inv", fs, a.device)
    bits = lm.const(fs.p_minus_2_bits, a.device)
    out = torch.empty_like(a)
    if out.numel():
        rc = _chains().zk_inv(a.data_ptr(), out.data_ptr(),
                              consts.data_ptr(), bits.data_ptr(),
                              bits.shape[0], a.shape[1], *a.stride(),
                              *out.stride(), _stream(a.device))
        _check(rc, "inv")
        LAUNCHES["inv"] += 1
    return out


def batch_inv_ref(d: torch.Tensor, fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    return lm.batch_inv_lanes(d, fs)


# batch_inv's launches (csrc/lm_chains.cu), decided here and only here: a
# tile launch takes at most INV_LEVELS levels, a block inv_cols columns of
# the launch's top level (at least INV_COLS, a warp's coalesced row) with
# THREADS threads, and shared memory for 2^(levels-1) strips and, going
# down, two stage slots a thread (inv_tile_smem); both are passed to the
# launch, which checks them.  The top kernel takes the levels of width <=
# INV_TOP, a block (one warp) a row, with INV_TOP_SMEM bytes of static
# shared memory (its launch refuses any other count).  A launch takes at
# most INV_ROWS rows and fewer than 2^31 elements (32-bit indices).
INV_LEVELS, INV_COLS, INV_TOP, INV_ROWS = 5, 32, 32, 65535
INV_TOP_SMEM = 4 * (4 * lm.N_LIMBS + 256 + 2 * (32 + 96) +
                    lm.N_LIMBS * 2 * INV_TOP)


def inv_cols(X: int, lo: int, levels: int) -> int:
    """Columns of its top level that a block of a tile launch owns: 64
    where the launch takes at most four levels and its top level is that
    wide (43 KB of strips, four blocks an SM; the narrowest level has an
    item for half the threads), else INV_COLS."""
    wide = levels <= 4 and X >> (lo + levels) >= 2 * INV_COLS
    return 2 * INV_COLS if wide else INV_COLS


def inv_tile_smem(levels: int, cols: int, down: bool) -> int:
    """Shared memory of a block of a tile launch: 2^(levels-1) strips of
    `cols` columns, and going down the threads' two stage slots."""
    return 4 * lm.N_LIMBS * ((1 << (levels - 1)) * cols +
                             (2 * THREADS if down else 0))


@functools.lru_cache(maxsize=None)
def batch_inv_levels(X: int) -> tuple:
    """The levels of batch_inv's launches over rows of X = 2^n lanes ->
    (up, t0, down): up, the levels of each fold_mul_levels launch, from
    level 0; t0, the level the top kernel starts from (it takes levels
    t0+1 .. n, the chain and the walk back to u_t0); down, the levels of
    each batch_inv_down launch, the mirror of up.  The top takes min(n,
    INV_LEVELS) levels, so every tile launch's top level is at least
    INV_COLS wide; the rest is split into as few launches as
    INV_LEVELS allows, the first the smallest: X = 16384 is up [4, 5], the
    top 5, down [5, 4], five launches (one at X <= 32)."""
    if X < 1 or X & (X - 1):
        raise ValueError(f"batch_inv: X must be a power of two, got {X}")
    n = X.bit_length() - 1
    rest = n - min(n, INV_LEVELS)
    parts = -(-rest // INV_LEVELS)
    up = tuple(rest // parts + (i >= parts - rest % parts)
               for i in range(parts)) if parts else ()
    return up, rest, up[::-1]


def batch_inv_plan(B: int, X: int) -> list:
    """batch_inv's launches over (B, 21, X), in order -> [(kernel, lo,
    levels, grid, threads, shared bytes a block)]: "fold_mul_levels"
    writes v_{lo+1} .. v_{lo+levels}; "top" starts from v_lo and writes
    u_lo; "down" writes u_lo from u_{lo+levels}.  grid is (blocks along
    the lanes, rows)."""
    up, t0, down = batch_inv_levels(X)
    plan, lo = [], 0
    for k in up:
        plan.append(_tile("fold_mul_levels", B, X, lo, k))
        lo += k
    n = X.bit_length() - 1
    plan.append(("top", t0, n - t0, (B, 1), 32, INV_TOP_SMEM))
    for k in down:
        lo -= k
        plan.append(_tile("down", B, X, lo, k))
    return plan


def _tile(kernel: str, B: int, X: int, lo: int, levels: int) -> tuple:
    """One tile launch of batch_inv_plan, `levels` levels from level lo ->
    (kernel, lo, levels, grid, threads, shared bytes a block)."""
    cols = inv_cols(X, lo, levels)
    return (kernel, lo, levels, ((X >> (lo + levels)) // cols, B), THREADS,
            inv_tile_smem(levels, cols, kernel == "down"))


def batch_inv_heap(X: int) -> dict:
    """Where batch_inv's buffer holds each level of the tree on the way
    up: {l: (first lane, width)}, v_l at lanes [X >> l, 2 (X >> l)) for
    1 <= l <= t0 (the top keeps the levels above in shared memory).  On
    the way down u_l takes lanes [0, X >> l), u_0 the whole row."""
    _, t0, _ = batch_inv_levels(X)
    return {l: (X >> l, X >> l) for l in range(1, t0 + 1)}


def _tile_lanes(X: int, lo: int, levels: int, strips: int,
                device) -> torch.Tensor:
    """(tiles, strips, cols) lanes of the strips that the blocks of a tile
    launch of `levels` levels from level lo own (cols = inv_cols): block
    i, strip m, column t at i * cols + m * (X >> (lo + levels)) + t."""
    hk, cols = X >> (lo + levels), inv_cols(X, lo, levels)
    ar = functools.partial(torch.arange, device=device)
    return (ar(hk // cols)[:, None, None] * cols +
            ar(strips)[None, :, None] * hk + ar(cols)[None, None, :])


def _strips(buf: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """(B, 21, X) at lanes (tiles, strips, cols) -> (B, tiles, strips, 21,
    cols): each block's strips as the kernels hold them."""
    return buf[:, :, lanes].permute(0, 2, 3, 1, 4)


def _store(buf: torch.Tensor, lanes: torch.Tensor, x: torch.Tensor) -> None:
    buf[:, :, lanes] = x.permute(0, 3, 1, 2, 4)


def fold_mul_levels_ref(d: torch.Tensor, heap: torch.Tensor, lo: int,
                        levels: int, fs: lm.FieldSpec = lm.FQ) -> None:
    """Plain version of fold_mul_levels, block by block as the kernel
    walks it: strip m of level lo + i is strip m times strip m + S of the
    level below (S its strips), each level stored at its heap lanes."""
    X = d.shape[-1]
    S = 1 << (levels - 1)
    lanes = _tile_lanes(X, lo, levels, S, d.device)
    src, base = (d, 0) if lo == 0 else (heap, X >> lo)
    x = mont_mul_ref(_strips(src, base + lanes),
                     _strips(src, base + lanes + (X >> (lo + 1))), fs)
    _store(heap, (X >> (lo + 1)) + lanes, x)
    for i in range(2, levels + 1):
        S //= 2
        x = mont_mul_ref(x[:, :, :S], x[:, :, S:2 * S], fs)
        _store(heap, (X >> (lo + i)) + lanes[:, :S], x)


def batch_inv_top_ref(d: torch.Tensor, heap: torch.Tensor, t0: int,
                      fs: lm.FieldSpec = lm.FQ) -> None:
    """Plain version of the top kernel: u_t0 = the batch inversion of
    v_t0 (d's first w = X >> t0 lanes at t0 = 0, else heap lanes [w, 2w)),
    into heap lanes [0, w)."""
    w = d.shape[-1] >> t0
    v = d[..., :w] if t0 == 0 else heap[..., w:2 * w]
    heap[..., :w] = lm.batch_inv_lanes(v, fs)


def batch_inv_down_ref(d: torch.Tensor, heap: torch.Tensor, lo: int,
                       levels: int, fs: lm.FieldSpec = lm.FQ) -> None:
    """Plain version of batch_inv_down, block by block as the kernel walks
    it: from u_{lo+levels} at heap lanes [0, X >> (lo+levels)), each level
    u_l's strip m begets strip m (times v_l strip m + S) and strip m + S
    (times v_l strip m); u_lo goes to heap lanes [0, X >> lo)."""
    X = d.shape[-1]
    top = lo + levels
    lanes = _tile_lanes(X, lo, levels, 1 << levels, d.device)
    u = _strips(heap, lanes[:, :1])
    for lv in range(top - 1, lo - 1, -1):
        S = u.shape[2]
        src, base = (d, 0) if lv == 0 else (heap, X >> lv)
        ln = base + lanes[:, :S]
        right = mont_mul_ref(u, _strips(src, ln), fs)
        left = mont_mul_ref(u, _strips(src, ln + (X >> (lv + 1))), fs)
        u = torch.cat([left, right], 2)
    _store(heap, lanes, u)


def _inv_rows(name: str, shape) -> None:
    """Refuses what no batch_inv launch takes: rows of a power of two
    lanes, at most INV_ROWS of them (the grid's y axis), fewer than 2^31
    elements (32-bit indices)."""
    if len(shape) != 3 or shape[-1] & (shape[-1] - 1) or not shape[-1]:
        raise ValueError(f"{name}: expected (B, 21, power of two), got "
                         f"{tuple(shape)}")
    if shape[0] > INV_ROWS or shape[0] * shape[1] * shape[2] >= 1 << 31:
        raise ValueError(f"{name}: at most {INV_ROWS} rows and fewer than "
                         f"2^31 elements (32-bit indices), got "
                         f"{tuple(shape)}")


def _inv_args(name: str, d: torch.Tensor, heap: torch.Tensor, lo: int,
              levels: int = 0) -> bool:
    """Checks of a batch_inv launch (a tile launch of `levels` levels from
    level lo, or the top from level lo when levels is 0) -> whether it
    runs on the card."""
    _inv_rows(name, d.shape)
    if d.shape[1] != lm.N_LIMBS or heap.shape != d.shape or \
            not heap.is_contiguous():
        raise ValueError(f"{name}: expected d (B, 21, power of two) and a "
                         f"contiguous heap of its shape, got "
                         f"{tuple(d.shape)} {tuple(heap.shape)}")
    X = d.shape[-1]
    if levels == 0 and not 1 <= X >> lo <= INV_TOP or levels and (
            not 1 <= levels <= INV_LEVELS or X >> (lo + levels) < INV_COLS):
        raise ValueError(f"{name}: {levels} levels from level {lo} is no "
                         f"launch of the plan over {X} lanes")
    return _on_card(name, d, heap)


def _tile_launch(name: str, step: str, key: str, fn, d, heap, lo, levels,
                 fs) -> None:
    """One tile launch (the plan's `step`, "fold_mul_levels" or "down")
    with the plan's columns and shared bytes, counted under `key`."""
    if fs.p not in _FIELD_PN:
        raise ValueError(f"{name}: kernel takes Fr or Fq only")
    B, _, X = d.shape
    smem = _tile(step, B, X, lo, levels)[5]
    rc = fn(d.data_ptr(), heap.data_ptr(), _FIELD_PN[fs.p].ctypes.data, B,
            X, lo, levels, inv_cols(X, lo, levels), smem, _stream(d.device))
    _check(rc, name)
    LAUNCHES[key] += 1


def fold_mul_levels(d: torch.Tensor, heap: torch.Tensor, lo: int,
                    levels: int, fs: lm.FieldSpec = lm.FQ) -> None:
    """Levels lo+1 .. lo+levels of batch_inv's product tree over d (B, 21,
    X), v_l[j] = v_{l-1}[j] * v_{l-1}[j + (X >> l)], written IN PLACE into
    heap (B, 21, X) at lanes [X >> l, 2 (X >> l)); v_lo is d (lo = 0) or
    the heap's.  fold_mul's counterpart at several levels: on the card ONE
    launch (counted as fold_mul), a block folding inv_cols columns of the
    top level through shared memory with the Karatsuba register
    product."""
    d = d.contiguous()
    if not _inv_args("fold_mul_levels", d, heap, lo, levels):
        return fold_mul_levels_ref(d, heap, lo, levels, fs)
    _tile_launch("fold_mul_levels", "fold_mul_levels", "fold_mul",
                 _chains().zk_fold_mul_levels, d, heap, lo, levels, fs)


def batch_inv_top(d: torch.Tensor, heap: torch.Tensor, t0: int,
                  fs: lm.FieldSpec = lm.FQ) -> None:
    """The top of batch_inv's tree from level t0 (w = X >> t0 <= INV_TOP
    lanes): up to the root, its inverse by Fermat, and down to u_t0, IN
    PLACE into heap lanes [0, w).  On the card one launch, a warp a row."""
    d = d.contiguous()
    if not _inv_args("batch_inv_top", d, heap, t0):
        return batch_inv_top_ref(d, heap, t0, fs)
    B, _, X = d.shape
    consts = _field_consts("batch_inv_top", fs, d.device)
    bits = lm.const(fs.p_minus_2_bits, d.device)
    rc = _chains().zk_batch_inv_top(d.data_ptr(), heap.data_ptr(),
                                    consts.data_ptr(), bits.data_ptr(),
                                    bits.shape[0], B, X, t0, INV_TOP_SMEM,
                                    _stream(d.device))
    _check(rc, "batch_inv_top")
    LAUNCHES["batch_inv/top"] += 1


def batch_inv_down(d: torch.Tensor, heap: torch.Tensor, lo: int,
                   levels: int, fs: lm.FieldSpec = lm.FQ) -> None:
    """The walk down of batch_inv from u_{lo+levels} (heap lanes [0, X >>
    (lo+levels))) to u_lo, written IN PLACE into heap lanes [0, X >> lo),
    reading v_l from the heap (v_0 from d).  On the card ONE launch, the
    tiles of fold_mul_levels in reverse."""
    d = d.contiguous()
    if not _inv_args("batch_inv_down", d, heap, lo, levels):
        return batch_inv_down_ref(d, heap, lo, levels, fs)
    _tile_launch("batch_inv_down", "down", "batch_inv/down",
                 _chains().zk_batch_inv_down, d, heap, lo, levels, fs)


def batch_inv(d: torch.Tensor, fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """Montgomery batch inversion over the last axis of (B, 21, X), X a
    power of two; zero lanes must already be mapped to one.  Replaces the
    JAX package's batch_inv (ops/pallas/lm_kernels.py, a composite of its
    fold_mul, inv and mont_mul kernels).  On the H100 the integer
    multiply-adds of about 3X products a row bound it where the tree is
    wide, and the Fermat chain's latency (363 dependent products) at the
    root: so the tree's levels run several a launch through shared memory
    (no launch and no pass over device memory a level) and the chain runs
    once, on a warp a row.  The tree of batch_inv_ref pair for pair, as
    batch_inv_plan's launches (at most 5 up to X = 2^15, one at X <= 32):
    fold_mul_levels up, the top (the narrow levels and the chain),
    batch_inv_down, all in ONE buffer, the result (no copy, no
    concatenation).  On the CPU the same steps run their plain versions.
    The launches index with 32 bits: B at most INV_ROWS (65535) and B *
    21 * X under 2^31, else ValueError, on either device."""
    _inv_rows("batch_inv", d.shape)
    d = d.contiguous()
    heap = torch.empty_like(d)
    if not heap.numel():
        return heap
    for kernel, lo, levels, *_ in batch_inv_plan(d.shape[0], d.shape[-1]):
        if kernel == "fold_mul_levels":
            fold_mul_levels(d, heap, lo, levels, fs)
        elif kernel == "top":
            batch_inv_top(d, heap, lo, fs)
        else:
            batch_inv_down(d, heap, lo, levels, fs)
    return heap


# ---------------------------------------------------------------------------
# in-kernel chains: products and double-and-add
# ---------------------------------------------------------------------------

def mont_chain_ref(a: torch.Tensor, b: torch.Tensor, iters: int,
                   fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    x = a
    for _ in range(iters):
        x = lm.mont_mul_ref(x, b, fs)
    return x


def mont_chain(a: torch.Tensor, b: torch.Tensor, iters: int,
               fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """a, b: (21, T) -> a * b^iters, `iters` Montgomery products one after
    another inside one kernel.  Replaces pallas_chain of
    scripts/micro_montmul.py.  A chain issues little but its products, so
    the integer multiply-add pipe bounds it on the H100: mm2d's body (the
    Karatsuba register product, 915 multiply-adds against the
    schoolbook's 1,113; x in registers; p and n' passed by value) with one
    lane a thread, 1,024 blocks at T = 131,072."""
    if iters < 0:
        raise ValueError(f"mont_chain: iters must be >= 0, got {iters}")
    if not _on_card("mont_chain", a, b):
        return mont_chain_ref(a, b, iters, fs)
    if a.dim() != 2 or a.shape[0] != lm.N_LIMBS or a.shape != b.shape:
        raise ValueError(f"mont_chain: expected two (21, T), got "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    if fs.p not in _FIELD_PN:
        raise ValueError("mont_chain: kernel takes Fr or Fq only")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if out.numel():
        rc = _chains().zk_mont_chain(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(),
                                     _FIELD_PN[fs.p].ctypes.data,
                                     a.shape[1], iters, _stream(a.device))
        _check(rc, "mont_chain")
        LAUNCHES["mont_chain"] += 1
    return out


def _scalar_bits(bits, T: int, device) -> torch.Tensor:
    """bits as an int32 tensor on `device`: (nbits,), one scalar for all
    T lanes, or (nbits, T), a scalar per lane; raises on any other shape."""
    bits = torch.as_tensor(bits, dtype=torch.int32, device=device)
    if bits.dim() not in (1, 2) or (bits.dim() == 2 and bits.shape[1] != T):
        raise ValueError(f"scalar_mul: expected bits (nbits,) or (nbits, "
                         f"{T}), got {tuple(bits.shape)}")
    return bits.contiguous()


def scalar_mul_ref(pts: torch.Tensor, bits, kind: str) -> torch.Tensor:
    """The assembly's double-and-add (groth16/device.py names it
    scalar_mul_plane): acc = where(bit, acc + base, acc), base = base +
    base, least significant bit first, acc starting at the identity."""
    bits = _scalar_bits(bits, pts.shape[-1], pts.device)
    acc = ec_lm.identity_plane(kind, (), pts.shape[-1], pts.device)
    base = pts
    for i in range(bits.shape[0]):
        added = padd_ref(acc, base, kind)
        acc = torch.where(bits[i] == 1, added, acc)
        base = padd_ref(base, base, kind)
    return acc


def scalar_mul(pts: torch.Tensor, bits, kind: str) -> torch.Tensor:
    """pts: (rows, T) projective base points, one per lane; bits: the
    scalar as 0/1 values, least significant first, (nbits,) shared by all
    lanes or (nbits, T) one scalar per lane -> (rows, T) k*P by
    double-and-add, every bit inside one launch of the cooperative add."""
    k = _k(kind)
    if not _on_card("scalar_mul", pts):
        return scalar_mul_ref(pts, bits, kind)
    rows = ec_lm.ROWS[kind]
    if pts.dim() != 2 or pts.shape[0] != rows:
        raise ValueError(f"scalar_mul: expected ({rows}, T), got "
                         f"{tuple(pts.shape)}")
    bits = _scalar_bits(bits, pts.shape[1], pts.device)
    pts = pts.contiguous()
    out = torch.empty_like(pts)
    if out.numel():
        sbt = 1 if bits.dim() == 2 else 0
        rc = _lib().zk_scalar_mul(k, pts.data_ptr(), out.data_ptr(),
                                  bits.data_ptr(), bits.stride(0), sbt,
                                  bits.shape[0], pts.shape[1],
                                  _stream(pts.device))
        _check(rc, "scalar_mul")
        LAUNCHES[f"scalar_mul/{kind}"] += 1
        key = f"{kind}/T{pts.shape[1]}/b{bits.shape[0]}/" + \
            ("lane" if sbt else "shared")
        SCALAR_SHAPES[key] = SCALAR_SHAPES.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------------
# the Poseidon permutation
# ---------------------------------------------------------------------------

POSEIDON_WIDTHS = (3, 4, 5)


def _poseidon_rounds(t: int) -> tuple:
    if t not in POSEIDON_WIDTHS:
        raise ValueError(f"poseidon: width t must be 3, 4 or 5, got {t}")
    return N_ROUNDS_F, N_ROUNDS_P[t - 2]


def permutation_ref(state: torch.Tensor, t: int) -> torch.Tensor:
    """Plain version of the permutation on state (..., t, 21, T),
    Montgomery: per round the constant add and one weak round, the S-box
    (x^5) on every element in full rounds and on element 0 in partial
    ones, and the MDS mix."""
    c_arr, m_arr = poseidon.tables(t, state.device)
    r_f, r_p = _poseidon_rounds(t)
    half = r_f // 2
    for r in range(r_f + r_p):
        state = lm.weak_norm(state + c_arr[r])
        if r < half or r >= half + r_p:
            state = poseidon.sbox(state)
        else:
            state = torch.cat([poseidon.sbox(state[..., 0:1, :, :]),
                               state[..., 1:, :, :]], -3)
        state = poseidon.mix(state, m_arr)
    return state


def poseidon_trace_ref(inputs_mont: torch.Tensor):
    """Plain version of the hash with its S-box trace: inputs (k, 21, T)
    Montgomery, t = k + 1 -> (out (21, T), trace (n_sbox*3, 21, T)); the
    trace in build_poseidon's allocation order (x^2, x^4, x^5 of each
    S-box)."""
    t = inputs_mont.shape[0] + 1
    c_arr, m_arr = poseidon.tables(t, inputs_mont.device)
    r_f, r_p = _poseidon_rounds(t)
    half = r_f // 2
    state = torch.cat([torch.zeros_like(inputs_mont[:1]), inputs_mont], 0)

    def sbox_trace(x):
        x2 = lm.mont_mul(x, x, lm.FR)
        x4 = lm.mont_mul(x2, x2, lm.FR)
        x5 = lm.mont_mul(x4, x, lm.FR)
        tr = torch.stack([x2, x4, x5], 1)               # (j, 3, 21, T)
        return x5, tr.reshape(-1, lm.N_LIMBS, x.shape[-1])

    trace = []
    for r in range(r_f + r_p):
        state = lm.weak_norm(state + c_arr[r])
        if r < half or r >= half + r_p:
            state, tr = sbox_trace(state)
        else:
            s0, tr = sbox_trace(state[0:1])
            state = torch.cat([s0, state[1:]], 0)
        trace.append(tr)
        state = poseidon.mix(state, m_arr)
    return state[0], torch.cat(trace, 0)


def poseidon_trace_rows(t: int) -> int:
    """Rows of the S-box trace of width t: three a S-box (243, 264, 300)."""
    r_f, r_p = _poseidon_rounds(t)
    return 3 * (r_f * t + r_p)


def _poseidon(x: torch.Tensor, t: int, zero_first: bool, whole: bool,
              want_trace: bool):
    """One launch of zk_poseidon over the T lanes of x (t - zero_first,
    21, T) -> (out (t or 1, 21, T), trace or None)."""
    r_f, r_p = _poseidon_rounds(t)
    if x.dim() != 3 or x.shape[:2] != (t - zero_first, lm.N_LIMBS):
        raise ValueError(f"poseidon: expected ({t - zero_first}, 21, T), "
                         f"got {tuple(x.shape)}")
    x = x.contiguous()
    T = x.shape[-1]
    out = torch.empty((t if whole else 1, lm.N_LIMBS, T), dtype=torch.int32,
                      device=x.device)
    trace = torch.empty((poseidon_trace_rows(t), lm.N_LIMBS, T),
                        dtype=torch.int32, device=x.device) \
        if want_trace else None
    if T:
        c_arr, m_arr = poseidon.tables(t, x.device)
        consts = _field_consts("poseidon", lm.FR, x.device)
        rc = _poseidon_lib().zk_poseidon(
            t, x.data_ptr(), out.data_ptr(),
            trace.data_ptr() if want_trace else None, consts.data_ptr(),
            c_arr.data_ptr(), m_arr.data_ptr(), r_p, T, int(zero_first),
            int(whole), _stream(x.device))
        _check(rc, "poseidon")
        LAUNCHES[f"poseidon/t{t}"] += 1
    return out, trace


def permutation(state: torch.Tensor, t: int) -> torch.Tensor:
    """The Poseidon permutation of width t on state (..., t, 21, T),
    Montgomery.  On the card one launch: leading dims ride the lane axis."""
    if not _on_card("poseidon", state):
        return permutation_ref(state, t)
    if state.dim() < 3 or state.shape[-3] != t:
        raise ValueError(f"poseidon: expected (..., {t}, 21, T), got "
                         f"{tuple(state.shape)}")
    lead, T = state.shape[:-3], state.shape[-1]
    x = state.reshape(-1, t, lm.N_LIMBS, T).permute(1, 2, 0, 3)
    out, _ = _poseidon(x.reshape(t, lm.N_LIMBS, -1), t, False, True, False)
    return out.reshape(t, lm.N_LIMBS, -1, T).permute(2, 0, 1, 3).reshape(
        *lead, t, lm.N_LIMBS, T)


def poseidon_trace(inputs_mont: torch.Tensor):
    """Poseidon hash of k = t - 1 inputs (k, 21, T), Montgomery, with its
    S-box trace -> (out (21, T), trace (n_sbox*3, 21, T)).  On the card
    one launch for every lane."""
    if not _on_card("poseidon", inputs_mont):
        return poseidon_trace_ref(inputs_mont)
    t = inputs_mont.shape[0] + 1
    out, trace = _poseidon(inputs_mont, t, True, False, True)
    return out[0], trace


# ---------------------------------------------------------------------------
# the witness's SMT chains (models/census.py eval_smt_trees)
# ---------------------------------------------------------------------------
# n trees over the same T voters side by side on one lane axis of n T
# lanes: lane g is voter g mod T of tree g // T.  Inputs: the key's bits
# (>= L, T) 0/1, shared by the trees; siblings plain and Montgomery (L, 21,
# n T); the leaves' hashes (21, n T) and their traces (264, 21, n T).  Out:
# the roots (21, n T), the trees' witness blocks of build_smt_inclusion in
# tree order (n * smt_block_rows(L), 21, T), and each lane's count of the
# levels it hashed (n T).  A lane's depth d is one past its last nonzero
# sibling; at the levels i >= d its sibling and its incoming c are zero
# forms, and the level's rows are a constant of (i == L - 1, key bit i)
# (smt_zero_table).  smt_chain_ref hashes every level (today's witness on
# the CPU); on the card smt_walk hashes only the levels i < d and copies
# the rest: smt_fill and smt_levels, one launch each.


def smt_level_rows() -> int:
    """Rows of one level: m_sw, the t = 3 trace, m1, m2 (246)."""
    return 3 + poseidon_trace_rows(3)


def smt_head_rows(L: int) -> int:
    """Rows of a block before its levels: lev, the leaf's trace, c_top."""
    return L + 1 + poseidon_trace_rows(4) + 1


def smt_block_rows(L: int) -> int:
    return smt_head_rows(L) + L * smt_level_rows()


def _trees(x: torch.Tensor, n: int) -> torch.Tensor:
    """(R, 21, n T) on the lane axis -> (n, R, 21, T), a view."""
    R, limbs, nT = x.shape
    return x.view(R, limbs, n, nT // n).permute(2, 0, 1, 3)


def smt_depth(sib_plain: torch.Tensor) -> torch.Tensor:
    """(L, 21, n T) plain siblings -> (n T,) int32: one past the last
    nonzero sibling of each lane, 0 if none."""
    L = sib_plain.shape[0]
    nz = (sib_plain != 0).any(dim=-2)                        # (L, n T)
    idx = torch.arange(1, L + 1, dtype=lm.DTYPE,
                       device=sib_plain.device)[:, None]
    return torch.where(nz, idx, torch.zeros_like(idx)).max(dim=0).values


def _smt_level(c, s_m, bit_m, lev_m, after_m, leaf):
    """One level of build_smt_inclusion: ([m_sw, h trace, m1, m2] rows,
    the next c).  Every operand (21, lanes) but the trace (243, 21,
    lanes); c weak-normalized."""
    one = lm.const(lm.FR.one_mont, c.device)
    m_sw = lm.mont_mul(bit_m, lm.sub_n(s_m, c, lm.FR), lm.FR)
    left = lm.weak_norm(c + m_sw)
    right = lm.sub_n(s_m + c, left, lm.FR)
    h, h_tr = poseidon_trace(torch.stack([left, right], 0))
    m1 = lm.mont_mul(lev_m, leaf, lm.FR)
    m2 = lm.mont_mul(lm.sub_n(one, after_m, lm.FR), h, lm.FR)
    return [m_sw[None], h_tr, m1[None], m2[None]], lm.weak_norm(m1 + m2)


def smt_chain_ref(bits: torch.Tensor, sib_plain: torch.Tensor,
                  sib_mont: torch.Tensor, leaf: torch.Tensor,
                  leaf_tr: torch.Tensor):
    """Plain version: every level of every lane hashed in turn, L - 1 down
    to 0, as build_smt_inclusion allocates them.  -> (roots, blocks,
    hashed: L for every lane)."""
    L, _, nT = sib_mont.shape
    T = bits.shape[-1]
    n = nT // T
    dev = leaf.device
    d = smt_depth(sib_plain)
    lev = (torch.arange(L + 1, dtype=lm.DTYPE, device=dev)[:, None]
           == d[None, :]).to(lm.DTYPE)                        # (L+1, n T)
    after = torch.cumsum(lev[:L], 0, dtype=lm.DTYPE)           # 1 at i >= d
    lev_m, after_m = lm.bits_to_mont(lev), lm.bits_to_mont(after)
    bit_m = lm.bits_to_mont(bits[:L].repeat(1, n))
    c_top = lm.mont_mul(lev_m[L], leaf, lm.FR)
    c, levels = c_top, []
    for i in range(L - 1, -1, -1):
        rows, c = _smt_level(c, sib_mont[i], bit_m[i], lev_m[i], after_m[i],
                             leaf)
        levels += rows
    full = torch.cat([lev_m, leaf_tr, c_top[None], *levels], 0)
    blocks = _trees(full, n).reshape(n * smt_block_rows(L), lm.N_LIMBS, T)
    return c, blocks, torch.full((nT,), L, dtype=lm.DTYPE, device=dev)


@functools.lru_cache(maxsize=None)
def smt_zero_table(dev: torch.device) -> torch.Tensor:
    """(4, 246, 21) int32 on `dev`: the rows of a level at or below a
    lane's leaf (i >= d), entry 2 * (i < L - 1) + key bit i, by the plain
    level (on the card its launches).  Sibling, lev and m1 are zero there
    and after is one; the c that comes in is c_top's zero at the top level
    (i = L - 1) and below it what every such level hands on (m2, p in one
    form, normalized), so four entries are all there are.  Made at a
    device's first use (an eager step, before any capture) and held for
    the life of the process, as the round constants are."""
    zero = torch.zeros((lm.N_LIMBS, 1), dtype=lm.DTYPE, device=dev)
    one = lm.bits_to_mont(torch.ones((1,), dtype=lm.DTYPE, device=dev))
    entries, c_in, below = [], zero, None
    for _ in ("top", "below"):
        for bit in (zero, one):
            rows, c_next = _smt_level(c_in, zero, bit, zero, one, zero)
            entries.append(torch.cat(rows, 0)[..., 0])
            if below is None:
                below = c_next
            elif not torch.equal(c_next, below):
                raise RuntimeError("smt_zero_table: levels below a leaf hand "
                                   "on more than one form of zero")
        c_in = below
    return torch.stack(entries).contiguous()


def _smt_args(block: torch.Tensor, L: int, bits: torch.Tensor,
              depth: torch.Tensor):
    n, rows, limbs, T = block.shape
    if rows != smt_block_rows(L) or limbs != lm.N_LIMBS or \
            bits.dim() != 2 or bits.shape[0] < L or bits.shape[1] != T or \
            depth.shape != (n * T,):
        raise ValueError(f"smt: block {tuple(block.shape)}, bits "
                         f"{tuple(bits.shape)}, depth {tuple(depth.shape)} "
                         f"do not fit L = {L}")
    return n, T


def smt_fill_ref(block: torch.Tensor, bits: torch.Tensor,
                 depth: torch.Tensor, L: int) -> None:
    """Plain version of smt_fill: writes every level i >= d of every lane
    of block (n, rows, 21, T) from smt_zero_table, in place."""
    n, T = _smt_args(block, L, bits, depth)
    lr, head = smt_level_rows(), smt_head_rows(L)
    table = smt_zero_table(block.device)
    d = depth.view(n, T)
    for j in range(L):
        i = L - 1 - j
        entry = (0 if j == 0 else 2) + bits[i].long()         # (T,)
        rows = table[entry].permute(1, 2, 0)                  # (lr, 21, T)
        level = block[:, head + j * lr:head + (j + 1) * lr]
        level.copy_(torch.where((i >= d)[:, None, None, :], rows, level))


def smt_fill(block: torch.Tensor, bits: torch.Tensor, depth: torch.Tensor,
             L: int) -> None:
    """Every level at or below each lane's leaf from the table, in place:
    on the card one launch over all of them."""
    if not _on_card("smt", block, bits, depth):
        return smt_fill_ref(block, bits, depth, L)
    n, T = _smt_args(block, L, bits, depth)
    if not (block.is_contiguous() and bits.is_contiguous()):
        raise ValueError("smt_fill: block and bits must be contiguous")
    table = smt_zero_table(block.device)
    rc = _poseidon_lib().zk_smt_fill(
        bits.data_ptr(), depth.data_ptr(), table.data_ptr(),
        block.data_ptr(), _poseidon_rounds(3)[1], L, T, n, smt_head_rows(L),
        _stream(block.device))
    _check(rc, "smt_fill")
    LAUNCHES["smt/fill"] += 1


def smt_levels_ref(block: torch.Tensor, bits: torch.Tensor,
                   sib: torch.Tensor, leaf: torch.Tensor,
                   depth: torch.Tensor):
    """Plain version of smt_levels: c_top, m1 of level d (leaf R) and the
    levels i < d of every lane written into block (n, rows, 21, T), walking
    i = max(d) - 1 .. 0 with each lane joining at d - 1.  -> (roots (21,
    n T), hashed (n T): d)."""
    L, _, nT = sib.shape
    n, T = _smt_args(block, L, bits, depth)
    lr, head = smt_level_rows(), smt_head_rows(L)
    table = smt_zero_table(block.device)
    one = lm.const(lm.FR.one_mont, block.device)
    zero = torch.zeros_like(leaf)
    d, bits_l = depth.long(), bits[:L].repeat(1, n)
    leaf_r = lm.mont_mul(one, leaf, lm.FR)
    block[:, head - 1] = _trees(torch.where(d == L, leaf_r, zero)[None],
                                n)[:, 0]
    # a lane's level d: m1 is leaf R, and c = leaf R + m2 (the table's)
    at = d.clamp(max=L - 1)
    entry = torch.where(at == L - 1, 0, 2) + \
        bits_l.gather(0, at[None])[0].long()
    c = torch.where(d == L, leaf_r,
                    lm.weak_norm(leaf_r + table[entry, lr - 1].T))
    for g in torch.nonzero(d < L)[:, 0].tolist():
        block[g // T, head + (L - 1 - int(d[g])) * lr + lr - 2, :, g % T] = \
            leaf_r[:, g]
    for i in range(int(d.max()) - 1, -1, -1):
        on = i < d
        rows, c_next = _smt_level(c, sib[i], lm.bits_to_mont(bits_l[i]),
                                  zero, zero, leaf)
        level = block[:, head + (L - 1 - i) * lr:head + (L - i) * lr]
        level.copy_(torch.where(on.view(n, 1, 1, T),
                                _trees(torch.cat(rows, 0), n), level))
        c = torch.where(on, c_next, c)
    return c, depth.clone()


def smt_levels(block: torch.Tensor, bits: torch.Tensor, sib: torch.Tensor,
               leaf: torch.Tensor, depth: torch.Tensor):
    """The levels above each lane's leaf, hashed in order, and c_top and m1
    of level d, into block (n, rows, 21, T): on the card one launch, three
    warps a block of 32 lanes.  -> (roots, hashed)."""
    if not _on_card("smt", block, bits, sib, leaf, depth):
        return smt_levels_ref(block, bits, sib, leaf, depth)
    L, _, nT = sib.shape
    n, T = _smt_args(block, L, bits, depth)
    if leaf.shape != (lm.N_LIMBS, nT):
        raise ValueError(f"smt_levels: leaf {tuple(leaf.shape)}, expected "
                         f"(21, {nT})")
    if not all(x.is_contiguous() for x in (block, bits, sib, leaf)):
        raise ValueError("smt_levels: operands must be contiguous")
    root = torch.empty_like(leaf)
    hashed = torch.empty_like(depth)
    table = smt_zero_table(block.device)
    c_arr, m_arr = poseidon.tables(3, block.device)
    rc = _poseidon_lib().zk_smt_levels(
        bits.data_ptr(), sib.data_ptr(), leaf.data_ptr(), depth.data_ptr(),
        table.data_ptr(), block.data_ptr(), root.data_ptr(),
        hashed.data_ptr(), _field_consts("smt", lm.FR, block.device)
        .data_ptr(), c_arr.data_ptr(), m_arr.data_ptr(),
        _poseidon_rounds(3)[1], L, T, n, smt_head_rows(L),
        _stream(block.device))
    _check(rc, "smt_levels")
    LAUNCHES["smt/levels"] += 1
    return root, hashed


def smt_walk(bits: torch.Tensor, sib_plain: torch.Tensor,
             sib_mont: torch.Tensor, leaf: torch.Tensor,
             leaf_tr: torch.Tensor):
    """The chains as the card runs them: each lane's depth, the blocks'
    lev rows and leaf traces, then smt_fill and smt_levels (their plain
    versions on CPU tensors).  -> (roots, blocks, hashed: d)."""
    L, _, nT = sib_mont.shape
    T = bits.shape[-1]
    n = nT // T
    dev = leaf.device
    d = smt_depth(sib_plain)
    lev = lm.bits_to_mont((torch.arange(L + 1, dtype=lm.DTYPE,
                                        device=dev)[:, None]
                           == d[None, :]).to(lm.DTYPE))
    block = torch.empty((n, smt_block_rows(L), lm.N_LIMBS, T),
                        dtype=lm.DTYPE, device=dev)
    head = smt_head_rows(L)
    block[:, :L + 1] = _trees(lev, n)
    block[:, L + 1:head - 1] = _trees(leaf_tr, n)
    bits = bits.contiguous()
    smt_fill(block, bits, d, L)
    root, hashed = smt_levels(block, bits, sib_mont.contiguous(),
                              leaf.contiguous(), d)
    return root, block.view(n * smt_block_rows(L), lm.N_LIMBS, T), hashed


def smt_chain(bits: torch.Tensor, sib_plain: torch.Tensor,
              sib_mont: torch.Tensor, leaf: torch.Tensor,
              leaf_tr: torch.Tensor):
    """The witness's SMT blocks of n trees side by side (see the section's
    head): the plain version on the CPU, smt_walk's two launches on the
    card."""
    if not _on_card("smt", bits, sib_plain, sib_mont, leaf, leaf_tr):
        return smt_chain_ref(bits, sib_plain, sib_mont, leaf, leaf_tr)
    L, limbs, nT = sib_mont.shape
    T = bits.shape[-1]
    if limbs != lm.N_LIMBS or nT % T or sib_plain.shape != sib_mont.shape \
            or leaf.shape != (lm.N_LIMBS, nT) or \
            leaf_tr.shape != (poseidon_trace_rows(4), lm.N_LIMBS, nT):
        raise ValueError(f"smt_chain: siblings {tuple(sib_mont.shape)}, "
                         f"bits {tuple(bits.shape)}, leaf "
                         f"{tuple(leaf.shape)} do not fit")
    return smt_walk(bits, sib_plain, sib_mont, leaf, leaf_tr)


# ---------------------------------------------------------------------------
# the layout experiments: geometry sweeps of the product and the fold, and
# the two int32 controls
# ---------------------------------------------------------------------------
# `tile`, `blk` and `chain` keep the names of the TPU experiments.  On the
# card `tile` is the number of lanes one BLOCK owns (128 threads for the
# arithmetic kernels, 256 for the controls, each thread walking
# tile / threads lanes), `blk` the number of batch rows a block owns, and
# `chain` a run-time count of products.  Any positive tile is legal: the
# blocks cover the lane axis by ceiling division and mask the edge.  The
# plain versions take the same arguments and ignore the geometry.

def _geometry(name: str, **values) -> None:
    for k, v in values.items():
        if int(v) != v or v < 1:
            raise ValueError(f"{name}: {k} must be a positive integer, got "
                             f"{v!r}")


def mm2d_ref(a: torch.Tensor, b: torch.Tensor, tile: int, chain: int,
             fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    return mont_chain_ref(a, b, chain, fs)


def mm2d(a: torch.Tensor, b: torch.Tensor, tile: int, chain: int,
         fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """a, b: (21, T) flat lane axis -> a * b^chain, `chain` Montgomery
    products x <- x*b in one pass (x stays in registers; the Karatsuba
    register product, p and n' passed by value).  tile: lanes per block of
    128 threads; the grid has ceil(T / tile) blocks."""
    _geometry("mm2d", tile=tile)
    if chain < 0:
        raise ValueError(f"mm2d: chain must be >= 0, got {chain}")
    if not _on_card("mm2d", a, b):
        return mm2d_ref(a, b, tile, chain, fs)
    if a.dim() != 2 or a.shape[0] != lm.N_LIMBS or a.shape != b.shape:
        raise ValueError(f"mm2d: expected two (21, T), got {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    if fs.p not in _FIELD_PN:
        raise ValueError("mm2d: kernel takes Fr or Fq only")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if out.numel():
        rc = _layout().zk_mm2d(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               _FIELD_PN[fs.p].ctypes.data, a.shape[1], tile,
                               chain, _stream(a.device))
        _check(rc, "mm2d")
        LAUNCHES["mm2d"] += 1
    return out


def mm3d_ref(a: torch.Tensor, b: torch.Tensor, tile: int, blk: int,
             fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    return lm.mont_mul_ref(a, b, fs)


def mm3d(a: torch.Tensor, b: torch.Tensor, tile: int, blk: int,
         fs: lm.FieldSpec = lm.FQ) -> torch.Tensor:
    """a, b: (B, 21, T), same shape -> a * b, one Montgomery product per
    lane.  A block of 128 threads owns `blk` batch rows by `tile` lanes;
    the grid is (ceil(T / tile), ceil(B / blk)).  Both operands are read
    contiguous (lane stride 1, limb stride T), with no stride arguments
    and no integer division, unlike mont_mul."""
    _geometry("mm3d", tile=tile, blk=blk)
    if not _on_card("mm3d", a, b):
        return mm3d_ref(a, b, tile, blk, fs)
    if a.dim() != 3 or a.shape[1] != lm.N_LIMBS or a.shape != b.shape:
        raise ValueError(f"mm3d: expected two (B, 21, T), got "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    consts = _field_consts("mm3d", fs, a.device)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if out.numel():
        rc = _layout().zk_mm3d(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               consts.data_ptr(), a.shape[0], a.shape[2],
                               tile, blk, _stream(a.device))
        _check(rc, "mm3d")
        LAUNCHES["mm3d"] += 1
    return out


def _fold2d_args(x: torch.Tensor, kind: str, m: int):
    rows = ec_lm.ROWS[kind]
    if x.dim() != 2 or x.shape[0] != rows or m < 2 or m % 2 or \
            x.shape[1] % m:
        raise ValueError(f"fold2d: expected ({rows}, B*m) with m even, got "
                         f"{tuple(x.shape)}, m={m}")
    return rows, x.shape[1] // m, m // 2


def fold2d_ref(x: torch.Tensor, tile: int, kind: str,
               m: int) -> torch.Tensor:
    rows, B, h = _fold2d_args(x, kind, m)
    seg = x.reshape(rows, B, m)
    return padd_ref(seg[..., :h].reshape(rows, B * h),
                    seg[..., h:].reshape(rows, B * h), kind)


def fold2d(x: torch.Tensor, tile: int, kind: str, m: int) -> torch.Tensor:
    """x: (rows, B*m) projective points on a FLAT lane axis, B segments of
    m lanes -> (rows, B*m/2): within each segment b, lane b*m + j is added
    to lane b*m + m/2 + j (one level of the sum tree), on the cooperative
    add of fold_padd.  tile: output lanes a block owns, walked 32 adds at
    a time; the grid is (ceil(m/2 / tile), B)."""
    k = _k(kind)
    _geometry("fold2d", tile=tile)
    rows, B, h = _fold2d_args(x, kind, m)
    if not _on_card("fold2d", x):
        return fold2d_ref(x, tile, kind, m)
    x = x.contiguous()
    out = torch.empty((rows, B * h), dtype=torch.int32, device=x.device)
    if out.numel():
        rc = _lib().zk_fold2d(k, x.data_ptr(), out.data_ptr(), B, h, tile,
                              _stream(x.device))
        _check(rc, "fold2d")
        LAUNCHES[f"fold2d/{kind}"] += 1
    return out


def add_one_ref(a: torch.Tensor, tile: int) -> torch.Tensor:
    return a + 1


def add_one(a: torch.Tensor, tile: int) -> torch.Tensor:
    """a: (R, T) int32 -> a + 1 (wrapping): no arithmetic to speak of, so
    its time is what a launch through this binding and one pass over
    device memory cost (16-byte accesses where the rows allow).  tile:
    lanes per block of 256 threads, each block owning an (R, tile) column
    block."""
    _geometry("add_one", tile=tile)
    if not _on_card("add_one", a):
        return add_one_ref(a, tile)
    if a.dim() != 2:
        raise ValueError(f"add_one: expected (R, T), got {tuple(a.shape)}")
    a = a.contiguous()
    out = torch.empty_like(a)
    if out.numel():
        rc = _layout().zk_add_one(a.data_ptr(), out.data_ptr(), a.shape[0],
                                  a.shape[1], tile, _stream(a.device))
        _check(rc, "add_one")
        LAUNCHES["add_one"] += 1
    return out


def _upsweep_args(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] < 2 or x.shape[1] & (x.shape[1] - 1):
        raise ValueError(f"fused_upsweep: expected (R, power of two >= 2), "
                         f"got {tuple(x.shape)}")


def fused_upsweep_ref(x: torch.Tensor, tile: int = 512) -> torch.Tensor:
    _upsweep_args(x)
    outs = []
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
        outs.append(x)
    return torch.cat(outs, -1)


def fused_upsweep(x: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """x: (R, m) int32, m a power of two -> (R, m - 1): every level of
    the halving sum tree (widths m/2, m/4, ..., 1, wrapping adds) side by
    side, in ONE kernel launch, one block per row.  `tile` is unused, as
    in the TPU experiment's kernel; it is kept so the call reads the same."""
    if not _on_card("fused_upsweep", x):
        return fused_upsweep_ref(x, tile)
    _upsweep_args(x)
    x = x.contiguous()
    R, m = x.shape
    out = torch.empty((R, m - 1), dtype=torch.int32, device=x.device)
    if out.numel():
        rc = _layout().zk_fused_upsweep(x.data_ptr(), out.data_ptr(), R, m,
                                        _stream(x.device))
        _check(rc, "fused_upsweep")
        LAUNCHES["fused_upsweep"] += 1
    return out

"""CUDA kernels over the limb-major core: build, bind, launch, count.

Four kernels, written by hand for Hopper in ``csrc/lm_kernels.cu``:

  ============  ============================================  =============
  wrapper       what it computes                              plain version
  ============  ============================================  =============
  mont_mul      a*b*R^-1 mod p, elementwise, Fr or Fq         mont_mul_ref
  padd          p + q, RCB15 complete add, G1 or G2           padd_ref
  fold_padd     x[..., :m/2] + x[..., m/2:], projective       fold_padd_ref
  fold_padd_aa  the same from AFFINE planes -> projective     fold_padd_aa_ref
  ============  ============================================  =============

Dispatch is by the tensors' device only: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises.  There is no
switch and no fallback: if the kernel library does not build or a launch
fails, the call raises.

The library is compiled from the package's sources with ``nvcc`` at first
use, into ``zkfranchise_tpu_torch/build/`` under a name keyed by a hash of
the sources (an edit rebuilds), and loaded with ctypes.  Each wrapper adds
one to ``LAUNCHES[name]`` per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from .. import ec_lm, lm

PKG = pathlib.Path(__file__).resolve().parents[2]
SOURCES = [PKG / "csrc" / "lm_kernels.cu"]
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont_mul": 0, "padd": 0, "fold_padd": 0, "fold_padd_aa": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblm_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel library if this source hash has no build yet.
    The compiler's resource report (-Xptxas -v) is kept beside it as
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zk_mont_mul.argtypes = [P, P, P, P] + [L] * 14 + [P]
    lib.zk_padd.argtypes = [I, P, P, P, P] + [L] * 6 + [P]
    lib.zk_fold_padd.argtypes = [I, P, P, P, L, L, P]
    lib.zk_fold_padd_aa.argtypes = [I, P, P, P, L, L, P]
    for fn in (lib.zk_mont_mul, lib.zk_padd, lib.zk_fold_padd,
               lib.zk_fold_padd_aa):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_FIELD_CONSTS = {lm.FR.p: lm.pack_consts(lm.FR),
                 lm.FQ.p: lm.pack_consts(lm.FQ)}
_EC_CONSTS = ec_lm.pack_ec_consts()


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


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             fs: lm.FieldSpec = lm.FR) -> torch.Tensor:
    """(..., 21, T) x (..., 21, T) (broadcastable) -> (..., 21, T)
    Montgomery product over Fr or Fq.  On the card, broadcast operands
    (a (..., 21, 1) column, a shared table) are read in place through
    stride 0, never expanded in memory."""
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
    dims = _collapse(shape[:-2], ae.stride()[:-2], be.stride()[:-2])
    if len(dims) > 3:
        ae, be = ae.contiguous(), be.contiguous()
        dims = _collapse(shape[:-2], ae.stride()[:-2], be.stride()[:-2])
    dims = [(1, 0, 0)] * (3 - len(dims)) + dims
    T = shape[-1]
    consts = lm.const(_FIELD_CONSTS[fs.p], a.device)
    rc = _lib().zk_mont_mul(
        ae.data_ptr(), be.data_ptr(), out.data_ptr(), consts.data_ptr(),
        dims[0][0], dims[1][0], dims[2][0], T,
        dims[0][1], dims[1][1], dims[2][1], ae.stride(-2), ae.stride(-1),
        dims[0][2], dims[1][2], dims[2][2], be.stride(-2), be.stride(-1),
        _stream(a.device))
    _check(rc, "mont_mul")
    LAUNCHES["mont_mul"] += 1
    return out


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
    On the card both are expanded to the common shape and made
    contiguous (broadcast operands here are single points or small)."""
    k = _k(kind)
    if not _on_card("padd", p, q):
        return padd_ref(p, q, kind)
    rows = ec_lm.ROWS[kind]
    shape = torch.broadcast_shapes(p.shape, q.shape)
    if shape[-2] != rows:
        raise ValueError(f"padd: {kind} planes have {rows} rows: {shape}")
    T = shape[-1]
    pe = p.expand(shape).reshape(-1, rows, T).contiguous()
    qe = q.expand(shape).reshape(-1, rows, T).contiguous()
    B = pe.shape[0]
    out = torch.empty((B, rows, T), dtype=torch.int32, device=p.device)
    if out.numel():
        consts = lm.const(_EC_CONSTS, p.device)
        rc = _lib().zk_padd(k, pe.data_ptr(), qe.data_ptr(), out.data_ptr(),
                            consts.data_ptr(), B, T, rows * T, T, rows * T,
                            T, _stream(p.device))
        _check(rc, "padd")
        LAUNCHES["padd"] += 1
    return out.reshape(shape)


def _fold_args(name: str, x: torch.Tensor, rows_in: int):
    if x.dim() != 3 or x.shape[1] != rows_in or x.shape[2] % 2:
        raise ValueError(f"{name}: expected (B, {rows_in}, even m), got "
                         f"{tuple(x.shape)}")
    return x.contiguous(), x.shape[0], x.shape[2] // 2


def fold_padd(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (B, rows, m) projective, m even -> (B, rows, m/2):
    out[..., j] = x[..., j] + x[..., j + m/2].  On the card every width
    down to m/2 = 1 runs in the kernel."""
    k = _k(kind)
    if not _on_card("fold_padd", x):
        return fold_padd_ref(x, kind)
    rows = ec_lm.ROWS[kind]
    x, B, h = _fold_args("fold_padd", x, rows)
    out = torch.empty((B, rows, h), dtype=torch.int32, device=x.device)
    if out.numel():
        consts = lm.const(_EC_CONSTS, x.device)
        rc = _lib().zk_fold_padd(k, x.data_ptr(), out.data_ptr(),
                                 consts.data_ptr(), B, h, _stream(x.device))
        _check(rc, "fold_padd")
        LAUNCHES["fold_padd"] += 1
    return out


def fold_padd_aa(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (B, arows, m) AFFINE planes -> (B, rows, m/2) PROJECTIVE:
    out[..., j] = x[..., j] (+) x[..., j + m/2] (level 0 of the MSM sum
    tree: 10 products instead of 12, 43/85-row reads instead of 63/126)."""
    k = _k(kind)
    if not _on_card("fold_padd_aa", x):
        return fold_padd_aa_ref(x, kind)
    rows, arows = ec_lm.ROWS[kind], 2 * k * lm.N_LIMBS + 1
    x, B, h = _fold_args("fold_padd_aa", x, arows)
    out = torch.empty((B, rows, h), dtype=torch.int32, device=x.device)
    if out.numel():
        consts = lm.const(_EC_CONSTS, x.device)
        rc = _lib().zk_fold_padd_aa(k, x.data_ptr(), out.data_ptr(),
                                    consts.data_ptr(), B, h,
                                    _stream(x.device))
        _check(rc, "fold_padd_aa")
        LAUNCHES["fold_padd_aa"] += 1
    return out


"""ctypes bindings for the native host library (native/libzkhost.so).

Accelerates the host-side runtime: trusted-setup fixed-base key generation
and MSM oracles run in C++ (4x64-limb Montgomery, Jacobian curve ops,
batch-inverse affine conversion) — the pieces the reference did in Go
(go-rapidsnark) and JS/wasm (snarkjs).  Falls back to the pure-Python
ops/ec.py implementations when the library is not built; build with
`make -C native`.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ..ops import ec

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / \
    "build" / "libzkhost.so"
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_LIB_PATH.parent.parent)],
                           check=True, capture_output=True, timeout=300)
        except Exception:
            return None
    if _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        for name in ("zk_g1_fixed_base_mul", "zk_g2_fixed_base_mul"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_void_p]
        for name in ("zk_g1_msm", "zk_g2_msm"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_void_p]
        for name in ("zk_g1_scale_batch", "zk_g2_scale_batch"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_void_p]
        for name in ("zk_g1_add_batch", "zk_g2_add_batch"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_void_p]
        for name in ("zk_g1_segsum", "zk_g2_segsum"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _scalars_to_u64(scalars) -> np.ndarray:
    arr = np.zeros((len(scalars), 4), dtype=np.uint64)
    for i, s in enumerate(scalars):
        s = int(s)
        for j in range(4):
            arr[i, j] = (s >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return arr


def _u64_to_int(row) -> int:
    return sum(int(row[j]) << (64 * j) for j in range(len(row)))


def _g1_to_u64(pt) -> np.ndarray:
    out = np.zeros(8, dtype=np.uint64)
    if pt is not None:
        out[:4] = _scalars_to_u64([pt[0]])[0]
        out[4:] = _scalars_to_u64([pt[1]])[0]
    return out


def _g1_from_u64(row):
    x = _u64_to_int(row[:4])
    y = _u64_to_int(row[4:8])
    return None if (x == 0 and y == 0) else (x, y)


def _g2_to_u64(pt) -> np.ndarray:
    out = np.zeros(16, dtype=np.uint64)
    if pt is not None:
        (x0, x1), (y0, y1) = pt
        for k, v in enumerate((x0, x1, y0, y1)):
            out[4 * k:4 * k + 4] = _scalars_to_u64([v])[0]
    return out


def _g2_from_u64(row):
    vals = [_u64_to_int(row[4 * k:4 * k + 4]) for k in range(4)]
    if all(v == 0 for v in vals):
        return None
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def g1_fixed_base_mul(scalars: list, base=ec.G1_GEN) -> list:
    """[s * base for s in scalars] — C++ fast path or Python fallback."""
    lib = _load()
    if lib is None:
        fb = None
        out = []
        for s in scalars:
            out.append(ec.G1.mul(int(s), base))
        return out
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    bs = np.ascontiguousarray(_g1_to_u64(base))
    res = np.zeros((len(scalars), 8), dtype=np.uint64)
    lib.zk_g1_fixed_base_mul(sc.ctypes.data, len(scalars), bs.ctypes.data,
                             res.ctypes.data)
    return [_g1_from_u64(r) for r in res]


def g2_fixed_base_mul(scalars: list, base=ec.G2_GEN) -> list:
    lib = _load()
    if lib is None:
        return [ec.G2.mul(int(s), base) for s in scalars]
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    bs = np.ascontiguousarray(_g2_to_u64(base))
    res = np.zeros((len(scalars), 16), dtype=np.uint64)
    lib.zk_g2_fixed_base_mul(sc.ctypes.data, len(scalars), bs.ctypes.data,
                             res.ctypes.data)
    return [_g2_from_u64(r) for r in res]


def g1_msm(scalars: list, points: list):
    lib = _load()
    if lib is None:
        return ec.msm_host(scalars, points)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = np.ascontiguousarray(
        np.stack([_g1_to_u64(p) for p in points]))
    res = np.zeros(8, dtype=np.uint64)
    lib.zk_g1_msm(sc.ctypes.data, pts.ctypes.data, len(scalars),
                  res.ctypes.data)
    return _g1_from_u64(res)


def g2_msm(scalars: list, points: list):
    lib = _load()
    if lib is None:
        return ec.msm_host(scalars, points, ec.G2)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = np.ascontiguousarray(
        np.stack([_g2_to_u64(p) for p in points]))
    res = np.zeros(16, dtype=np.uint64)
    lib.zk_g2_msm(sc.ctypes.data, pts.ctypes.data, len(scalars),
                  res.ctypes.data)
    return _g2_from_u64(res)


# ---------------------------------------------------------------------------
# ceremony-derivation primitives (ptau -> pk; see groth16/ceremony.py)
# ---------------------------------------------------------------------------

def _pack_pts(points, to_u64):
    return np.ascontiguousarray(np.stack([to_u64(p) for p in points]))


def g1_scale_batch(scalars: list, points: list) -> list:
    """[s_i * P_i] pairwise."""
    lib = _load()
    if lib is None:
        return [ec.G1.mul(int(s), p) for s, p in zip(scalars, points)]
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _pack_pts(points, _g1_to_u64)
    res = np.zeros((len(points), 8), dtype=np.uint64)
    lib.zk_g1_scale_batch(sc.ctypes.data, pts.ctypes.data, len(points),
                          res.ctypes.data)
    return [_g1_from_u64(r) for r in res]


def g2_scale_batch(scalars: list, points: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G2.mul(int(s), p) for s, p in zip(scalars, points)]
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _pack_pts(points, _g2_to_u64)
    res = np.zeros((len(points), 16), dtype=np.uint64)
    lib.zk_g2_scale_batch(sc.ctypes.data, pts.ctypes.data, len(points),
                          res.ctypes.data)
    return [_g2_from_u64(r) for r in res]


def g1_add_batch(a: list, b: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G1.add(x, y) for x, y in zip(a, b)]
    pa = _pack_pts(a, _g1_to_u64)
    pb = _pack_pts(b, _g1_to_u64)
    res = np.zeros((len(a), 8), dtype=np.uint64)
    lib.zk_g1_add_batch(pa.ctypes.data, pb.ctypes.data, len(a),
                        res.ctypes.data)
    return [_g1_from_u64(r) for r in res]


def g2_add_batch(a: list, b: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G2.add(x, y) for x, y in zip(a, b)]
    pa = _pack_pts(a, _g2_to_u64)
    pb = _pack_pts(b, _g2_to_u64)
    res = np.zeros((len(a), 16), dtype=np.uint64)
    lib.zk_g2_add_batch(pa.ctypes.data, pb.ctypes.data, len(a),
                        res.ctypes.data)
    return [_g2_from_u64(r) for r in res]


def g1_segsum(points: list, ids: list, m: int) -> list:
    """out[ids[i]] += P_i; returns m points."""
    assert not ids or max(ids) < m, "segment id out of range"
    lib = _load()
    if lib is None:
        out = [None] * m
        for p, i in zip(points, ids):
            out[i] = ec.G1.add(out[i], p)
        return out
    pts = _pack_pts(points, _g1_to_u64)
    idt = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
    res = np.zeros((m, 8), dtype=np.uint64)
    lib.zk_g1_segsum(pts.ctypes.data, idt.ctypes.data, len(points), m,
                     res.ctypes.data)
    return [_g1_from_u64(r) for r in res]


def g2_segsum(points: list, ids: list, m: int) -> list:
    assert not ids or max(ids) < m, "segment id out of range"
    lib = _load()
    if lib is None:
        out = [None] * m
        for p, i in zip(points, ids):
            out[i] = ec.G2.add(out[i], p)
        return out
    pts = _pack_pts(points, _g2_to_u64)
    idt = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
    res = np.zeros((m, 16), dtype=np.uint64)
    lib.zk_g2_segsum(pts.ctypes.data, idt.ctypes.data, len(points), m,
                     res.ctypes.data)
    return [_g2_from_u64(r) for r in res]

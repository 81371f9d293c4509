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
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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


class Laps:
    """lap(key) adds the seconds since the previous lap (or since the
    Laps was made) to seconds[key]; with seconds None it does nothing."""

    def __init__(self, seconds: dict | None):
        self.seconds = seconds
        self.t = time.perf_counter()

    def __call__(self, key: str) -> None:
        if self.seconds is None:
            return
        now = time.perf_counter()
        self.seconds[key] = self.seconds.get(key, 0.0) + now - self.t
        self.t = now


_MASK256 = (1 << 256) - 1


def _scalars_to_u64(scalars) -> np.ndarray:
    """ints -> (n, 4) uint64 little-endian limbs of each int's low 256
    bits: one to_bytes an int over the whole batch."""
    data = b"".join((int(s) & _MASK256).to_bytes(32, "little")
                    for s in scalars)
    return np.frombuffer(data, "<u8").reshape(len(scalars), 4) \
        .astype(np.uint64)


def _u64_to_ints(arr) -> list:
    """(..., 4k) uint64 limbs -> the ints of each run of four limbs, in
    order: one from_bytes an int."""
    buf = np.ascontiguousarray(arr, "<u8").tobytes()
    return [int.from_bytes(buf[i:i + 32], "little")
            for i in range(0, len(buf), 32)]


def _g1_pack(points) -> np.ndarray:
    """[(x, y) | None] -> (n, 8) uint64 rows (None: all zero)."""
    coords = []
    for pt in points:
        coords.extend((0, 0) if pt is None else pt)
    return _scalars_to_u64(coords).reshape(len(points), 8)


def _g2_pack(points) -> np.ndarray:
    """[((x0, x1), (y0, y1)) | None] -> (n, 16) uint64 rows."""
    coords = []
    for pt in points:
        coords.extend((0, 0, 0, 0) if pt is None else
                      (pt[0][0], pt[0][1], pt[1][0], pt[1][1]))
    return _scalars_to_u64(coords).reshape(len(points), 16)


def _g1_unpack(res) -> list:
    """(n, 8) uint64 rows -> [(x, y) | None] (an all-zero row is None)."""
    v = _u64_to_ints(res)
    return [None if x == 0 and y == 0 else (x, y)
            for x, y in zip(v[0::2], v[1::2])]


def _g2_unpack(res) -> list:
    v = _u64_to_ints(res)
    return [None if not (x0 or x1 or y0 or y1) else ((x0, x1), (y0, y1))
            for x0, x1, y0, y1 in zip(v[0::4], v[1::4], v[2::4], v[3::4])]


def _g1_to_u64(pt) -> np.ndarray:
    return _g1_pack([pt])[0]


def _g1_from_u64(row):
    return _g1_unpack(row[:8])[0]


def _g2_to_u64(pt) -> np.ndarray:
    return _g2_pack([pt])[0]


def _g2_from_u64(row):
    return _g2_unpack(row[:16])[0]


def _fixed_base(fn, sc: np.ndarray, bs: np.ndarray, width: int) -> np.ndarray:
    """fn (zk_g1/g2_fixed_base_mul) over the (n, 4) scalars in slices, one
    thread a slice: the library call releases the interpreter lock and
    shares nothing between calls, and each point's affine result is exact,
    so the rows equal one call's.  -> (n, width) uint64 rows."""
    n = sc.shape[0]
    res = np.zeros((n, width), dtype=np.uint64)
    k = max(1, min(len(os.sched_getaffinity(0)), n // 4096))
    cut = [n * j // k for j in range(k + 1)]

    def part(j):
        fn(sc.ctypes.data + 32 * cut[j], cut[j + 1] - cut[j], bs.ctypes.data,
           res.ctypes.data + 8 * width * cut[j])

    with ThreadPoolExecutor(k) as pool:
        list(pool.map(part, range(k)))
    return res


def g1_fixed_base_mul(scalars: list, base=ec.G1_GEN,
                      lap: "Laps | None" = None) -> list:
    """[s * base for s in scalars] — C++ fast path or Python fallback.
    lap: a Laps that takes the seconds of the products ("g1_products")
    and of the conversions to and from the library's limbs
    ("conversions")."""
    lib = _load()
    if lib is None:
        return [ec.G1.mul(int(s), base) for s in scalars]
    lap = lap or Laps(None)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    bs = np.ascontiguousarray(_g1_to_u64(base))
    lap("conversions")
    res = _fixed_base(lib.zk_g1_fixed_base_mul, sc, bs, 8)
    lap("g1_products")
    out = _g1_unpack(res)
    lap("conversions")
    return out


def g2_fixed_base_mul(scalars: list, base=ec.G2_GEN,
                      lap: "Laps | None" = None) -> list:
    """g1_fixed_base_mul over G2 ("g2_products")."""
    lib = _load()
    if lib is None:
        return [ec.G2.mul(int(s), base) for s in scalars]
    lap = lap or Laps(None)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    bs = np.ascontiguousarray(_g2_to_u64(base))
    lap("conversions")
    res = _fixed_base(lib.zk_g2_fixed_base_mul, sc, bs, 16)
    lap("g2_products")
    out = _g2_unpack(res)
    lap("conversions")
    return out


def g1_msm(scalars: list, points: list):
    lib = _load()
    if lib is None:
        return ec.msm_host(scalars, points)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _g1_pack(points)
    res = np.zeros(8, dtype=np.uint64)
    lib.zk_g1_msm(sc.ctypes.data, pts.ctypes.data, len(scalars),
                  res.ctypes.data)
    return _g1_from_u64(res)


def g2_msm(scalars: list, points: list):
    lib = _load()
    if lib is None:
        return ec.msm_host(scalars, points, ec.G2)
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _g2_pack(points)
    res = np.zeros(16, dtype=np.uint64)
    lib.zk_g2_msm(sc.ctypes.data, pts.ctypes.data, len(scalars),
                  res.ctypes.data)
    return _g2_from_u64(res)


# ---------------------------------------------------------------------------
# ceremony-derivation primitives (ptau -> pk; see groth16/ceremony.py)
# ---------------------------------------------------------------------------

def g1_scale_batch(scalars: list, points: list) -> list:
    """[s_i * P_i] pairwise."""
    lib = _load()
    if lib is None:
        return [ec.G1.mul(int(s), p) for s, p in zip(scalars, points)]
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _g1_pack(points)
    res = np.zeros((len(points), 8), dtype=np.uint64)
    lib.zk_g1_scale_batch(sc.ctypes.data, pts.ctypes.data, len(points),
                          res.ctypes.data)
    return _g1_unpack(res)


def g2_scale_batch(scalars: list, points: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G2.mul(int(s), p) for s, p in zip(scalars, points)]
    sc = np.ascontiguousarray(_scalars_to_u64(scalars))
    pts = _g2_pack(points)
    res = np.zeros((len(points), 16), dtype=np.uint64)
    lib.zk_g2_scale_batch(sc.ctypes.data, pts.ctypes.data, len(points),
                          res.ctypes.data)
    return _g2_unpack(res)


def g1_add_batch(a: list, b: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G1.add(x, y) for x, y in zip(a, b)]
    pa = _g1_pack(a)
    pb = _g1_pack(b)
    res = np.zeros((len(a), 8), dtype=np.uint64)
    lib.zk_g1_add_batch(pa.ctypes.data, pb.ctypes.data, len(a),
                        res.ctypes.data)
    return _g1_unpack(res)


def g2_add_batch(a: list, b: list) -> list:
    lib = _load()
    if lib is None:
        return [ec.G2.add(x, y) for x, y in zip(a, b)]
    pa = _g2_pack(a)
    pb = _g2_pack(b)
    res = np.zeros((len(a), 16), dtype=np.uint64)
    lib.zk_g2_add_batch(pa.ctypes.data, pb.ctypes.data, len(a),
                        res.ctypes.data)
    return _g2_unpack(res)


def g1_segsum(points: list, ids: list, m: int) -> list:
    """out[ids[i]] += P_i; returns m points."""
    assert not ids or max(ids) < m, "segment id out of range"
    lib = _load()
    if lib is None:
        out = [None] * m
        for p, i in zip(points, ids):
            out[i] = ec.G1.add(out[i], p)
        return out
    pts = _g1_pack(points)
    idt = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
    res = np.zeros((m, 8), dtype=np.uint64)
    lib.zk_g1_segsum(pts.ctypes.data, idt.ctypes.data, len(points), m,
                     res.ctypes.data)
    return _g1_unpack(res)


def g2_segsum(points: list, ids: list, m: int) -> list:
    assert not ids or max(ids) < m, "segment id out of range"
    lib = _load()
    if lib is None:
        out = [None] * m
        for p, i in zip(points, ids):
            out[i] = ec.G2.add(out[i], p)
        return out
    pts = _g2_pack(points)
    idt = np.ascontiguousarray(np.asarray(ids, dtype=np.uint32))
    res = np.zeros((m, 16), dtype=np.uint64)
    lib.zk_g2_segsum(pts.ctypes.data, idt.ctypes.data, len(points), m,
                     res.ctypes.data)
    return _g2_unpack(res)

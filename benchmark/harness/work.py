"""The yardstick of the kernels: the card's peaks and the work each launch
needs, from the shapes the program's counters record.

A launch's bound is the larger of its bytes at the memory rate and its
32-bit multiply-adds at the integer ceiling: 64 a clock per SM (CUDA C
Programming Guide, compute capability 9.0) at the card's highest SM clock,
read on the card.  Work is what the call's shapes need, whatever computes
it, at the least known cost: every 21-limb Montgomery product at one
level of Karatsuba (915 multiply-adds), an EC add as its products and
lazy reductions, each input byte read once and each output written once,
and an operand that may be broadcast (a column, one point) counted at its
smallest.  The multiply-add counts are frozen copies of the program's
tools/__init__.py at the time the benchmark was defined.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA's data sheet
INT_MADS_PER_CLK_SM = 64
LIMBS = 21

COLS_KARATSUBA, MAD_LOW = 342, 231
MAD_MONT = 2 * COLS_KARATSUBA + MAD_LOW                  # 915
_ADD_TERMS = {("padd", "g1"): (8, 3, 0), ("padd", "g2"): (0, 16, 6),
              ("padd_aa", "g1"): (4, 3, 0), ("padd_aa", "g2"): (0, 8, 6)}
ROWS = {"g1": 3 * LIMBS, "g2": 6 * LIMBS}                # projective
AFFINE_ROWS = {"g1": 2 * LIMBS + 1, "g2": 4 * LIMBS + 1}
N_ROUNDS_F = 8
N_ROUNDS_P = {3: 57, 4: 56, 5: 60}


def add_mads(form: str, kind: str) -> int:
    """Multiply-adds of one EC add ("padd" projective, "padd_aa" of two
    affine points) in G1 or G2: G1 11,091 / 7,431, G2 31,758 / 21,702."""
    prods, lazy2, lazy4 = _ADD_TERMS[(form, kind)]
    red = MAD_LOW + COLS_KARATSUBA
    return prods * (COLS_KARATSUBA + red) + \
        lazy2 * (2 * COLS_KARATSUBA + red) + lazy4 * (4 * COLS_KARATSUBA + red)


def poseidon_products(t: int) -> int:
    """Products of one permutation of width t with the sparse partial
    rounds of the optimised Poseidon (the least known): a full round t
    S-boxes of 3 products and a t x t mix, a partial round one S-box and
    2t - 1 products."""
    return N_ROUNDS_F * (3 * t + t * t) + N_ROUNDS_P[t] * (3 + 2 * t - 1)


def _elems(pattern: str, rows: int, lanes: int) -> int:
    """Elements of a mont_mul operand read the way MONT_SHAPES names it."""
    return {"const": 1, "col": rows, "table": lanes}.get(pattern,
                                                         rows * lanes)


def launch_work(family: str, key: str) -> tuple:
    """(bytes, multiply-adds) of one launch whose counter key is `key`
    (the program's MONT_SHAPES, PADD_SHAPES, FOLD_SHAPES and SCALAR_SHAPES
    keys; for the NTT level "n{n}/T{T}", for Poseidon "t{t}/T{T}")."""
    num = {k: int(v) for k, v in re.findall(r"([A-Za-z]+)(\d+)", key)}
    if family == "mont_mul":
        pa, pb = key.split("/")[0].split("*")
        rows, lanes = num["R"], num["T"]
        return (4 * LIMBS * (rows * lanes + _elems(pa, rows, lanes)
                             + _elems(pb, rows, lanes)),
                MAD_MONT * rows * lanes)
    if family == "ntt_level":
        n, lanes = num["n"], num["T"]
        return 4 * LIMBS * (2 * n * lanes + n // 2), MAD_MONT * n // 2 * lanes
    if family == "poseidon":
        t, lanes = num["t"], num["T"]
        return 4 * LIMBS * lanes * t, MAD_MONT * poseidon_products(t) * lanes
    kind = "g1" if "g1" in key.split("/")[:2] else "g2"
    if family.startswith("padd"):
        adds = num["B"] * num["T"]
        return 4 * ROWS[kind] * 2 * adds, add_mads("padd", kind) * adds
    if family.startswith("fold_padd_aa"):
        adds = num["B"] * num["h"]
        return (4 * num["B"] * (AFFINE_ROWS[kind] * 2 * num["h"]
                                + ROWS[kind] * num["h"]),
                add_mads("padd_aa", kind) * adds)
    if family.startswith("fold_padd"):
        widths = [num["h"] >> i for i in range(num["n"])]
        adds = num["B"] * sum(widths)
        return (4 * ROWS[kind] * num["B"] * (2 * num["h"] + sum(widths)),
                add_mads("padd", kind) * adds)
    if family.startswith("scalar_mul"):
        lanes, bits = num["T"], num["b"]
        # a double and, for half the bits of a random scalar, an add
        return (4 * ROWS[kind] * 2 * lanes,
                add_mads("padd", kind) * lanes * (bits + bits // 2))
    raise KeyError(family)


def bound_s(nbytes: float, mads: float, sms: int, sm_mhz: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               mads / (INT_MADS_PER_CLK_SM * sms * sm_mhz * 1e6))


# the program's kernels by the names the profiler gives them, and the
# counter family of each (G1 and G2 apart)
KERNELS = [
    (re.compile(r"\bmont_mul_kernel\b"), "mont_mul"),
    (re.compile(r"\bntt_level_kernel\b"), "ntt_level"),
    (re.compile(r"\bposeidon_kernel\b"), "poseidon"),
    (re.compile(r"\badd_kernel<PaddAaG1\b"), "fold_padd_aa/g1"),
    (re.compile(r"\badd_kernel<PaddAaG2\b"), "fold_padd_aa/g2"),
    (re.compile(r"\badd_kernel<PaddG1\b"), "padd/g1"),
    (re.compile(r"\badd_kernel<PaddG2\b"), "padd/g2"),
    (re.compile(r"\bfold_levels_kernel<PaddG1\b"), "fold_padd/g1"),
    (re.compile(r"\bfold_levels_kernel<PaddG2\b"), "fold_padd/g2"),
    (re.compile(r"\bladder_kernel<PaddG1\b"), "scalar_mul/g1"),
    (re.compile(r"\bladder_kernel<PaddG2\b"), "scalar_mul/g2"),
]


def family(kernel_name: str) -> str | None:
    for pattern, fam in KERNELS:
        if pattern.search(kernel_name):
            return fam
    return None


def counted_launches(snapshot_diff: dict, lanes: int, domain: int) -> dict:
    """{family: {key: launches}} from the difference of two readings of
    the program's counters (see program.counters): the shape counters as
    they are, the NTT levels and the Poseidon permutations (counted by
    launches alone) at the slice's `lanes` on the configuration's
    `domain`."""
    out: dict = {}
    for key, c in snapshot_diff["mont"].items():
        out.setdefault("mont_mul", {})[key] = c
    for key, c in snapshot_diff["padd"].items():
        out.setdefault(f"padd/{key.split('/')[0]}", {})[key] = c
    for key, c in snapshot_diff["fold"].items():
        name, kind = key.split("/")[:2]
        out.setdefault(f"{name}/{kind}", {})[key] = c
    for key, c in snapshot_diff["scalar"].items():
        out.setdefault(f"scalar_mul/{key.split('/')[0]}", {})[key] = c
    launches = snapshot_diff["launches"]
    if launches.get("ntt_level"):
        out["ntt_level"] = {f"n{domain}/T{lanes}": launches["ntt_level"]}
    for t in (3, 4, 5):
        if launches.get(f"poseidon/t{t}"):
            out.setdefault("poseidon", {})[f"t{t}/T{lanes}"] = \
                launches[f"poseidon/t{t}"]
    return out

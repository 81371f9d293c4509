"""The main path and the serving path of two trees of this repository on
one card, in turns: parent, change, change, parent.

    python -m zkfranchise_tpu_torch.tools.tree_compare PARENT [CHANGE]

PARENT and CHANGE are checkouts (CHANGE defaults to the one this module
lies in); a parent commit is unpacked with ``git archive <commit> | tar -x
-C <dir>`` into a directory that ``.gitignore`` lists.  Each run is a fresh
Python process that imports that tree's own ``chip_smoke.py`` and runs its
phases ``toolchain`` (the tree's own build), ``main_path`` (with
``timed_prove``, ``verify`` and ``profile``) and ``stream``, after timing
the tree's ``scalar_mul`` at (rows, 128) with a 254-bit scalar shared by
the lanes and, where the tree takes one, a scalar per lane (whole calls,
CUDA events), reading the device time of its ``mont_mul``, one NTT
butterfly level, ``inv`` and ``batch_inv`` at the main path's shapes, of
the layout experiments' ``fold2d`` (G1, G2) and ``mm2d`` (chains 1 and 8)
at the layout tool's, and of its ``mont_chain`` at the tool's (21,
131072) x 20 and as the yardsticks of ``inv`` (364 products, 128 lanes)
and of the Poseidon permutation (t = 3, 4, 5) (``tools.device_reading``),
and running its phase ``affine_tree``.  Phase ``profile`` is
this tree's in both runs, so that both count the host's ops the same
way.  Every line a run prints comes out as
one JSON object tagged with the run ("parent", "change", "change2",
"parent2"); the last line sums up each run's stage seconds, proofs/s,
device busy time and idle share, host ops, launches per ``prove_arrays``,
the kernel readings,
mont_mul's launches by shape where the tree counts them, peak device
memory, the stream's slices, the scalar_mul times and the affine tree's
seconds and peak memory.  The card's name and
power limit come first.  Exits non-zero if a run fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[2]


def worker(tree: str) -> None:
    """One run, in its own process: the tree's phases, with this tree's
    phase_profile."""
    import importlib.util

    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    cs.phase_profile = here.phase_profile
    from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
    from zkfranchise_tpu_torch.tools import event_ms
    from zkfranchise_tpu_torch.tools.padd_shapes import padd_inputs

    dev = torch.device("cuda", 0)
    cs.phase_toolchain(torch, K)
    rng = np.random.default_rng(9)
    for kind in ("g1", "g2"):
        p, q = padd_inputs(kind, 1, 128, rng, dev)
        pts = K.padd_ref(p[0], q[0], kind)
        scalars = {"shared": rng.integers(0, 2, size=254),
                   "per_lane": rng.integers(0, 2, size=(254, 128))}
        for name, bits in scalars.items():
            bits = torch.as_tensor(bits.astype(np.int32), device=dev)
            try:
                got = K.scalar_mul(pts, bits, kind)
            except ValueError:              # a tree without per-lane bits
                continue
            cs.emit({"scalar_mul": kind, "bits": name,
                     "equal": bool(torch.equal(
                         got, K.scalar_mul_ref(pts, bits, kind))),
                     "ms": event_ms(lambda: K.scalar_mul(pts, bits, kind),
                                    runs=5)})
    _slice_readings(np, torch, K, dev)
    cs.phase_affine_tree(np, torch, K, dev)
    _, keys = cs.phase_main_path(np, torch, K, dev)
    cs.phase_stream(torch, K, dev, *keys)


def _slice_readings(np, torch, K, dev) -> None:
    """mont_mul at (8192, 21, 128) x (8192, 21, 1) Fr, one NTT butterfly
    level at (16384, 21, T) Fr for T = 128 and 4 (the tree's ntt_level,
    or the loop body of its _transform where it has none), inv at (21,
    128) Fq, batch_inv at (128, 21, 16384) Fq, fold2d at (rows, 2^20), m
    8192, G1 and G2, mm2d at (21, 2^20) Fq, chains 1 and 8, both at tile
    512, and mont_chain at (21, 131072) x 20 Fq, (21, 128) x 364 Fq and
    (21, 128) x Poseidon's depth Fr (t = 3, 4, 5), as the tree runs them:
    device ms through tools.device_reading (one JSON line each), against
    the multiply-adds of the least work known (Karatsuba products, those
    of batch_inv's Fermat chain too).  fold2d's adds are formulas
    without branches, so random limbs time them as points would."""
    from zkfranchise_tpu_torch.ops import lm, ntt
    from zkfranchise_tpu_torch.ops.poseidon_constants import N_ROUNDS_F, \
        N_ROUNDS_P
    from zkfranchise_tpu_torch.tools import MAD_MONT_KARATSUBA, add_mads, \
        device_reading

    rng = np.random.default_rng(10)

    def limbs(shape):
        x = rng.integers(0, 1 << 13, size=shape, dtype=np.int32)
        x[..., 19, :] &= 0x7F
        x[..., 20, :] = 0
        return torch.as_tensor(x, device=dev)

    def body(x, g, tw):
        h = x.shape[0] // 2
        paired = x[g]
        lo = paired[:h]
        hi = lm.mont_mul(paired[h:], tw, lm.FR)
        return torch.cat([lm.weak_norm(lo + hi), lm.sub_n(lo, hi, lm.FR)], 0)

    a, b = limbs((8192, 21, 128)), limbs((8192, 21, 1))
    device_reading("mont_mul/fr/8192x21x128*8192x21x1",
                   lambda: K.mont_mul(a, b, lm.FR),
                   4 * (2 * a.numel() + b.numel()), 0)
    level = getattr(ntt, "ntt_level", body)
    gs, tws, _ = ntt.plan(14).on(str(dev))["fwd"]
    for T in (128, 4):
        x = lm.to_mont(limbs((16384, 21, T)))
        device_reading(f"ntt level/fr/16384x21x{T}",
                       lambda: level(x, gs[5], tws[5]), 8 * x.numel(), 0)
    c = limbs((21, 128))
    device_reading("inv/fq/21x128", lambda: K.inv(c, lm.FQ), 8 * c.numel(),
                   0)
    d = limbs((128, 21, 16384))
    d[:, 0] |= 1                                            # no zero lane
    # tools.batch_inv_work's count, written out: a parent tree's tools
    # may not have it
    device_reading("batch_inv/fq/128x21x16384",
                   lambda: K.batch_inv(d, lm.FQ), 8 * d.numel(),
                   128 * MAD_MONT_KARATSUBA * (3 * 16383 + 363))
    del d
    T = 1 << 20
    for kind, rows in (("g1", 63), ("g2", 126)):
        x = limbs((rows // 21, 21, T)).reshape(rows, T)
        device_reading(f"fold2d/{kind}/{rows}x{T}/m8192/tile512",
                       lambda: K.fold2d(x, 512, kind, 8192),
                       6 * x.numel(), add_mads("padd", kind) * T // 2)
        del x
    a, b = limbs((21, T)), limbs((21, T))
    for chain in (1, 8):
        device_reading(f"mm2d/fq/21x{T}/chain{chain}/tile512",
                       lambda: K.mm2d(a, b, 512, chain), 12 * a.numel(),
                       MAD_MONT_KARATSUBA * chain * T)
    chains = [("fq", 131072, 20, ""), ("fq", 128, 364, " (inv's yardstick)")]
    chains += [("fr", 128, (N_ROUNDS_F + N_ROUNDS_P[t - 2]) * (3 + t),
                f" (poseidon t{t}'s yardstick)") for t in (3, 4, 5)]
    for field, T, iters, what in chains:
        fs = lm.FQ if field == "fq" else lm.FR
        a, b = limbs((21, T)), limbs((21, T))
        device_reading(f"mont_chain/{field}/21x{T}x{iters}{what}",
                       lambda: K.mont_chain(a, b, iters, fs), 12 * a.numel(),
                       MAD_MONT_KARATSUBA * iters * T)


def summary(lines: list) -> dict:
    """What a run's JSON lines say about its step, stream and scalar_mul."""
    out = {"scalar_mul": {}}
    for d in lines:
        phase = d.get("phase")
        if phase == "timed_prove":
            out.update(stage_seconds=d["stage_seconds"], step_s=d["total_s"],
                       proofs_per_s=d["proofs_per_s"],
                       launches_per_prove_arrays={
                           k: v for k, v in
                           d["launches_per_prove_arrays"].items() if v})
            # what a tree prints beside them (an older tree less)
            out.update({k: d[k] for k in ("peak_memory_bytes",
                                          "mont_launches_by_shape")
                        if k in d})
        elif phase == "profile":
            out.update({k: d[k] for k in (
                "device_busy_s", "device_idle_share", "host_prove_arrays",
                "host_witness")})
        elif phase == "verify":
            out["verified"] = all(d["accepted"].values()) and not \
                d["cross_voter_accepted"] and not d["tampered_accepted"]
        elif phase == "stream":
            out.update(stream_proofs_per_s=d["proofs_per_s"],
                       stream_slices_s=[r["seconds"] for r in d["rates"]])
        elif "reading" in d:
            out.setdefault("readings", {})[d["reading"]] = {
                "device_ms": d["device_ms"], "invalid": d["invalid"]}
        elif "scalar_mul" in d:
            out["scalar_mul"][f"{d['scalar_mul']}/{d['bits']}"] = {
                "ms": d["ms"], "equal": d["equal"]}
        elif phase == "affine_tree" and "peak_memory_bytes" in d:
            out["affine_tree"] = {
                kind: {"affine_s": d[kind]["affine_tree_s"],
                       "projective_s": d[kind]["projective_tree_s"]}
                for kind in ("g1", "g2")}
            out["affine_tree"]["peak_memory_bytes"] = d["peak_memory_bytes"]
    return out


def main(parent: str, change: str = str(ROOT)) -> int:
    from ..utils import devices

    devices.resolve(None)                   # raises without a card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = [("parent", parent), ("change", change), ("change2", change),
            ("parent2", parent)]
    results, failed = {}, []
    for tag, tree in runs:
        proc = subprocess.run([sys.executable, str(HERE), "--worker", tree],
                              capture_output=True, text=True)
        lines = []
        for line in proc.stdout.splitlines():
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                d = {"text": line}
            if isinstance(d, dict):
                lines.append(d)
                print(json.dumps({"run": tag, **d}), flush=True)
        if proc.returncode != 0:
            failed.append(tag)
            print(json.dumps({"run": tag, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
        results[tag] = {"tree": tree, **summary(lines)}
    print(json.dumps({"tree_compare": results, "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        if not 2 <= len(sys.argv) <= 3:
            sys.exit(__doc__)
        sys.exit(main(*sys.argv[1:]))

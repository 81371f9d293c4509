"""scalar_mul's ladder with its two teams side by side against one team
that runs the add and then the doubling of each bit.

The kernel (``csrc/lm_kernels.cu`` ``ladder_kernel``) gives a block two
teams of warps: one adds acc + base, the other doubles base, at the same
time.  This tool writes a copy of that source in which one team runs
both, one after the other (``one_team_source``), builds it into a library
of its own in a temporary directory (the port builds only the first),
holds both against the plain version, and times both in turns at the
assembly's shape: (rows, 128) points, a 254-bit scalar per lane, G1 and
G2; one JSON line a timing (whole calls by CUDA events, and a burst of
calls between two events).

    python -m zkfranchise_tpu_torch.tools.ladder_teams
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import lm_kernels as K
from ..utils import devices
from . import burst_ms, check, cli, event_ms, verdict
from .padd_shapes import padd_inputs, smi

# the edits that make the ladder's two teams one
ONE_TEAM = [
    ("__global__ void __launch_bounds__(2 * F::WARPS * 32)\nladder_kernel",
     "__global__ void __launch_bounds__(F::WARPS * 32)\nladder_kernel"),
    ("constexpr int NT = 2 * F::WARPS * 32, R = F::ROWS, S = F::STRIDE;",
     "constexpr int NT = F::WARPS * 32, R = F::ROWS, S = F::STRIDE;"),
    ("F::rounds(KC, team * RB, w);       // ends at a barrier",
     "F::rounds(KC, 0, w);\n    F::rounds(KC, RB, w);"),
    ("kernel<<<blocks, 2 * F::WARPS * 32, smem, s>>>(pts, out, bits, sbi, "
     "sbt,", "kernel<<<blocks, F::WARPS * 32, smem, s>>>(pts, out, bits, "
     "sbi, sbt,")]


def one_team_source() -> str:
    """csrc/lm_kernels.cu with one team a ladder block; raises if the
    source no longer reads as the edits expect."""
    src = (K.PKG / "csrc" / "lm_kernels.cu").read_text()
    for old, new in ONE_TEAM:
        if src.count(old) != 1:
            raise RuntimeError(f"ladder_teams: csrc/lm_kernels.cu no longer "
                               f"holds {old!r} once")
        src = src.replace(old, new)
    return src


def build_one_team(tmp: Path) -> ctypes.CDLL:
    (tmp / "lm_kernels.cu").write_text(one_team_source())
    for header in K.HEADERS:
        shutil.copy(header, tmp)
    lib = tmp / "libladder_one_team.so"
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", str(lib),
                    str(tmp / "lm_kernels.cu")], check=True,
                   capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.zk_scalar_mul.argtypes = [I, P, P, P, L, L, I, L, P]
    cdll.zk_scalar_mul.restype = ctypes.c_int
    return cdll


def one_team(lib: ctypes.CDLL, pts: torch.Tensor, bits: torch.Tensor,
             kind: str) -> torch.Tensor:
    """The one-team ladder with a scalar per lane, (nbits, T) bits."""
    out = torch.empty_like(pts)
    rc = lib.zk_scalar_mul(1 if kind == "g1" else 2, pts.data_ptr(),
                           out.data_ptr(), bits.data_ptr(), bits.stride(0), 1,
                           bits.shape[0], pts.shape[1],
                           torch.cuda.current_stream(pts.device).cuda_stream)
    if rc:
        raise RuntimeError(f"one-team ladder launch failed: cudaError {rc}")
    return out


def main(device=None, small: bool = False) -> int:
    dev = devices.resolve(device)
    failed: list = []
    if dev.type != "cuda":
        one_team_source()
        print("no card: the edited source reads as expected; nothing built")
        return verdict(failed)
    print(smi("name,power.limit"), flush=True)
    rng = np.random.default_rng(31)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_one_team(Path(tmp))
        for kind in ("g1", "g2"):
            p, q = padd_inputs(kind, 1, 128, rng, dev)
            pts = K.padd_ref(p[0], q[0], kind)
            bits = torch.as_tensor(rng.integers(0, 2, size=(254, 128))
                                   .astype(np.int32), device=dev)
            want = K.scalar_mul_ref(pts, bits, kind)
            forms = {"two_teams": lambda: K.scalar_mul(pts, bits, kind),
                     "one_team": lambda: one_team(lib, pts, bits, kind)}
            for name, fn in forms.items():
                check(failed, f"scalar_mul/{kind} {name}",
                      torch.equal(fn(), want))
            for turn in ("two_teams", "one_team", "one_team", "two_teams"):
                fn = forms[turn]
                print(json.dumps({"kind": kind, "form": turn,
                                  "ms": event_ms(fn, runs=10),
                                  "burst_ms": burst_ms(fn)}), flush=True)
    return verdict(failed)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))

"""Circuit compilation: the R1CS, the dev trusted setup and its files.

The counterpart of the JAX package's ``scripts/compile_circuit.py``, with
the same steps: build the zkCensus constraint system, run the
deterministic dev setup (groth16/setup.py, the native host library for
the fixed-base products), and write ``proving_key.pkl``,
``verification_key.json`` (indent 1), ``proving_key.zkey`` (A and B
coefficients only, utils/serialize.write_zkey) and the sha256 manifest
(utils/artifacts.write_manifest).  It writes only under the directory
given with ``--out``, in the repo's layout
``<out>/<name>/<env>/<nlevels>/`` with the manifest in
``<out>/<name>/<env>/``:

    python -m zkfranchise_tpu_torch.tools.compile_circuit --out DIR \\
        [--nlevels 16] [--name zkCensus] [--env dev] [--seed SEED]

The setup runs on the host; no step here needs the card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from ..groth16 import qap
from ..groth16 import setup as gsetup
from ..models.census import CensusCircuit
from ..utils import artifacts, serialize


def zkey_data(cs, pk, vk) -> serialize.ZkeyData:
    """The snarkjs-format zkey of a key in this package's wire layout,
    with the A and B coefficients of every row (binding rows included)."""
    rows = list(cs.constraints) + qap.binding_rows(cs.num_public)
    coeffs = []
    for r, (a, b, _c) in enumerate(rows):
        for idx, cf in a.items():
            coeffs.append((0, r, idx, cf))
        for idx, cf in b.items():
            coeffs.append((1, r, idx, cf))
    return serialize.ZkeyData(
        n_vars=pk.n_vars, n_public=pk.n_public, domain=pk.domain,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        gamma_g2=vk.gamma_2, delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        ic=vk.ic, coeffs=coeffs, a_g1=pk.a_g1, b_g1=pk.b_g1,
        b_g2=pk.b_g2, c_g1=pk.k_g1, h_g1=pk.h_g1)


def compile_circuit(out_root, nlevels: int = 16, name: str = "zkCensus",
                    env: str = "dev",
                    seed: bytes = b"zkfranchise-dev-setup") -> pathlib.Path:
    """Write the key files of CensusCircuit(nlevels) -> their directory."""
    t0 = time.time()
    cs = CensusCircuit(nlevels).cs
    print(f"R1CS built: {cs.num_vars} wires, {cs.num_constraints} "
          f"constraints, domain "
          f"{qap.domain_size(cs.num_constraints, cs.num_public)} "
          f"({time.time() - t0:.1f}s)")
    t0 = time.time()
    pk, vk = gsetup.dev_setup(cs, seed=seed)
    print(f"setup done ({time.time() - t0:.1f}s)")

    out = pathlib.Path(out_root) / name / env / str(nlevels)
    out.mkdir(parents=True, exist_ok=True)
    pk.save(out / "proving_key.pkl")
    with open(out / "verification_key.json", "w") as f:
        json.dump(vk.to_dict(), f, indent=1)
    (out / "proving_key.zkey").write_bytes(
        serialize.write_zkey(zkey_data(cs, pk, vk)))
    artifacts.write_manifest(out.parent)
    print(f"artifacts written to {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory to write into (created if missing)")
    ap.add_argument("--nlevels", type=int, default=16)
    ap.add_argument("--env", default="dev")
    ap.add_argument("--name", default="zkCensus")
    ap.add_argument("--seed", default="zkfranchise-dev-setup")
    args = ap.parse_args(argv)
    compile_circuit(args.out, args.nlevels, args.name, args.env,
                    args.seed.encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())

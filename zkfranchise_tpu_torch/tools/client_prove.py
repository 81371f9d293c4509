"""End-to-end client example: prove a mock batch and verify every proof.

The counterpart of the JAX package's ``examples/client_prove.py`` (the
reference's ``npm run example`` flow): assemble circuit inputs for
``mock_batch(nlevels, batch, seed=11)``, prove them with a DeviceProver,
print the wall-clock, verify every proof, and write the first proof's
``proof.json``, ``signals.json`` and ``inputs_example.json``.

The key comes from ``--key-dir`` (``proving_key.pkl`` and
``verification_key.json``, e.g. a ``tools.compile_circuit`` output
directory); without one a dev setup runs and its key files go into
``--out``.  Every file is written into ``--out`` only:

    python -m zkfranchise_tpu_torch.tools.client_prove --out DIR \\
        [--key-dir DIR] [--nlevels 4] [--batch 2] [--device cpu]

Proves on the card unless ``--device cpu`` is given, and raises without
one.  Exits non-zero if a proof does not verify.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from .. import inputs as inp
from ..groth16 import setup as gsetup
from ..groth16 import verify as gverify
from ..groth16.device import DeviceProver
from ..models.census import CensusCircuit
from ..utils import artifacts, devices


def client_prove(out, nlevels: int = 4, batch: int = 2, key_dir=None,
                 device=None) -> bool:
    """-> True when every proof verifies."""
    dev = devices.resolve(device)
    out = pathlib.Path(out)
    circuit = CensusCircuit(nlevels)
    if key_dir is not None:
        key_dir = pathlib.Path(key_dir)
        pk = gsetup.ProvingKey.load(key_dir / "proving_key.pkl")
        vk = gverify.VerifyingKey(json.loads(
            (key_dir / "verification_key.json").read_text()))
    else:
        print("running dev setup...")
        pk, vk = gsetup.dev_setup(circuit.cs)
        out.mkdir(parents=True, exist_ok=True)
        pk.save(out / "proving_key.pkl")
        with open(out / "verification_key.json", "w") as f:
            json.dump(vk.to_dict(), f, indent=1)

    print(f"building census for {batch} voters...")
    voters = inp.mock_batch(nlevels, batch, seed=11, device=dev)
    arrs = inp.batch_to_arrays(voters, nlevels)
    prover = DeviceProver(circuit, pk, device=dev)
    t0 = time.time()
    proofs, pubs = prover.prove_batch(arrs)
    print(f"proof took {time.time() - t0:.1f}s ({batch} proofs on {dev})")

    ok = True
    for i, (proof, pub) in enumerate(zip(proofs, pubs)):
        good = gverify.verify(vk, proof, pub)
        print(f"proof {i}: verifies={good}")
        ok = ok and good
    artifacts.save_proof_artifacts(out, proofs[0].to_dict(), pubs[0])
    (out / "inputs_example.json").write_text(voters[0].to_json())
    print(f"artifacts written to {out}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory to write into (created if missing)")
    ap.add_argument("--key-dir", default=None,
                    help="directory holding proving_key.pkl and "
                         "verification_key.json (default: a dev setup)")
    ap.add_argument("--nlevels", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    ok = client_prove(args.out, args.nlevels, args.batch, args.key_dir,
                      args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

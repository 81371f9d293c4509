"""Whether what the timed path wrote is right, against the reference.

Once the window has closed and the program is freed, every voter
attempted in the window is read back from the stream's directory:

- ``missing``: voters without both proof.json and signals.json;
- ``signals_wrong``: signals.json differs from the eight public signals
  the reference works out for that voter;
- ``malformed``: a proof that does not parse, or whose A or C is not on
  E(Fq) or whose B is not on the twist;
- ``duplicates``: a proof equal to an earlier voter's (a fresh r and s
  make every proof distinct);
- ``files_wrong``: proof directories beyond those attempted, plus one if
  the stream's cursor is not the number attempted;
- ``rejected``: of a sample, proofs that fail Groth16 verification
  against the configuration's committed verification key and the
  REFERENCE's signals -- the pairing check covers every stage of the
  prover, the witness's Poseidon and SMT arithmetic with it.  The sample
  holds the first and the last voter, SAMPLE voters drawn from the seed,
  and one voter drawn from the seed for each lane of each slice size the
  window proved, so a fault in one lane of one captured step is met.  It
  is verified in one batched check (groth16.verify_batch); where that
  fails, each proof of the sample alone, and the number is those that
  fail, at least 1.

Each is exact: its limit is 0.  A voter counts as failed if it is in any
of them.
"""
from __future__ import annotations

import json
import random
from pathlib import Path

from ..reference import groth16

LIMITS = {"missing": 0, "signals_wrong": 0, "malformed": 0,
          "duplicates": 0, "files_wrong": 0, "rejected": 0}
# proofs drawn from the seed for the pairing, besides the first, the last
# and one a lane of each slice size
SAMPLE = 12


def sample(attempted: int, seed: int, slices: list) -> list:
    """The voters whose proofs are verified.  `slices`: (base, batch) of
    each slice the stream proved, in order."""
    if attempted <= 0:
        return []
    rng = random.Random(f"sample/{seed}")
    chosen = set(rng.sample(range(attempted), min(SAMPLE, attempted)))
    by_lane: dict = {}
    for base, batch in slices:
        for lane in range(min(batch, attempted - base)):
            by_lane.setdefault((batch, lane), []).append(base + lane)
    chosen |= {rng.choice(by_lane[k]) for k in sorted(by_lane)}
    return sorted(chosen | {0, attempted - 1})


def read_back(out_dir: Path, attempted: int) -> dict:
    """{voter: (proof dict or None, signals list or None, done ns)} for
    the voters that have a directory."""
    found = {}
    for i in range(attempted):
        d = out_dir / f"proof_{i:08d}"
        try:
            proof_text = (d / "proof.json").read_text()
            signals_text = (d / "signals.json").read_text()
            done = max((d / "proof.json").stat().st_mtime_ns,
                       (d / "signals.json").stat().st_mtime_ns)
        except OSError:
            continue
        try:
            proof = json.loads(proof_text)
        except ValueError:
            proof = None
        try:
            signals = json.loads(signals_text)
        except ValueError:
            signals = None
        found[i] = (proof, signals, done)
    return found


def compare(out_dir: Path, attempted: int, cursor: int, slices: list,
            pool_signals: list, vk: groth16.VerifyingKey,
            seed: int) -> tuple:
    """-> ({number: value} as LIMITS names them, the set of failed voters,
    {voter: ns at which its files were last written}).  `slices`: (base,
    batch) of each slice the stream proved."""
    found = read_back(out_dir, attempted)
    n = {k: 0 for k in LIMITS}
    failed, seen, parsed = set(), {}, {}
    for i in range(attempted):
        if i not in found:
            n["missing"] += 1
            failed.add(i)
            continue
        proof, signals, _ = found[i]
        if signals != pool_signals[i % len(pool_signals)]:
            n["signals_wrong"] += 1
            failed.add(i)
        try:
            parsed[i] = groth16.parse_proof(proof)
            ok = groth16.well_formed(parsed[i])
        except (TypeError, KeyError, ValueError, ZeroDivisionError):
            ok = False
        if not ok:
            n["malformed"] += 1
            failed.add(i)
            parsed.pop(i, None)
            continue
        key = json.dumps(proof, sort_keys=True)
        if key in seen:
            n["duplicates"] += 1
            failed.add(i)
        seen[key] = i
    extra = [p for p in out_dir.glob("proof_*")
             if not p.name[6:].isdigit() or int(p.name[6:]) >= attempted]
    n["files_wrong"] = len(extra) + (cursor != attempted)
    # missing or malformed proofs are counted above
    checked = [i for i in sample(attempted, seed, slices) if i in parsed]
    items = [(parsed[i], pool_signals[i % len(pool_signals)])
             for i in checked]
    if not groth16.verify_batch(vk, items, random.Random(f"weights/{seed}")):
        bad = [i for i, item in zip(checked, items)
               if not groth16.verify(vk, *item)]
        n["rejected"] = max(1, len(bad))
        failed.update(bad)
    return n, failed, {i: f[2] for i, f in found.items()}

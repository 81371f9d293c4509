"""The voters of a run, made from its seed.

One election, one census tree and one SIK tree shared by a pool of
distinct voters, as an operator proves for the voters of one census.  Each
voter has a random 20-byte address, a 64-byte signature, an 11-byte
password, an available weight and a vote weight up to it.  The circuit
reads the signature only as a field element (census.circom:74-77), so
random bytes stand for an Ethereum signature.  The trees are hashed with
the reference's own Poseidon; every derived value (SIK, nullifier, vote
hash, roots, siblings) is the reference's.  A traffic mix that needs more
voters than the pool cycles it in order: the program caches no proof, so a
voter seen again costs what a new one does.
"""
from __future__ import annotations

import random

from ..reference import census, smt
from ..reference.field import big_to_ff

SIGNAL_KEYS = ("electionId", "nullifier", "voteHash", "sikRoot",
               "censusRoot", "voteWeight")


def pool(nlevels: int, size: int, seed: int) -> tuple:
    """-> (inputs, signals): `size` voters' circuit inputs in the upstream
    inputs_example.json schema (decimal strings, siblings padded to
    nlevels + 1), and each voter's eight public signals as the reference
    works them out (decimal strings, snarkjs signals.json order)."""
    rng = random.Random(f"voters/{seed}")
    e0, e1 = smt.bytes_to_arbo(rng.randbytes(32))
    mask = (1 << nlevels) - 1
    voters, paths = [], set()
    while len(voters) < size:
        address = smt.le_int(rng.randbytes(20))
        signature = big_to_ff(int.from_bytes(rng.randbytes(64), "big"))
        password = big_to_ff(int.from_bytes(rng.randbytes(11), "big"))
        aw = rng.randrange(1, 1 << 32)
        vw = rng.randrange(1, aw + 1)
        # two keys that share their first nlevels path bits do not fit
        # in a tree of nlevels levels: draw this voter again
        if address & mask in paths:
            continue
        paths.add(address & mask)
        voters.append((address, signature, password, aw, vw))
    census_root, census_sibs = smt.build(
        {v[0]: v[3] for v in voters}, nlevels)
    sik_root, sik_sibs = smt.build(
        {a: census.sik(a, p, s) for a, s, p, _, _ in voters}, nlevels)
    pad = nlevels + 1
    inputs, signals = [], []
    for address, signature, password, aw, vw in voters:
        null = census.nullifier(signature, password, e0, e1)
        vh0, vh1 = smt.bytes_to_arbo(aw.to_bytes((aw.bit_length() + 7) // 8,
                                                 "big"))
        inputs.append({
            "electionId": [str(e0), str(e1)], "nullifier": str(null),
            "availableWeight": str(aw), "voteHash": [str(vh0), str(vh1)],
            "sikRoot": str(sik_root), "censusRoot": str(census_root),
            "address": str(address), "password": str(password),
            "signature": str(signature), "voteWeight": str(vw),
            "censusSiblings": _padded(census_sibs[address], pad),
            "sikSiblings": _padded(sik_sibs[address], pad)})
        signals.append([str(x) for x in (e0, e1, null, vh0, vh1, sik_root,
                                         census_root, vw)])
    return inputs, signals


def _padded(siblings: list, length: int) -> list:
    return [str(s) for s in siblings] + ["0"] * (length - len(siblings))

"""The census statement and its eight public signals.

upstream circuit/census.circom: a voter proves that voteWeight <=
availableWeight, that (address -> Poseidon(address, password, signature))
is in the SIK tree under sikRoot, that (address -> availableWeight) is in
the census tree under censusRoot, and that nullifier = Poseidon(signature,
password, electionId[0], electionId[1]).  The public signals, in the
circuit's order: electionId[0], electionId[1], nullifier, voteHash[0],
voteHash[1], sikRoot, censusRoot, voteWeight.
"""
from __future__ import annotations

from . import poseidon, smt
from .field import P_FR

WEIGHT_LIMIT = 1 << 252          # LessEqThan(252) in checkWeight


def sik(address: int, password: int, signature: int) -> int:
    return poseidon.hash_([address, password, signature])


def nullifier(signature: int, password: int, e0: int, e1: int) -> int:
    return poseidon.hash_([signature, password, e0, e1])


def signals(inputs: dict) -> tuple:
    """inputs in the upstream inputs_example.json schema -> (the eight
    public signals as integers, whether the statement holds).  Every
    signal the circuit derives is worked out here from the private inputs,
    never copied: the nullifier, and both roots from the leaf and its
    siblings."""
    e0, e1 = (int(x) for x in inputs["electionId"])
    vh0, vh1 = (int(x) for x in inputs["voteHash"])
    address, password, signature = (int(inputs[k]) for k in
                                    ("address", "password", "signature"))
    aw, vw = int(inputs["availableWeight"]), int(inputs["voteWeight"])
    null = nullifier(signature, password, e0, e1)
    sik_root = smt.root_from_path(
        address, sik(address, password, signature),
        [int(x) for x in inputs["sikSiblings"]])
    census_root = smt.root_from_path(
        address, aw, [int(x) for x in inputs["censusSiblings"]])
    holds = (vw <= aw < WEIGHT_LIMIT and address < P_FR
             and null == int(inputs["nullifier"])
             and sik_root == int(inputs["sikRoot"])
             and census_root == int(inputs["censusRoot"]))
    return [e0, e1, null, vh0, vh1, sik_root, census_root, vw], holds

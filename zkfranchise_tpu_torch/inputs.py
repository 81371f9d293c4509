"""Input-generation pipeline (reference layer L3).

Replaces both reference generators with one implementation:
  * the Go server-side mock generator internal.MockInputs
    (upstream internal/inputs.go:33-98), and
  * the TS client-side GenerateCircuitInputs
    (upstream ts_inputs/src/inputs.ts:38-89).

JSON schema (field names and decimal-string encoding) matches
upstream internal/inputs.go:14-31 /
artifacts/zkCensus/dev/160/inputs_example.json exactly.

Deviations from reference behavior, on purpose:
  * MockInputs' nLevels/nKeys parameters actually take effect here (the
    reference hard-codes a 10-leaf tree and 160 levels regardless —
    internal/inputs.go:44,64, internal/helpers.go:47; SURVEY.md §2a quirks).
  * Secrets are never logged (the reference prints the private key at
    internal/inputs.go:61-62).
Quirks preserved: sibling arrays are n_levels+1 long with a trailing
zero-pad (inputs.go:52,72), password/signature are big-endian byte parses
reduced with BigToFF, the address is a little-endian arbo parse, signatures
are truncated to 64 bytes (ts_inputs/src/inputs.ts:6-13), voteHash =
BytesToArbo(availableWeight bytes big-endian), fixed default electionId.
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass

import numpy as np

from .ops import ff
from .ops.poseidon_constants import poseidon_host
from .utils import arbo, devices, eth, smt, smt_batch

DEFAULT_ELECTION_ID = bytes.fromhex(
    "7faeab7a7d250527d614e952ae8e446825bd1124c6def410844c7c383d1519a6"
)
DEFAULT_PASSWORD = b"password123"


@dataclass
class CircuitInputs:
    """Mirror of the reference circuitInputs JSON struct
    (upstream internal/inputs.go:14-31)."""
    electionId: list[str]
    nullifier: str
    availableWeight: str
    voteHash: list[str]
    sikRoot: str
    censusRoot: str
    address: str
    password: str
    signature: str
    voteWeight: str
    censusSiblings: list[str]
    sikSiblings: list[str]

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent="\t")

    @staticmethod
    def from_json(s: str) -> "CircuitInputs":
        return CircuitInputs(**json.loads(s))


def account_sik(address_int: int, password_ff: int, signature_ff: int) -> int:
    """SIK = Poseidon(address, password, signature)
    (census.circom:74-77, dvote AccountSIK)."""
    return poseidon_host([address_int, password_ff, signature_ff])


def account_sik_nullifier(signature_ff: int, password_ff: int,
                          election_id: bytes) -> int:
    """nullifier = Poseidon(signature, password, eid[0], eid[1])
    (census.circom:105-109, dvote AccountSIKnullifier)."""
    e0, e1 = arbo.bytes_to_arbo(election_id)
    return poseidon_host([signature_ff, password_ff, e0, e1])


def generate_circuit_inputs(
    *,
    address_bytes: bytes,
    password: bytes,
    signature64: bytes,
    available_weight: int,
    vote_weight: int,
    election_id: bytes,
    census_root: int,
    census_siblings: list[int],
    sik_root: int,
    sik_siblings: list[int],
    n_levels: int,
) -> CircuitInputs:
    """Client-side assembly given census/SIK proofs from an API — the
    GenerateCircuitInputs equivalent (ts_inputs/src/inputs.ts:55-89)."""
    L = n_levels + 1
    addr = arbo.bytes_to_bigint(address_bytes)
    pwd = ff.big_to_ff(int.from_bytes(password, "big"))
    sig = ff.big_to_ff(int.from_bytes(signature64[:64], "big"))
    e0, e1 = arbo.bytes_to_arbo(election_id)
    nullifier = poseidon_host([sig, pwd, e0, e1])
    # voteHash = BytesToArbo(availableWeight big-endian bytes)
    aw_bytes = available_weight.to_bytes(
        max(1, (available_weight.bit_length() + 7) // 8), "big")
    vh0, vh1 = arbo.bytes_to_arbo(aw_bytes)

    def pad(sibs: list[int]) -> list[str]:
        assert len(sibs) <= L
        return [str(s) for s in sibs] + ["0"] * (L - len(sibs))

    return CircuitInputs(
        electionId=[str(e0), str(e1)],
        nullifier=str(nullifier),
        availableWeight=str(available_weight),
        voteHash=[str(vh0), str(vh1)],
        sikRoot=str(sik_root),
        censusRoot=str(census_root),
        address=str(addr),
        password=str(pwd),
        signature=str(sig),
        voteWeight=str(vote_weight),
        censusSiblings=pad(census_siblings),
        sikSiblings=pad(sik_siblings),
    )


def mock_inputs(n_levels: int = 160, n_keys: int = 10, *,
                seed: int | None = None,
                available_weight: int = 10, vote_weight: int = 5,
                password: bytes = DEFAULT_PASSWORD,
                election_id: bytes = DEFAULT_ELECTION_ID) -> CircuitInputs:
    """MockInputs equivalent (upstream internal/inputs.go:33-98):
    fresh account, SIK signature, census tree (address -> availableWeight)
    and SIK tree (address -> AccountSIK) with n_keys-1 random filler leaves,
    Merkle proofs, nullifier, voteHash."""
    rng = random.Random(seed)
    account = eth.Account(rng.randrange(1, eth.SECP_N) if seed is not None
                          else None)
    signature64 = account.sik_signature()
    addr_bytes = account.address
    addr = arbo.bytes_to_bigint(addr_bytes)
    pwd = ff.big_to_ff(int.from_bytes(password, "big"))
    sig = ff.big_to_ff(int.from_bytes(signature64, "big"))

    census = smt.SMT(max_levels=n_levels)
    census.add(addr_bytes, available_weight)
    sik_tree = smt.SMT(max_levels=n_levels)
    sik_tree.add(addr_bytes, account_sik(addr, pwd, sig))
    for _ in range(n_keys - 1):
        filler = bytes(rng.randrange(256) for _ in range(20))
        try:
            census.add(filler, 1)
            sik_tree.add(filler, 1)
        except ValueError:
            pass  # duplicate random key — same skip behavior as fresh retry

    return generate_circuit_inputs(
        address_bytes=addr_bytes,
        password=password,
        signature64=signature64,
        available_weight=available_weight,
        vote_weight=vote_weight,
        election_id=election_id,
        census_root=census.root,
        census_siblings=census.padded_siblings(addr_bytes, n_levels),
        sik_root=sik_tree.root,
        sik_siblings=sik_tree.padded_siblings(addr_bytes, n_levels),
        n_levels=n_levels,
    )


def mock_batch(n_levels: int, n_voters: int, *, seed: int = 0,
               available_weight: int = 10, vote_weight: int = 5,
               election_id: bytes = DEFAULT_ELECTION_ID,
               device=None) -> list[CircuitInputs]:
    """Batch pipeline: ONE census + ONE SIK tree shared by n_voters voters
    (the production shape: thousands of voters proving against the same
    election roots).  Trees are built with the batched device-hashed
    builder (utils/smt_batch.py — one Poseidon kernel call per tree tier
    instead of one host hash per node); SIK hashes for the whole batch go
    through the same vectorized kernel.  Per-voter proofs are extracted
    from the shared trees.  The hashes run on `device` (default: the
    card)."""
    device = devices.resolve(device)
    rng = random.Random(seed)
    voters = []
    pwd_b = DEFAULT_PASSWORD
    pwd = ff.big_to_ff(int.from_bytes(pwd_b, "big"))
    for _ in range(n_voters):
        acct = eth.Account(rng.randrange(1, eth.SECP_N))
        sig64 = acct.sik_signature()
        sig = ff.big_to_ff(int.from_bytes(sig64, "big"))
        addr_b = acct.address
        addr = arbo.bytes_to_bigint(addr_b)
        voters.append((acct, sig64, sig, addr_b, addr))
    siks = smt_batch.hash_batch(
        [[addr, pwd, sig] for _, _, sig, _, addr in voters], device)
    census = smt_batch.BatchSMT(
        [(addr, available_weight) for *_, addr in voters],
        max_levels=n_levels, device=device)
    sik_tree = smt_batch.BatchSMT(
        [(addr, sik) for (*_, addr), sik in zip(voters, siks)],
        max_levels=n_levels, device=device)
    out = []
    for acct, sig64, sig, addr_b, addr in voters:
        out.append(generate_circuit_inputs(
            address_bytes=addr_b, password=pwd_b, signature64=sig64,
            available_weight=available_weight, vote_weight=vote_weight,
            election_id=election_id,
            census_root=census.root,
            census_siblings=census.padded_siblings(addr, n_levels),
            sik_root=sik_tree.root,
            sik_siblings=sik_tree.padded_siblings(addr, n_levels),
            n_levels=n_levels,
        ))
    return out


def batch_to_arrays(batch: list[CircuitInputs], n_levels: int) -> dict:
    """Stack a list of CircuitInputs into batched plain limb-major arrays
    (numpy int32) for models.census.CensusCircuit.witness: the voter
    batch rides the LAST axis — scalars (21, B), vectors (k, 21, B)."""
    from .models.census import inputs_to_limbs
    dicts = [inputs_to_limbs(asdict(ci), n_levels) for ci in batch]
    return {k: np.concatenate([d[k] for d in dicts], axis=-1)
            for k in dicts[0]}

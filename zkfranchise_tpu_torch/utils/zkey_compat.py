"""Witness-ordering adapter: drive the prover from an externally-produced
Groth16 .zkey.

A zkey's coefficient map and point tables are indexed by the *producer's*
witness numbering.  The native census circuit numbers its signals as
models/census.py documents: [1 | publics | scalar privates | sibling
arrays | gadget blocks in build order].  circom 2.x numbers the same
statement differently: the main component's signals match ours (circom
also orders [1 | public inputs in declaration order | private inputs in
declaration order]), but internal signals follow circom's
component-instantiation order (upstream circuit/census.circom:69-114:
checkWeight, sik Poseidon, sikVerifier (incl. its key Num2Bits),
censusVerifier, computedNullifier).

This module makes producer ordering a first-class, adaptable layer:

  * ``permute_zkey(z, perm)`` rewrites a parsed zkey (coefficient signal
    ids AND the A/B1/B2/C point tables) from producer numbering into
    native numbering, given ``perm[producer_id] = native_id``;
  * ``census_circom_perm(cs)`` derives that permutation for the census
    circuit family from the gadget blocks recorded at construction
    (``cs.gadget_rows``), reordering them into circom's instantiation
    order;
  * ``pk_from_zkey(z)`` turns a native-ordered zkey into a ProvingKey +
    VerifyingKey consumable by groth16.device.DeviceProver;
  * ``arrays_from_zkey(z)`` reconstructs the sparse A/B evaluation
    arrays from the zkey's own coefficient section, so proving does not
    require the circuit's R1CS at all: C-row evaluations come from the
    on-domain identity (A.w)*(B.w) = C.w, exactly how snarkjs proves
    from a zkey that only stores the A and B matrices.

Remaining interop caveat (documented, not hidden): a byte-true
circom-produced zkey for this statement would use circomlib's *gadget
internals* (per-verifier Num2Bits, circomlib SMTVerifier levels), which
are a different R1CS decomposition than the native gadgets.  Proving
with such a key therefore also requires generating the witness for THAT
R1CS: via ``arrays_from_zkey`` the prover consumes any R1CS the zkey
carries, but the witness values themselves must come from a generator
matching the producer's circuit.

Everything here is host Python and numpy; the arrays it returns are what
``DeviceProver(arrays=...)`` takes and moves to its device.
"""
from __future__ import annotations

import numpy as np

from ..groth16.setup import ProvingKey
from ..groth16.verify import VerifyingKey
from ..ops import ff, lm
from . import metrics, serialize

P = ff.P_FR


# ---------------------------------------------------------------------------
# permutations
# ---------------------------------------------------------------------------

def census_circom_perm(cs) -> np.ndarray:
    """perm[producer_id] = native_id for the census family, where the
    producer numbers internal blocks in circom's component-instantiation
    order (census.circom:69-114) and the native circuit numbers them in
    build order (models/census.py build_census_cs)."""
    marks = cs.gadget_rows
    first = min(v["vars"][0] for v in marks.values())
    perm = list(range(first))                        # main region: identity
    producer_order = [
        "weight",                                    # checkWeight
        "sik_poseidon",                              # sik = Poseidon(3)
        "addr_bits", "addr_strict",                  # sikVerifier's Num2Bits
        "sik_tree",                                  # sikVerifier
        "census_tree",                               # censusVerifier
        "nullifier",                                 # computedNullifier + eq
    ]
    assert set(producer_order) == set(marks), sorted(marks)
    for name in producer_order:
        v0, v1 = marks[name]["vars"]
        perm.extend(range(v0, v1))
    assert len(perm) == cs.num_vars
    out = np.asarray(perm, dtype=np.int64)
    assert np.array_equal(np.sort(out), np.arange(cs.num_vars))
    return out


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def permute_zkey(z: serialize.ZkeyData, perm: np.ndarray) \
        -> serialize.ZkeyData:
    """Rewrite a producer-ordered zkey into native ordering.
    perm[producer_id] = native_id; public region must be fixed."""
    n, npub = z.n_vars, z.n_public
    assert len(perm) == n
    assert np.array_equal(perm[:npub + 1], np.arange(npub + 1)), \
        "public signals must keep their positions"

    def scatter(table, offset=0):
        out = [None] * len(table)
        for i, pt in enumerate(table):
            out[int(perm[offset + i]) - offset] = pt
        return out

    return serialize.ZkeyData(
        n_vars=n, n_public=npub, domain=z.domain,
        alpha_g1=z.alpha_g1, beta_g1=z.beta_g1, beta_g2=z.beta_g2,
        gamma_g2=z.gamma_g2, delta_g1=z.delta_g1, delta_g2=z.delta_g2,
        ic=list(z.ic),
        coeffs=[(m, r, int(perm[s]), v) for (m, r, s, v) in z.coeffs],
        a_g1=scatter(z.a_g1),
        b_g1=scatter(z.b_g1),
        b_g2=scatter(z.b_g2),
        c_g1=scatter(z.c_g1, offset=npub + 1),
        h_g1=list(z.h_g1),
    )


def export_in_ordering(z: serialize.ZkeyData, perm: np.ndarray) \
        -> serialize.ZkeyData:
    """Inverse of permute_zkey: rewrite a NATIVE-ordered zkey into the
    producer ordering given by perm[producer_id] = native_id (used to
    emit keys for producer-side tooling, and by tests to simulate a
    producer-ordered key)."""
    return permute_zkey(z, invert_perm(perm))


# ---------------------------------------------------------------------------
# zkey -> prover inputs
# ---------------------------------------------------------------------------

def pk_from_zkey(z: serialize.ZkeyData) -> tuple[ProvingKey, VerifyingKey]:
    """Native-ordered zkey -> (ProvingKey, VerifyingKey).  The H section
    is interpreted in the coset-Lagrange basis this framework's prover
    MSMs against (write_zkey emits the same basis)."""
    pk = ProvingKey(
        n_vars=z.n_vars, n_public=z.n_public, domain=z.domain,
        alpha_g1=z.alpha_g1, beta_g1=z.beta_g1, beta_g2=z.beta_g2,
        delta_g1=z.delta_g1, delta_g2=z.delta_g2,
        a_g1=list(z.a_g1), b_g1=list(z.b_g1), b_g2=list(z.b_g2),
        k_g1=list(z.c_g1), h_g1=list(z.h_g1))
    vk = VerifyingKey({
        "protocol": "groth16", "curve": "bn128", "nPublic": z.n_public,
        "vk_alpha_1": _g1j(z.alpha_g1), "vk_beta_2": _g2j(z.beta_g2),
        "vk_gamma_2": _g2j(z.gamma_g2), "vk_delta_2": _g2j(z.delta_g2),
        "IC": [_g1j(p) for p in z.ic]})
    return pk, vk


def _g1j(p):
    return [str(p[0]), str(p[1]), "1"] if p else ["0", "1", "0"]


def _g2j(p):
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(p[0][0]), str(p[0][1])],
            [str(p[1][0]), str(p[1][1])], ["1", "0"]]


def arrays_from_zkey(z: serialize.ZkeyData) -> dict:
    """Sparse A/B arrays (models/r1cs.export_arrays format) from the
    zkey's coefficient section: int32 row and column indices, which
    DeviceProver widens to int64 when it moves them to its device, and
    Montgomery coefficients (nnz, 21, 1).  No C matrix exists in a zkey;
    the prover derives C-row evaluations from (A.w)*(B.w) = C.w on the
    plain domain (groth16.device.quotient_stage without "c")."""
    r1 = lm.FR.r_mod_p % P
    out = {}
    for name, mat in (("a", 0), ("b", 1)):
        rows, cols, coeffs = [], [], []
        for (m, r, s, v) in z.coeffs:
            if m == mat:
                rows.append(r)
                cols.append(s)
                coeffs.append(v * r1 % P)
        out[name] = (np.asarray(rows, dtype=np.int32),
                     np.asarray(cols, dtype=np.int32),
                     np.asarray(lm.ints_to_lm(coeffs), np.int32).T[:, :, None])
    out["num_constraints"] = 1 + max(
        (r for (_, r, _, _) in z.coeffs), default=0)
    out["num_vars"] = z.n_vars
    out["num_public"] = z.n_public
    return out


def zkey_from_pk(cs, pk: ProvingKey, vk: VerifyingKey) \
        -> serialize.ZkeyData:
    """Native ProvingKey (+ its circuit) -> ZkeyData (native ordering),
    including the coefficient section with the prover's binding rows."""
    from ..groth16 import qap

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
        ic=list(vk.ic), coeffs=coeffs, a_g1=list(pk.a_g1),
        b_g1=list(pk.b_g1), b_g2=list(pk.b_g2), c_g1=list(pk.k_g1),
        h_g1=list(pk.h_g1))


def ingest_zkey(data: bytes, cs=None, ordering: str = "native") \
        -> tuple[ProvingKey, VerifyingKey, dict]:
    """Parse zkey bytes and return (pk, vk, arrays) ready for
    DeviceProver.  ordering: "native" | "census-circom" (requires cs).
    Spans: ingest.read_zkey, ingest.permute (census-circom only),
    ingest.pk_from_zkey, ingest.arrays_from_zkey (with the parsed key's
    release)."""
    if ordering not in ("native", "census-circom"):
        raise ValueError(f"unknown ordering {ordering!r}")
    with metrics.span("ingest.read_zkey"):
        z = serialize.read_zkey(data)
    if ordering == "census-circom":
        assert cs is not None, "census-circom ordering needs the circuit"
        with metrics.span("ingest.permute"):
            z = permute_zkey(z, census_circom_perm(cs))
    with metrics.span("ingest.pk_from_zkey"):
        pk, vk = pk_from_zkey(z)
    with metrics.span("ingest.arrays_from_zkey"):
        arrays = arrays_from_zkey(z)
        # freed after its last use, inside the span: the parsed key's
        # release (its coefficient tuples) is a share of the ingest
        del z
    return pk, vk, arrays

"""Trusted-setup contribution protocol (phase 1 + phase 2) with
transcript hashing, beacon finalization and chain verification.

The port of the JAX package's groth16/contribute.py, the counterpart of
the snarkjs ceremony commands (powersoftau contribute / beacon / verify,
zkey contribute / beacon / verify), following the BGM17 "MMORPG" MPC
shape:

  * every contributor k mixes fresh entropy into the running transcript:
      phase 1: tau *= x, alpha *= a, beta *= b  (power tables rescaled)
      phase 2: delta *= d                       (delta/C/H rescaled)
  * the contribution publishes, per secret s, a public key
        (A = [s]G1, B = [s]G2, S = [s]H)  with  H = hash_to_g1(prev
        transcript hash || secret name)
    — the pairing checks e(A, G2) = e(G1, B) (same s in both groups) and
    e(S, G2) = e(H, B) (knowledge of s, bound to this chain position)
    make contributions non-replayable and non-malleable;
  * every link also publishes its after-points, the G1 points its keys
    rescale ([tau]G1, [alpha]G1, [beta]G1 in phase 1, [delta]G1 in phase
    2), so chain verification walks them from the initial transcript
    link by link with each key's [s]G2, requires the final transcript to
    hold the last link's, then checks the final tables' internal
    consistency (e([tau^{i+1}]G1, G2) = e([tau^i]G1, [tau]G2) etc.);
  * a final *beacon* contribution derives its secret from a public
    random value by iterated hashing, so no participant controls the
    final key.

The toxic waste is never materialized by the coordinator: each secret
exists only inside its contributor's `contribute` call.

The table rescalings run on ``device`` (None: the card, raising without
one): one ops/ec_batch.scale_plane launch a group on a CUDA device, the
native host library on "cpu".  Hashes, keys and pairing checks are host
code.  For the same entropy and previous hash the tables, keys and
``new_hash`` equal the JAX package's.

Two faults of the JAX package's verifiers are repaired here: its phase-2
verifier never linked the final delta to the chain (any delta with a
consistent C/H rescaling passed), and its phase-1 verifier without
intermediate transcripts never bound the final tables to the chain.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..ops import ec, ec_batch, ff, pairing
from ..utils import devices, native
from ..utils.serialize import PtauData

P = ff.P_FR
Q = ff.P_FQ


# ---------------------------------------------------------------------------
# hashing / hash-to-curve
# ---------------------------------------------------------------------------

def _h(*parts: bytes) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    return b"".join(c.to_bytes(32, "big") for c in (*p[0], *p[1]))


def hash_to_g1(data: bytes):
    """Try-and-increment onto y^2 = x^3 + 3 (q = 3 mod 4 sqrt)."""
    ctr = 0
    while True:
        x = int.from_bytes(_h(data, ctr.to_bytes(4, "big")), "big") % Q
        rhs = (x * x % Q * x + 3) % Q
        y = pow(rhs, (Q + 1) // 4, Q)
        if y * y % Q == rhs:
            # parity bit from the hash keeps the choice deterministic
            if _h(data, b"sign", ctr.to_bytes(4, "big"))[0] & 1:
                y = Q - y
            return (x, y)
        ctr += 1


def beacon_scalar(beacon_hex: str, n_iters: int = 1 << 10) -> int:
    """Public-beacon secret: sha256 iterated n_iters times (snarkjs
    `--beacon` convention: the value is public, the iteration count
    makes last-minute grinding expensive)."""
    b = bytes.fromhex(beacon_hex)
    for _ in range(n_iters):
        b = _h(b)
    return int.from_bytes(b, "big") % P or 1


# ---------------------------------------------------------------------------
# contribution records
# ---------------------------------------------------------------------------

@dataclass
class SecretKey1:
    """Per-secret public key of one contribution."""
    a_g1: tuple          # [s]G1
    b_g2: tuple          # [s]G2
    s_g1: tuple          # [s]hash_to_g1(prev_hash || name)


@dataclass
class Contribution:
    """One link of a ceremony chain (phase 1: tau/alpha/beta keys;
    phase 2: delta key only).  `prev_hash` is the transcript hash the
    contributor saw; `new_hash` commits this link.  `after` holds, for
    each secret, the G1 point its key rescales as it stands after this
    link (phase 1: tau_g1[1], alpha_tau_g1[0], beta_tau_g1[0]; phase 2:
    delta_g1); the pairings of the verifiers bind it to the keys."""
    keys: dict = field(default_factory=dict)   # name -> SecretKey1
    prev_hash: bytes = b""
    new_hash: bytes = b""
    is_beacon: bool = False
    beacon_hex: str = ""
    beacon_iters: int = 0
    after: dict = field(default_factory=dict)  # name -> G1 point


def _make_key(name: str, secret: int, prev_hash: bytes) -> SecretKey1:
    h1 = hash_to_g1(prev_hash + name.encode())
    return SecretKey1(
        a_g1=ec.g1_mul(secret),
        b_g2=ec.g2_mul(secret),
        s_g1=ec.G1.mul(secret, h1))


def _key_ok(name: str, key: SecretKey1, prev_hash: bytes) -> bool:
    """e(A, G2) = e(G1, B)  and  e(S, G2) = e(H, B)."""
    for pt in (key.a_g1, key.s_g1):
        if not ec.G1.is_on_curve(pt):
            return False
    if not (ec.G2.is_on_curve(key.b_g2) and ec.in_subgroup_g2(key.b_g2)):
        return False
    if not pairing.multi_pairing_check(
            [(key.a_g1, ec.G2_GEN), (ec.G1.neg(ec.G1_GEN), key.b_g2)]):
        return False
    h1 = hash_to_g1(prev_hash + name.encode())
    return pairing.multi_pairing_check(
        [(key.s_g1, ec.G2_GEN), (ec.G1.neg(h1), key.b_g2)])


def _commit(prev_hash: bytes, keys: dict) -> bytes:
    parts = [prev_hash]
    for name in sorted(keys):
        k = keys[name]
        parts += [name.encode(), _g1_bytes(k.a_g1), _g2_bytes(k.b_g2),
                  _g1_bytes(k.s_g1)]
    return _h(*parts)


GENESIS = _h(b"zkfranchise powersoftau genesis")


def _scale(scalars, points: list, kind: str, dev) -> list:
    """[s_i * P_i] pairwise (`scalars` a list, or one int for all): native
    on the CPU, one scale_plane launch on the card."""
    if dev.type == "cpu":
        if isinstance(scalars, int):
            scalars = [scalars] * len(points)
        batch = native.g1_scale_batch if kind == "g1" else \
            native.g2_scale_batch
        return batch(scalars, points)
    plane = ec_batch.to_plane(points, kind, dev)
    return ec_batch.to_affine(ec_batch.scale_plane(plane, scalars, kind),
                              kind)


# ---------------------------------------------------------------------------
# phase 1: powers of tau
# ---------------------------------------------------------------------------

PHASE1_NAMES = ("tau", "alpha", "beta")


def _phase1_points(ptau: PtauData) -> dict:
    """The points a phase-1 link rescales, by secret."""
    return {"tau": ptau.tau_g1[1], "alpha": ptau.alpha_tau_g1[0],
            "beta": ptau.beta_tau_g1[0]}


def phase1_contribute(ptau: PtauData, entropy: bytes, prev_hash: bytes,
                      _secrets: dict | None = None, device=None) \
        -> tuple[PtauData, Contribution]:
    """Mix fresh (tau, alpha, beta) entropy into the power tables.
    Returns the updated transcript and this link's public record.
    _secrets overrides the derived secrets (beacon path).  The three G1
    tables are rescaled as one batch, the G2 table as another."""
    dev = devices.resolve(device)
    if _secrets is None:
        seed = _h(entropy, prev_hash)
        _secrets = {
            name: int.from_bytes(_h(seed, name.encode()), "big") % P or 1
            for name in ("tau", "alpha", "beta")}
    x, a, b = _secrets["tau"], _secrets["alpha"], _secrets["beta"]

    n1 = len(ptau.tau_g1)
    n = len(ptau.tau_g2)
    na, nb = len(ptau.alpha_tau_g1), len(ptau.beta_tau_g1)
    xi = [1] * n1
    for i in range(1, n1):
        xi[i] = xi[i - 1] * x % P
    g1 = _scale(xi + [a * xi[i] % P for i in range(na)]
                + [b * xi[i] % P for i in range(nb)],
                ptau.tau_g1 + ptau.alpha_tau_g1 + ptau.beta_tau_g1, "g1",
                dev)
    new = PtauData(
        power=ptau.power,
        tau_g1=g1[:n1],
        tau_g2=_scale(xi[:n], ptau.tau_g2, "g2", dev),
        alpha_tau_g1=g1[n1:n1 + na],
        beta_tau_g1=g1[n1 + na:],
        beta_g2=ec.G2.mul(b, ptau.beta_g2),
    )
    keys = {name: _make_key(name, s, prev_hash)
            for name, s in _secrets.items()}
    con = Contribution(keys=keys, prev_hash=prev_hash,
                       new_hash=_commit(prev_hash, keys),
                       after=_phase1_points(new))
    return new, con


def phase1_beacon(ptau: PtauData, beacon_hex: str, prev_hash: bytes,
                  n_iters: int = 1 << 10, device=None) \
        -> tuple[PtauData, Contribution]:
    s = beacon_scalar(beacon_hex, n_iters)
    new, con = phase1_contribute(
        ptau, b"", prev_hash,
        _secrets={"tau": s, "alpha": s, "beta": s}, device=device)
    con.is_beacon = True
    con.beacon_hex = beacon_hex
    con.beacon_iters = n_iters
    return new, con


def _same_ratio(p1, p2, q1, q2) -> bool:
    """e(p2, q1) == e(p1, q2): [s]p1 == p2 w.r.t. the G2 pair (q1, q2)
    with q2 = [s]q1."""
    return pairing.multi_pairing_check(
        [(p2, q1), (ec.G1.neg(p1), q2)])


def _walk(prev: dict, con: Contribution, names) -> bool:
    """Each after-point of `con` is its key's secret times the point
    before it: [s]prev == after against ([1]G2, [s]G2)."""
    for name in names:
        after = con.after.get(name)
        if after is None or not ec.G1.is_on_curve(after) or \
                not _same_ratio(prev[name], after, ec.G2_GEN,
                                con.keys[name].b_g2):
            return False
    return True


def verify_phase1_chain(initial: PtauData, final: PtauData,
                        contributions: list, n_samples: int = 3,
                        rng_seed: int = 0,
                        intermediate: list | None = None) -> bool:
    """Verify a phase-1 ceremony transcript:

      1. every contribution's public keys are well-formed, proven (PoK
         bound to its chain position) and hash-chained;
      2. a beacon contribution's secret re-derives from its public value;
      3. the FINAL tables' first powers chain back through every link:
         final tau_g1[1] = [prod x_k] initial tau_g1[1] etc., walked link
         by link over the links' after-points with each key's [s]G2, and
         the final tables (and each intermediate transcript, when given)
         must hold the points of their link;
      4. the final tables are internally consistent (sampled i):
         e([tau^{i+1}]G1, G2) = e([tau^i]G1, [tau]G2),
         e([alpha tau^i]G1, G2) = e([alpha]G1, [tau^i]G2),
         e([beta  tau^i]G1, G2) = e([beta ]G1, [tau^i]G2),
         e([tau^i]G1, [beta]G2) = e([beta tau^i]G1, G2).
    """
    import random

    h = GENESIS
    for con in contributions:
        if con.prev_hash != h:
            return False
        for name in ("tau", "alpha", "beta"):
            if name not in con.keys:
                return False
            if not _key_ok(name, con.keys[name], h):
                return False
        if con.is_beacon:
            s = beacon_scalar(con.beacon_hex, con.beacon_iters)
            if con.keys["tau"].a_g1 != ec.g1_mul(s):
                return False
        if con.new_hash != _commit(h, con.keys):
            return False
        h = con.new_hash

    # 3. link the chain ends: walk tau_g1[1] / alpha[0] / beta[0] through
    # each contribution's after-points and G2 keys
    if intermediate is not None and \
            len(intermediate) != len(contributions) - 1:
        return False
    prev = _phase1_points(initial)
    for k, con in enumerate(contributions):
        if not _walk(prev, con, PHASE1_NAMES):
            return False
        if intermediate is not None and k < len(intermediate) and \
                _phase1_points(intermediate[k]) != con.after:
            return False
        prev = con.after
    if _phase1_points(final) != prev:
        return False
    # 4. internal consistency of the final tables
    rng = random.Random(rng_seed)
    n = len(final.tau_g2)
    idx = rng.sample(range(1, n - 1), min(n_samples, n - 2))
    for i in idx:
        if not _same_ratio(final.tau_g1[i], final.tau_g1[i + 1],
                           ec.G2_GEN, final.tau_g2[1]):
            return False
        if not _same_ratio(final.alpha_tau_g1[0], final.alpha_tau_g1[i],
                           ec.G2_GEN, final.tau_g2[i]):
            return False
        if not _same_ratio(final.beta_tau_g1[0], final.beta_tau_g1[i],
                           ec.G2_GEN, final.tau_g2[i]):
            return False
    if not _same_ratio(final.beta_tau_g1[0], final.tau_g1[0],
                       final.beta_g2, ec.G2_GEN):
        # e(beta_g1, G2) must equal e(G1, beta_g2)  (order swapped form)
        return False
    return True


# ---------------------------------------------------------------------------
# phase 2: zkey (delta) contributions
# ---------------------------------------------------------------------------

def phase2_contribute(pk, entropy: bytes, prev_hash: bytes,
                      _secret: int | None = None, device=None):
    """Mix fresh delta entropy into a ProvingKey: delta *= d, C and H
    tables *= d^-1 (one batch: the same scalar for both).  Returns
    (new_pk, Contribution)."""
    from .setup import ProvingKey

    dev = devices.resolve(device)
    if _secret is None:
        seed = _h(entropy, prev_hash)
        _secret = int.from_bytes(_h(seed, b"delta"), "big") % P or 1
    d = _secret
    dinv = ff.inv_mod(d, P)
    m_priv = len(pk.k_g1)
    kh = _scale(dinv, pk.k_g1 + pk.h_g1, "g1", dev)
    new = ProvingKey(
        n_vars=pk.n_vars, n_public=pk.n_public, domain=pk.domain,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=ec.G1.mul(d, pk.delta_g1),
        delta_g2=ec.G2.mul(d, pk.delta_g2),
        a_g1=list(pk.a_g1), b_g1=list(pk.b_g1), b_g2=list(pk.b_g2),
        k_g1=kh[:m_priv], h_g1=kh[m_priv:])
    keys = {"delta": _make_key("delta", d, prev_hash)}
    con = Contribution(keys=keys, prev_hash=prev_hash,
                       new_hash=_commit(prev_hash, keys),
                       after={"delta": new.delta_g1})
    return new, con


def phase2_beacon(pk, beacon_hex: str, prev_hash: bytes,
                  n_iters: int = 1 << 10, device=None):
    s = beacon_scalar(beacon_hex, n_iters)
    new, con = phase2_contribute(pk, b"", prev_hash, _secret=s,
                                 device=device)
    con.is_beacon = True
    con.beacon_hex = beacon_hex
    con.beacon_iters = n_iters
    return new, con


def verify_phase2_chain(pk_initial, pk_final, contributions: list,
                        genesis_hash: bytes, n_samples: int = 2,
                        rng_seed: int = 0) -> bool:
    """Verify a phase-2 delta chain: PoK/hash chain per link; delta_g1
    walks from pk_initial's through every link's after-point ([d]prev ==
    after against the link's [d]G2) and pk_final must hold the last one;
    the final delta halves agree, and the final C and H tables stay
    consistent with the initial ones (sampled i):
        e(k_final[i], delta_final_g2) == e(k_initial[i], delta_init_g2).
    """
    import random

    h = genesis_hash
    prev = {"delta": pk_initial.delta_g1}
    for con in contributions:
        if con.prev_hash != h or "delta" not in con.keys:
            return False
        key = con.keys["delta"]
        if not _key_ok("delta", key, h):
            return False
        if con.is_beacon:
            s = beacon_scalar(con.beacon_hex, con.beacon_iters)
            if key.a_g1 != ec.g1_mul(s):
                return False
        if con.new_hash != _commit(h, con.keys):
            return False
        if not _walk(prev, con, ("delta",)):
            return False
        prev = con.after
        h = con.new_hash
    if pk_final.delta_g1 != prev["delta"]:
        return False
    if not pairing.multi_pairing_check(
            [(pk_final.delta_g1, ec.G2_GEN),
             (ec.G1.neg(ec.G1_GEN), pk_final.delta_g2)]):
        return False
    rng = random.Random(rng_seed)
    m = len(pk_final.k_g1)
    if len(pk_initial.k_g1) != m:
        return False
    for i in rng.sample(range(m), min(n_samples, m)):
        if pk_final.k_g1[i] is None or pk_initial.k_g1[i] is None:
            if pk_final.k_g1[i] != pk_initial.k_g1[i]:
                return False
            continue
        # k_i = K_i/delta: K_i is chain-invariant, so
        # e(k_final[i], delta_final) == e(K_i, G2) == e(k_init[i], delta_init)
        if not pairing.multi_pairing_check(
                [(pk_final.k_g1[i], pk_final.delta_g2),
                 (ec.G1.neg(pk_initial.k_g1[i]), pk_initial.delta_g2)]):
            return False
    for i in rng.sample(range(len(pk_final.h_g1)),
                        min(n_samples, len(pk_final.h_g1))):
        if not pairing.multi_pairing_check(
                [(pk_final.h_g1[i], pk_final.delta_g2),
                 (ec.G1.neg(pk_initial.h_g1[i]), pk_initial.delta_g2)]):
            return False
    return True

"""Groth16 verification against snarkjs JSON (verification_key.json,
proof.json, signals.json), as go-rapidsnark verifies (upstream
zk_census_test.go:118-122):

    e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1,
    vk_x = IC[0] + sum_i signal_i * IC[i + 1].

``well_formed`` is the cheap part that every proof of a run gets: the
points parse, A and C lie on E(Fq), B on the twist.  ``verify`` adds B's
subgroup check and the pairing equation; ``verify_batch`` checks many
proofs' equations at once.
"""
from __future__ import annotations

from . import bn254
from .field import P_FQ as Q, P_FR, inv


def g1(coords):
    """snarkjs projective G1 [x, y, z] -> affine (x, y) or None."""
    x, y, z = (int(c) for c in coords)
    if z == 0:
        return None
    if z != 1:
        zi = inv(z, Q)
        x, y = x * zi, y * zi
    return (x % Q, y % Q)


def g2(coords):
    """snarkjs projective G2 [[x0, x1], [y0, y1], [z0, z1]] -> affine."""
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in coords)
    if (z0, z1) == (0, 0):
        return None
    x, y = (x0 % Q, x1 % Q), (y0 % Q, y1 % Q)
    if (z0, z1) != (1, 0):
        zi = bn254.fq2_inv((z0 % Q, z1 % Q))
        x, y = bn254.fq2_mul(x, zi), bn254.fq2_mul(y, zi)
    return (x, y)


class VerifyingKey:
    def __init__(self, d: dict):
        if d.get("protocol", "groth16") != "groth16" or \
                d.get("curve", "bn128") not in ("bn128", "bn254"):
            raise ValueError("not a Groth16 key over BN254")
        self.n_public = int(d["nPublic"])
        self.alpha = g1(d["vk_alpha_1"])
        self.beta, self.gamma, self.delta = (
            g2(d[k]) for k in ("vk_beta_2", "vk_gamma_2", "vk_delta_2"))
        self.ic = [g1(p) for p in d["IC"]]
        if len(self.ic) != self.n_public + 1:
            raise ValueError("IC does not match nPublic")
        self._alpha_beta = None

    def alpha_beta(self):
        """The Miller loop of e(alpha, beta), shared by every proof."""
        if self._alpha_beta is None:
            self._alpha_beta = bn254.miller_loop(self.alpha, self.beta)
        return self._alpha_beta


def parse_proof(d: dict) -> tuple:
    return g1(d["pi_a"]), g2(d["pi_b"]), g1(d["pi_c"])


def well_formed(proof: tuple) -> bool:
    a, b, c = proof
    return (a is not None and c is not None and b is not None
            and bn254.G1.on_curve(a) and bn254.G1.on_curve(c)
            and bn254.G2.on_curve(b))


def verify(vk: VerifyingKey, proof: tuple, public_signals: list) -> bool:
    signals = [int(s) % P_FR for s in public_signals]
    if len(signals) != vk.n_public or not well_formed(proof):
        return False
    a, b, c = proof
    if not bn254.in_g2_subgroup(b):
        return False
    return bn254.product_is_one([
        bn254.miller_loop(bn254.G1.neg(a), b), vk.alpha_beta(),
        bn254.miller_loop(_vk_x(vk, [1, *signals]), vk.gamma),
        bn254.miller_loop(c, vk.delta)])


def _vk_x(vk: VerifyingKey, weights: list):
    """sum_i weights[i] * IC[i]."""
    acc = None
    for w, point in zip(weights, vk.ic):
        acc = bn254.G1.add(acc, bn254.G1.mul(w % P_FR, point))
    return acc


def verify_batch(vk: VerifyingKey, items: list, rng) -> bool:
    """Whether every (proof, public signals) of `items` verifies, in one
    pairing check: each proof's equation raised to a weight r_i < 2^64
    drawn from `rng`, and the equations multiplied,

        prod_i e(-r_i A_i, B_i) * e(sum_i r_i alpha, beta)
            * e(sum_i r_i vk_x_i, gamma) * e(sum_i r_i C_i, delta) == 1.

    A set holding a proof that fails passes with probability 2^-64 at
    most; each proof costs one Miller loop and two short scalar products,
    not four Miller loops and a final exponentiation."""
    loops, c_sum = [], None
    weights = [0] * len(vk.ic)
    for proof, public_signals in items:
        signals = [int(s) % P_FR for s in public_signals]
        if len(signals) != vk.n_public or not well_formed(proof):
            return False
        a, b, c = proof
        if not bn254.in_g2_subgroup(b):
            return False
        r = rng.randrange(1, 1 << 64)
        loops.append(bn254.miller_loop(bn254.G1.neg(bn254.G1.mul(r, a)), b))
        c_sum = bn254.G1.add(c_sum, bn254.G1.mul(r, c))
        weights[0] += r
        for j, s in enumerate(signals, 1):
            weights[j] += r * s
    loops += [
        bn254.miller_loop(bn254.G1.mul(weights[0] % P_FR, vk.alpha), vk.beta),
        bn254.miller_loop(_vk_x(vk, weights), vk.gamma),
        bn254.miller_loop(c_sum, vk.delta)]
    return bn254.product_is_one(loops)

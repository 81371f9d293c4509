"""Groth16 verifier, wire-compatible with snarkjs JSON artifacts.

Accepts the reference verification_key.json / proof.json / signals.json
formats verbatim (upstream artifacts/zkCensus/dev/160/) and checks
the pairing equation
    e(pi_a, pi_b) = e(alpha, beta) * e(vk_x, gamma) * e(pi_c, delta)
with vk_x = IC[0] + sum_i signal_i * IC[i+1], exactly what
go-rapidsnark's verifier does at upstream zk_census_test.go:118-122.

The committed reference proof verifying under this module is the golden
cross-implementation test of the whole host BN254 stack (Fq2/Fq12 tower,
Miller loop, final exponentiation).
"""
from __future__ import annotations

import json

from ..ops import ec, ff, pairing


def _parse_g1(coords) -> tuple | None:
    x, y, z = (int(c) for c in coords)
    if z == 0:
        return None
    if z != 1:
        zi = ff.inv_mod(z, ff.P_FQ)
        x, y = x * zi % ff.P_FQ, y * zi % ff.P_FQ
    return (x % ff.P_FQ, y % ff.P_FQ)


def _parse_g2(coords) -> tuple | None:
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in coords)
    if (z0, z1) == (0, 0):
        return None
    if (z0, z1) != (1, 0):
        zi = ec.fq2_inv((z0 % ff.P_FQ, z1 % ff.P_FQ))
        x0, x1 = ec.fq2_mul((x0, x1), zi)
        y0, y1 = ec.fq2_mul((y0, y1), zi)
    return ((x0 % ff.P_FQ, x1 % ff.P_FQ), (y0 % ff.P_FQ, y1 % ff.P_FQ))


class VerifyingKey:
    def __init__(self, d: dict):
        assert d.get("protocol", "groth16") == "groth16"
        assert d.get("curve", "bn128") in ("bn128", "bn254")
        self.n_public = int(d["nPublic"])
        self.alpha_1 = _parse_g1(d["vk_alpha_1"])
        self.beta_2 = _parse_g2(d["vk_beta_2"])
        self.gamma_2 = _parse_g2(d["vk_gamma_2"])
        self.delta_2 = _parse_g2(d["vk_delta_2"])
        self.ic = [_parse_g1(p) for p in d["IC"]]
        assert len(self.ic) == self.n_public + 1

    @staticmethod
    def from_json(s: str) -> "VerifyingKey":
        return VerifyingKey(json.loads(s))

    def to_dict(self) -> dict:
        def g1(p):
            return [str(p[0]), str(p[1]), "1"] if p else ["0", "1", "0"]

        def g2(p):
            if p is None:
                return [["0", "0"], ["1", "0"], ["0", "0"]]
            return [[str(p[0][0]), str(p[0][1])],
                    [str(p[1][0]), str(p[1][1])], ["1", "0"]]

        return {
            "protocol": "groth16",
            "curve": "bn128",
            "nPublic": self.n_public,
            "vk_alpha_1": g1(self.alpha_1),
            "vk_beta_2": g2(self.beta_2),
            "vk_gamma_2": g2(self.gamma_2),
            "vk_delta_2": g2(self.delta_2),
            "IC": [g1(p) for p in self.ic],
        }


class Proof:
    def __init__(self, d: dict):
        self.pi_a = _parse_g1(d["pi_a"])
        self.pi_b = _parse_g2(d["pi_b"])
        self.pi_c = _parse_g1(d["pi_c"])

    @staticmethod
    def from_json(s: str) -> "Proof":
        return Proof(json.loads(s))

    def to_dict(self) -> dict:
        return {
            "pi_a": [str(self.pi_a[0]), str(self.pi_a[1]), "1"],
            "pi_b": [[str(self.pi_b[0][0]), str(self.pi_b[0][1])],
                     [str(self.pi_b[1][0]), str(self.pi_b[1][1])],
                     ["1", "0"]],
            "pi_c": [str(self.pi_c[0]), str(self.pi_c[1]), "1"],
            "protocol": "groth16",
            "curve": "bn128",
        }


def verify(vk: VerifyingKey, proof: Proof, public_signals: list) -> bool:
    signals = [int(s) % ff.P_FR for s in public_signals]
    if len(signals) != vk.n_public:
        return False
    for pt in (proof.pi_a, proof.pi_c, *vk.ic):
        if not ec.G1.is_on_curve(pt):
            return False
    for pt in (proof.pi_b, vk.beta_2, vk.gamma_2, vk.delta_2):
        # on-curve is not enough for G2: the twist's cofactor is large,
        # so points outside the r-torsion must be rejected before the
        # pairing (gnark-crypto does this on deserialization; reference
        # call path upstream zk_census_test.go:118)
        if not (ec.G2.is_on_curve(pt) and ec.in_subgroup_g2(pt)):
            return False
    vk_x = vk.ic[0]
    for s, icp in zip(signals, vk.ic[1:]):
        vk_x = ec.G1.add(vk_x, ec.G1.mul(s, icp))
    # e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1
    return pairing.multi_pairing_check([
        (ec.G1.neg(proof.pi_a), proof.pi_b),
        (vk.alpha_1, vk.beta_2),
        (vk_x, vk.gamma_2),
        (proof.pi_c, vk.delta_2),
    ])


def verify_files(vkey_path: str, proof_path: str, signals_path: str) -> bool:
    with open(vkey_path) as f:
        vk = VerifyingKey(json.load(f))
    with open(proof_path) as f:
        proof = Proof(json.load(f))
    with open(signals_path) as f:
        signals = json.load(f)
    return verify(vk, proof, signals)

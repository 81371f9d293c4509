"""A stand-in for the program on the CPU, for the harness's own tests.

The port proves a voter on the CPU in about a minute, too slow for a test
of the whole run.  The stand-in proves with a trapdoor instead: it holds
the secrets of its own verification key (alpha, beta, gamma, delta and the
IC points' discrete logs), so for any public signals it can make a proof
that Groth16 verification accepts: A = u G1, B = v G2, C = c G1 with c =
(u v - alpha beta - gamma sum_i x_i ic_i) / delta.  Its signals are the
reference's, worked out from the inputs it is handed.  Each of the faults
a run of the cell can have is planted in it by name.
"""
from __future__ import annotations

import random
from types import SimpleNamespace

from benchmark.harness import program
from benchmark.reference import bn254, census
from benchmark.reference.field import P_FR as R

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
KEYS = ("electionId", "nullifier", "availableWeight", "voteHash", "sikRoot",
        "censusRoot", "address", "password", "signature", "voteWeight",
        "censusSiblings", "sikSiblings")
FAULTS = (None, "stale", "half", "altered", "unsound")


def _g1(p):
    return [str(p[0]), str(p[1]), "1"]


def _g2(p):
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])],
            ["1", "0"]]


class TrapdoorKey:
    def __init__(self, seed: int, n_public: int = 8):
        rng = random.Random(seed)
        self.a, self.b, self.g, self.d = (rng.randrange(1, R)
                                          for _ in range(4))
        self.ic = [rng.randrange(1, R) for _ in range(n_public + 1)]

    def vk(self) -> dict:
        return {"protocol": "groth16", "curve": "bn128",
                "nPublic": len(self.ic) - 1,
                "vk_alpha_1": _g1(bn254.G1.mul(self.a, G1_GEN)),
                "vk_beta_2": _g2(bn254.G2.mul(self.b, G2_GEN)),
                "vk_gamma_2": _g2(bn254.G2.mul(self.g, G2_GEN)),
                "vk_delta_2": _g2(bn254.G2.mul(self.d, G2_GEN)),
                "IC": [_g1(bn254.G1.mul(x, G1_GEN)) for x in self.ic]}

    def prove(self, signals: list, rng: random.Random,
              sound: bool = True) -> dict:
        u, v = rng.randrange(1, R), rng.randrange(1, R)
        s = sum(x * k for x, k in zip([1, *signals], self.ic))
        c = (u * v - self.a * self.b - self.g * s) % R
        c = c * pow(self.d, -1, R) % R if sound else c
        return {"pi_a": _g1(bn254.G1.mul(u, G1_GEN)),
                "pi_b": _g2(bn254.G2.mul(v, G2_GEN)),
                "pi_c": _g1(bn254.G1.mul(c, G1_GEN)),
                "protocol": "groth16", "curve": "bn128"}


class _Proof:
    def __init__(self, d: dict):
        self.d = d

    def to_dict(self) -> dict:
        return self.d


def _lanes(arrays: dict) -> list:
    """The voters' inputs back from batch_to_arrays' limb planes."""
    from zkfranchise_tpu_torch.ops import lm
    batch = arrays["address"].shape[-1]
    flat = {k: lm.lm_to_ints(arrays[k]) for k in KEYS}
    out = []
    for j in range(batch):
        d = {}
        for k in KEYS:
            rows = len(flat[k]) // batch
            vals = [str(flat[k][i * batch + j]) for i in range(rows)]
            d[k] = vals if k in ("electionId", "voteHash", "censusSiblings",
                                 "sikSiblings") else vals[0]
        out.append(d)
    return out


class StubProver:
    """ProofStream's prover (.circuit, .device, prove_batch), with a
    planted fault: "stale" hands back the previous call's proofs (a step
    that returns its state unchanged), "half" proves the first half of the
    batch and repeats it for the rest, "altered" moves every proof's C off
    its value where it is made, "unsound" leaves delta out of C (the proofs
    are well formed, carry the right signals, and fail the pairing)."""

    def __init__(self, key: TrapdoorKey, nlevels: int, fault=None):
        self.key, self.fault = key, fault
        self.circuit = SimpleNamespace(n_levels=nlevels)
        self.device = "cpu"
        self.last = None

    def prove_batch(self, arrays: dict, seed: int = 0):
        lanes = _lanes(arrays)
        if self.fault == "stale" and self.last and \
                len(self.last[0]) == len(lanes):
            return self.last
        if self.fault == "half":
            lanes = lanes[:max(1, len(lanes) // 2)] * 2
            lanes = lanes[:arrays["address"].shape[-1]]
        rng = random.Random(seed)
        proofs, pubs = [], []
        for d in lanes:
            signals, _ = census.signals(d)
            p = self.key.prove(signals, rng, sound=self.fault != "unsound")
            if self.fault == "altered":
                p["pi_c"][0] = str(int(p["pi_c"][0]) + 1)
            proofs.append(_Proof(p))
            pubs.append(signals)
        self.last = proofs, pubs
        return proofs, pubs


class StubEnv:
    """cell.execute's environment on the CPU, around a StubProver."""

    def __init__(self, root, bench, fault=None, key_seed: int = 1):
        self.root, self.bench, self.fault = root, bench, fault
        self.key = TrapdoorKey(key_seed)
        self._vk = self.key.vk()

    def setup(self, cell, sizes, spans):
        with program.span(spans, "key_ingest"):
            pass
        spans["capture"] = 0.0
        return program.Program(
            prover=StubProver(self.key, cell.config["nlevels"], self.fault),
            domain=0, spans=spans)

    def vk(self, cell) -> dict:
        return self._vk

    def device(self, chips: int) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}

    def card(self) -> dict:
        return {}

    def free(self, prog) -> None:
        prog.prover = None

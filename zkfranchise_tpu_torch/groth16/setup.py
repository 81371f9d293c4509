"""Groth16 trusted setup (deterministic dev mode) for the zkCensus family.

Replaces the snarkjs powersoftau + zkey ceremony pipeline
(upstream circuit/circuit-compiler.sh:52-136) with a native,
deterministic dev-mode setup: the toxic waste (tau, alpha, beta, delta) is
derived from a seed, gamma is fixed to 1 — the same convention snarkjs uses
(the reference vk_gamma_2 equals the G2 generator).  The reference's actual
proving key is not in the mount (.MISSING_LARGE_BLOBS), so keys here are
self-generated; the exported verification key uses the reference
verification_key.json JSON format verbatim and our proofs verify under the
same pairing equation.

The H-table is laid out in the coset-Lagrange basis so the prover can MSM
directly with the coset evaluations of A*B - C (no quotient division on
device): H_j = [ L^coset_j(tau) * Z(tau) / ((s^n - 1) * delta) ] G1.
"""
from __future__ import annotations

import hashlib
import pickle
from dataclasses import dataclass
from pathlib import Path

from ..ops import ec, ff
from ..utils import native
from . import poly, qap
from .verify import VerifyingKey

P = ff.P_FR


def _derive_scalars(seed: bytes, names: list[str]) -> dict:
    out = {}
    for name in names:
        h = hashlib.sha256(seed + b"/" + name.encode()).digest()
        out[name] = int.from_bytes(h, "big") % P
        if out[name] == 0:
            out[name] = 1
    return out


@dataclass
class ProvingKey:
    n_vars: int
    n_public: int
    domain: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_g1: list      # [A_i(tau)] G1, len n_vars
    b_g1: list      # [B_i(tau)] G1
    b_g2: list      # [B_i(tau)] G2
    k_g1: list      # [(beta A_i + alpha B_i + C_i)/delta] G1, private wires
    h_g1: list      # coset-Lagrange H table, len domain

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str | Path) -> "ProvingKey":
        """Reads keys pickled by this package or by the JAX package: the
        JAX package's ProvingKey class is remapped to this one, so loading
        never imports jax."""
        with open(path, "rb") as f:
            return _KeyUnpickler(f).load()


class _KeyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "zkfranchise_tpu.groth16.setup" and name == "ProvingKey":
            return ProvingKey
        return super().find_class(module, name)


def dev_setup(cs, seed: bytes = b"zkfranchise-dev-setup",
              seconds: dict | None = None) \
        -> tuple[ProvingKey, VerifyingKey]:
    """cs: models.r1cs.ConstraintSystem.  Returns (pk, vk).

    seconds: if a dict is given, the seconds of each part go into it:
    rows_and_lagrange (the QAP at tau and the key's scalars), g1_products,
    g2_products, conversions (ints to and from the native library's
    limbs) and key (the points put together into pk and vk)."""
    lap = native.Laps(seconds)
    m = cs.num_vars
    npub = cs.num_public
    n = qap.domain_size(cs.num_constraints, npub)
    tw = _derive_scalars(seed, ["tau", "alpha", "beta", "delta"])
    tau, alpha, beta, delta = tw["tau"], tw["alpha"], tw["beta"], tw["delta"]
    dinv = ff.inv_mod(delta, P)

    # Lagrange evaluations over the plain domain at tau
    lag = poly.lagrange_evals_at(tau, n)

    rows = list(cs.constraints) + qap.binding_rows(npub)
    a_tau = [0] * m
    b_tau = [0] * m
    c_tau = [0] * m
    for r, (a, b, c) in enumerate(rows):
        lr = lag[r]
        for i, cf in a.items():
            a_tau[i] = (a_tau[i] + cf * lr) % P
        for i, cf in b.items():
            b_tau[i] = (b_tau[i] + cf * lr) % P
        for i, cf in c.items():
            c_tau[i] = (c_tau[i] + cf * lr) % P

    k_scalars = [
        (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) % P * dinv % P
        for i in range(npub + 1, m)
    ]
    # H table: L^coset_j(tau) * Z(tau) / ((s^n - 1) * delta)
    s = poly.COSET_SHIFT
    zn = (pow(tau, n, P) - 1) % P            # Z(tau) for plain domain
    sn1 = (pow(s, n, P) - 1) % P             # Z evaluated on the coset
    scale = zn * ff.inv_mod(sn1, P) % P * dinv % P
    lag_coset = poly.lagrange_evals_at(tau, n, shift=s)
    h_scalars = [lc * scale % P for lc in lag_coset]
    ic_scalars = [
        (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) % P  # gamma = 1
        for i in range(npub + 1)
    ]

    # all G1 keygen in one fixed-base batch (native C++ when available)
    g1_batch = ([alpha, beta, delta] + a_tau + b_tau + k_scalars
                + h_scalars + ic_scalars)
    lap("rows_and_lagrange")
    g1_pts = native.g1_fixed_base_mul(g1_batch, lap=lap)
    alpha_g1, beta_g1, delta_g1 = g1_pts[0], g1_pts[1], g1_pts[2]
    off = 3
    a_g1 = g1_pts[off:off + m]; off += m
    b_g1 = g1_pts[off:off + m]; off += m
    k_g1 = g1_pts[off:off + len(k_scalars)]; off += len(k_scalars)
    h_g1 = g1_pts[off:off + n]; off += n
    ic_g1 = g1_pts[off:off + npub + 1]

    g2_pts = native.g2_fixed_base_mul([beta, delta] + b_tau, lap=lap)
    beta_g2, delta_g2 = g2_pts[0], g2_pts[1]
    b_g2 = g2_pts[2:]

    vk = VerifyingKey({
        "protocol": "groth16", "curve": "bn128", "nPublic": npub,
        "vk_alpha_1": _g1j(alpha_g1),
        "vk_beta_2": _g2j(beta_g2),
        "vk_gamma_2": _g2j(ec.G2_GEN),
        "vk_delta_2": _g2j(delta_g2),
        "IC": [_g1j(x) for x in ic_g1],
    })
    pk = ProvingKey(
        n_vars=m, n_public=npub, domain=n,
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        delta_g1=delta_g1, delta_g2=delta_g2,
        a_g1=a_g1, b_g1=b_g1, b_g2=b_g2, k_g1=k_g1, h_g1=h_g1,
    )
    lap("key")
    return pk, vk


def _g1j(p):
    return [str(p[0]), str(p[1]), "1"] if p else ["0", "1", "0"]


def _g2j(p):
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])],
            ["1", "0"]]

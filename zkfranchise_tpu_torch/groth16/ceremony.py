"""Proving-key derivation from a powers-of-tau transcript (ptau -> pk).

The port of the JAX package's groth16/ceremony.py.  Given a parsed ptau
(utils/serialize.read_ptau) and the constraint system, it derives the
whole Groth16 proving key without knowing tau, alpha or beta; only the
phase-2 delta is local (dev-derived here; groth16/contribute.py rescales
it afterwards).

Math (domain size n, root w, coset shift s):
  [L_r(tau)]G      = EC-iNTT over [tau^j]G         (Lagrange basis)
  A_i(tau)G1       = sum_r a_{r,i} [L_r(tau)]G1    (sparse per-wire sum)
  K_i              = beta*A_i + alpha*B_i + C_i    (via the [alpha tau^j]G1
                                                    and [beta tau^j]G1
                                                    tables)
  k_g1[i]          = K_i / delta (private wires);  IC = K_i (publics,
                                                    gamma = 1 as snarkjs)
  H_j (coset-Lagrange layout, groth16/setup.py)  =
      [L^coset_j(tau) Z(tau) / ((s^n - 1) delta)]G1,
      from P_i = s^-i (tau^(n+i) - tau^i)G1 followed by an EC-iNTT.

Two routes, chosen by ``device`` (None: the card, raising without one):

  * ``cpu``: the JAX package's route over the native host library
    (utils/native.py scale/add/segsum batches), point lists throughout;
  * ``cuda``: every EC batch on lane planes through ops/ec_batch.py: the
    five EC-iNTTs (one per-lane scalar_mul and two padds a stage), the six
    wire sums (a gather, one scalar_mul, a segmented sum of padds), K's
    two adds, the n^-1, k, pre and H scalings and the tau^(n+i) - tau^i
    subtraction.  Only the transcript's tables enter from the host, once
    each, and the key's tables leave once; it does not use native.

Both give the same affine points as the JAX package, and with a dev ptau
of the same seed a key equal to setup.dev_setup's point for point.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import ec, ec_batch, ff
from ..ops.cuda import lm_kernels as K
from ..utils import devices, native
from ..utils.serialize import PtauData
from . import poly, qap
from .device import _StageClock
from .setup import ProvingKey, _derive_scalars, _g1j, _g2j
from .verify import VerifyingKey

P = ff.P_FR
Q = ff.P_FQ


# ---------------------------------------------------------------------------
# the host route (the JAX package's, over native)
# ---------------------------------------------------------------------------

def _g1_neg(p):
    return None if p is None else (p[0], (Q - p[1]) % Q)


def _g2_neg(p):
    if p is None:
        return None
    (x0, x1), (y0, y1) = p
    return ((x0, x1), ((Q - y0) % Q, (Q - y1) % Q))


def _bitrev_perm(xs):
    n = len(xs)
    bits = n.bit_length() - 1
    out = [None] * n
    for i, x in enumerate(xs):
        out[int(bin(i)[2:].zfill(bits)[::-1] or "0", 2)] = x
    return out


def _ec_ntt(points, root, scale_batch, add_batch, neg):
    """Radix-2 NTT over an EC point list: out_r = sum_j root^(rj) P_j.  One
    scalar-mul batch and two add batches a stage."""
    n = len(points)
    x = _bitrev_perm(points)
    size = 2
    while size <= n:
        half = size // 2
        step = pow(root, n // size, P)
        tws, his, los, hi_pos, lo_pos = [], [], [], [], []
        for b in range(0, n, size):
            w = 1
            for j in range(half):
                lo_pos.append(b + j)
                hi_pos.append(b + half + j)
                los.append(x[b + j])
                his.append(x[b + half + j])
                tws.append(w)
                w = w * step % P
        t = scale_batch(tws, his)
        new_lo = add_batch(los, t)
        new_hi = add_batch(los, [neg(p) for p in t])
        for pos, v in zip(lo_pos, new_lo):
            x[pos] = v
        for pos, v in zip(hi_pos, new_hi):
            x[pos] = v
        size *= 2
    return x


_HOST = {"g1": (native.g1_scale_batch, native.g1_add_batch, _g1_neg,
                native.g1_segsum),
         "g2": (native.g2_scale_batch, native.g2_add_batch, _g2_neg,
                native.g2_segsum)}


def _inverse_root(n: int) -> int:
    return ff.inv_mod(poly.root_of_unity(n.bit_length() - 1), P)


def _lagrange_host(powers: list, kind: str) -> list:
    scale, add, neg, _ = _HOST[kind]
    n = len(powers)
    out = _ec_ntt(powers, _inverse_root(n), scale, add, neg)
    return scale([ff.inv_mod(n, P)] * n, out)


def _lagrange_plane(plane: torch.Tensor, kind: str) -> torch.Tensor:
    """(rows, n) plane of [tau^j]G -> plane of [L_r(tau)]G."""
    n = plane.shape[-1]
    out = ec_batch.ec_ntt_plane(plane, _inverse_root(n), kind)
    return ec_batch.scale_plane(out, ff.inv_mod(n, P), kind)


def _lagrange(powers: list, kind: str, device) -> list:
    dev = devices.resolve(device)
    if dev.type == "cpu":
        return _lagrange_host(powers, kind)
    return ec_batch.to_affine(
        _lagrange_plane(ec_batch.to_plane(powers, kind, dev), kind), kind)


def ec_lagrange_g1(powers: list, device=None) -> list:
    """[tau^j]G1 (natural order, len n a power of two) -> [L_r(tau)]G1."""
    return _lagrange(powers, "g1", device)


def ec_lagrange_g2(powers: list, device=None) -> list:
    return _lagrange(powers, "g2", device)


def _wire_combo(entries, lagr, kind: str, m: int):
    """entries (rows, wires, coeffs) -> per-wire sums of coeff * lagr[row].
    lagr a host point list: the native route, a list of m points back;
    lagr a (rows, n) plane: the plane route, a (rows, m) plane back."""
    rows, wires, coeffs = entries
    if isinstance(lagr, torch.Tensor):
        return ec_batch.wire_combo_plane(rows, wires, coeffs, lagr, m, kind)
    if not len(wires):
        return [None] * m
    scale, _, _, segsum = _HOST[kind]
    pts = scale(list(coeffs), [lagr[r] for r in rows])
    return segsum(pts, list(wires), m)


def _entries(cs) -> list:
    """The R1CS's A, B and C entries (binding rows included), each as
    (rows, wires, coeffs): two int64 arrays and a list of Python ints."""
    rows = list(cs.constraints) + qap.binding_rows(cs.num_public)
    out = []
    for sel in (0, 1, 2):
        rr, ww, cc = [], [], []
        for r, con in enumerate(rows):
            for i, cf in con[sel].items():
                rr.append(r)
                ww.append(i)
                cc.append(cf)
        out.append((np.asarray(rr, dtype=np.int64),
                    np.asarray(ww, dtype=np.int64), cc))
    return out


# ---------------------------------------------------------------------------
# the dev transcript and the key check
# ---------------------------------------------------------------------------

def dev_ptau(power: int, seed: bytes = b"zkfranchise-dev-setup") -> PtauData:
    """Deterministic phase-1 transcript on the host: the toxic waste of
    setup.dev_setup, so derived keys can be held against it point for
    point.  Capacity 2^power (2*2^power - 1 G1 powers, like snarkjs
    powersoftau)."""
    tw = _derive_scalars(seed, ["tau", "alpha", "beta"])
    tau, alpha, beta = tw["tau"], tw["alpha"], tw["beta"]
    n = 1 << power
    taus = [pow(tau, i, P) for i in range(2 * n - 1)]
    return PtauData(
        power=power,
        tau_g1=native.g1_fixed_base_mul(taus),
        tau_g2=native.g2_fixed_base_mul(taus[:n]),
        alpha_tau_g1=native.g1_fixed_base_mul(
            [alpha * t % P for t in taus[:n]]),
        beta_tau_g1=native.g1_fixed_base_mul(
            [beta * t % P for t in taus[:n]]),
        beta_g2=native.g2_fixed_base_mul([beta])[0],
    )


PK_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
             "a_g1", "b_g1", "b_g2", "k_g1", "h_g1")


def verify_pk(pk, cs, ptau: PtauData | None = None,
              phase2_seed: bytes = b"zkfranchise-dev-setup",
              samples: int = 3, rng_seed: int = 0, device=None) -> bool:
    """The snarkjs `zkey verify` counterpart.

    With a ptau transcript: derives the key again from the powers and the
    R1CS (on `device`) and compares point for point.  Without one: pairing
    checks on the host, e(beta_g1, G2) == e(G1, beta_g2), e(delta_g1, G2)
    == e(G1, delta_g2) and e(b_g1[i], G2) == e(G1, b_g2[i]) for sampled
    wires, which bind the G1 and G2 halves of the key to the same
    scalars."""
    import random

    from ..ops import pairing

    if ptau is not None:
        pk2, _ = pk_from_ptau(ptau, cs, phase2_seed, device=device)
        return all(getattr(pk, f) == getattr(pk2, f) for f in PK_FIELDS)

    def same_scalar(p1, q2) -> bool:
        # e(p1, G2) == e(G1, q2)  <=>  e(p1, G2) * e(-G1, q2) == 1
        return pairing.multi_pairing_check(
            [(p1, ec.G2_GEN), (ec.G1.neg(ec.G1_GEN), q2)])

    if not same_scalar(pk.beta_g1, pk.beta_g2):
        return False
    if not same_scalar(pk.delta_g1, pk.delta_g2):
        return False
    rng = random.Random(rng_seed)
    idx = [i for i in range(len(pk.b_g1)) if pk.b_g1[i] is not None]
    for i in rng.sample(idx, min(samples, len(idx))):
        if (pk.b_g2[i] is None) or not same_scalar(pk.b_g1[i], pk.b_g2[i]):
            return False
    return True


# ---------------------------------------------------------------------------
# ptau -> proving key
# ---------------------------------------------------------------------------

def pk_from_ptau(ptau: PtauData, cs,
                 phase2_seed: bytes = b"zkfranchise-dev-setup",
                 device=None, seconds: dict | None = None
                 ) -> tuple[ProvingKey, VerifyingKey]:
    """Derive the whole proving key from the transcript's powers and the
    R1CS, with no toxic waste but the local phase-2 delta.  device: None
    (the card) or a CUDA device runs the plane route, "cpu" the native
    route.  seconds: filled on the plane route with the seconds of each
    step (conversions in and out, each EC-iNTT, the wire sums, the
    scalings), the device synchronised at each."""
    dev = devices.resolve(device)
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    # H needs tau^(n+i) for i < n: 2n G1 powers, so a transcript of power
    # p serves domains up to 2^(p-1)
    if len(ptau.tau_g1) < 2 * n:
        raise ValueError(f"ptau capacity too small: domain {n} needs "
                         f"{2 * n} G1 powers, the transcript has "
                         f"{len(ptau.tau_g1)}")
    if len(ptau.tau_g2) < n or len(ptau.alpha_tau_g1) < n or \
            len(ptau.beta_tau_g1) < n:
        raise ValueError("ptau capacity too small for the domain")
    delta = _derive_scalars(phase2_seed, ["delta"])["delta"]
    if dev.type == "cpu":
        tables = _tables_host(ptau, cs, n, delta)
    else:
        tables = _tables_planes(ptau, cs, n, delta, dev,
                                _StageClock(seconds, dev))
    return _assemble(ptau, cs, n, delta, *tables)


def _tables_host(ptau, cs, n, delta):
    m, npub = cs.num_vars, cs.num_public
    dinv = ff.inv_mod(delta, P)
    lag1 = _lagrange_host(ptau.tau_g1[:n], "g1")
    lag2 = _lagrange_host(ptau.tau_g2[:n], "g2")
    lag_a = _lagrange_host(ptau.alpha_tau_g1[:n], "g1")   # [alpha L_r]G1
    lag_b = _lagrange_host(ptau.beta_tau_g1[:n], "g1")    # [beta  L_r]G1
    ent = _entries(cs)
    a_g1 = _wire_combo(ent[0], lag1, "g1", m)
    b_g1 = _wire_combo(ent[1], lag1, "g1", m)
    b_g2 = _wire_combo(ent[1], lag2, "g2", m)
    # K_i = beta A_i + alpha B_i + C_i, via the alpha/beta power tables
    k_ba = _wire_combo(ent[0], lag_b, "g1", m)
    k_ab = _wire_combo(ent[1], lag_a, "g1", m)
    k_c = _wire_combo(ent[2], lag1, "g1", m)
    k_all = native.g1_add_batch(native.g1_add_batch(k_ba, k_ab), k_c)
    ic = k_all[:npub + 1]
    k_priv = native.g1_scale_batch([dinv] * (m - npub - 1),
                                   k_all[npub + 1:])
    # the H table in the coset-Lagrange layout (groth16/setup.py)
    s_inv = ff.inv_mod(poly.COSET_SHIFT, P)
    diff = native.g1_add_batch(
        ptau.tau_g1[n:2 * n],
        [_g1_neg(p) for p in ptau.tau_g1[:n]])       # [tau^(n+i) - tau^i]G1
    pre = native.g1_scale_batch([pow(s_inv, i, P) for i in range(n)], diff)
    h_lag = _lagrange_host(pre, "g1")                # [L^coset_j Z(tau)]G1
    h_g1 = native.g1_scale_batch([_h_scale(n, dinv)] * n, h_lag)
    return a_g1, b_g1, b_g2, ic, k_priv, h_g1


def _h_scale(n: int, dinv: int) -> int:
    sn1 = (pow(poly.COSET_SHIFT, n, P) - 1) % P
    return ff.inv_mod(sn1, P) * dinv % P


def _tables_planes(ptau, cs, n, delta, dev, clock):
    """The card route: each transcript table enters as a plane once, every
    EC batch runs on ec_batch, each key table leaves once."""
    m, npub = cs.num_vars, cs.num_public
    dinv = ff.inv_mod(delta, P)
    tau1 = ec_batch.to_plane(ptau.tau_g1[:2 * n], "g1", dev)
    tau2 = ec_batch.to_plane(ptau.tau_g2[:n], "g2", dev)
    alpha1 = ec_batch.to_plane(ptau.alpha_tau_g1[:n], "g1", dev)
    beta1 = ec_batch.to_plane(ptau.beta_tau_g1[:n], "g1", dev)
    ent = _entries(cs)
    clock.mark("convert_in")
    lag1 = _lagrange_plane(tau1[:, :n], "g1")
    clock.mark("intt_tau_g1")
    lag2 = _lagrange_plane(tau2, "g2")
    clock.mark("intt_tau_g2")
    lag_a = _lagrange_plane(alpha1, "g1")
    clock.mark("intt_alpha_tau_g1")
    lag_b = _lagrange_plane(beta1, "g1")
    clock.mark("intt_beta_tau_g1")
    del tau2, alpha1, beta1
    a_g1 = _wire_combo(ent[0], lag1, "g1", m)
    clock.mark("combo_a_g1")
    b_g1 = _wire_combo(ent[1], lag1, "g1", m)
    clock.mark("combo_b_g1")
    b_g2 = _wire_combo(ent[1], lag2, "g2", m)
    clock.mark("combo_b_g2")
    k_ba = _wire_combo(ent[0], lag_b, "g1", m)
    clock.mark("combo_k_ba")
    k_ab = _wire_combo(ent[1], lag_a, "g1", m)
    clock.mark("combo_k_ab")
    k_c = _wire_combo(ent[2], lag1, "g1", m)
    clock.mark("combo_k_c")
    del lag1, lag2, lag_a, lag_b
    k_all = K.padd(K.padd(k_ba, k_ab, "g1"), k_c, "g1")
    del k_ba, k_ab, k_c
    k_priv = ec_batch.scale_plane(k_all[:, npub + 1:], dinv, "g1")
    clock.mark("k_all_and_k_priv")
    s_inv = ff.inv_mod(poly.COSET_SHIFT, P)
    diff = K.padd(tau1[:, n:2 * n], ec_batch.neg_plane(tau1[:, :n], "g1"),
                  "g1")
    del tau1
    pre = ec_batch.scale_plane(diff, [pow(s_inv, i, P) for i in range(n)],
                               "g1")
    clock.mark("diff_and_pre")
    h_lag = _lagrange_plane(pre, "g1")
    clock.mark("intt_h")
    h_g1 = ec_batch.scale_plane(h_lag, _h_scale(n, dinv), "g1")
    clock.mark("h_scale")
    out = (ec_batch.to_affine(a_g1, "g1"), ec_batch.to_affine(b_g1, "g1"),
           ec_batch.to_affine(b_g2, "g2"),
           ec_batch.to_affine(k_all[:, :npub + 1], "g1"),
           ec_batch.to_affine(k_priv, "g1"), ec_batch.to_affine(h_g1, "g1"))
    clock.mark("convert_out")
    return out


def _assemble(ptau, cs, n, delta, a_g1, b_g1, b_g2, ic, k_priv, h_g1):
    alpha_g1 = ptau.alpha_tau_g1[0]
    beta_g1 = ptau.beta_tau_g1[0]
    beta_g2 = ptau.beta_g2
    delta_g1 = ec.g1_mul(delta)
    delta_g2 = ec.g2_mul(delta)
    vk = VerifyingKey({
        "protocol": "groth16", "curve": "bn128", "nPublic": cs.num_public,
        "vk_alpha_1": _g1j(alpha_g1),
        "vk_beta_2": _g2j(beta_g2),
        "vk_gamma_2": _g2j(ec.G2_GEN),
        "vk_delta_2": _g2j(delta_g2),
        "IC": [_g1j(x) for x in ic],
    })
    pk = ProvingKey(
        n_vars=cs.num_vars, n_public=cs.num_public, domain=n,
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        delta_g1=delta_g1, delta_g2=delta_g2,
        a_g1=a_g1, b_g1=b_g1, b_g2=b_g2, k_g1=k_priv, h_g1=h_g1,
    )
    return pk, vk

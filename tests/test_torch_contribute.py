"""The port's contribution protocol (groth16/contribute.py) against the
JAX package's, and the two repaired faults of the JAX verifiers.

Each package builds its chain once per module at power 4 on the CPU
route: dev ptau -> contribution A -> contribution B -> beacon (phase 1),
then a key from the contributed transcript -> two delta contributions ->
beacon (phase 2).  Tables, keys and hashes must be equal; the honest
chains verify; the tamper cases of tests/test_contribute.py are
rejected; and for each repaired fault a forged transcript that the JAX
verifier accepts is rejected by the port's.
"""
import dataclasses

import pytest
import torch

from zkfranchise_tpu.groth16 import ceremony as jcer
from zkfranchise_tpu.groth16 import contribute as jcon
from zkfranchise_tpu.models import r1cs as jr1cs
from zkfranchise_tpu_torch.groth16 import ceremony, contribute, qap
from zkfranchise_tpu_torch.models import r1cs
from zkfranchise_tpu_torch.ops import ec, ff

torch.set_num_threads(1)
P = ff.P_FR
PTAU_FIELDS = ("power", "tau_g1", "tau_g2", "alpha_tau_g1", "beta_tau_g1",
               "beta_g2")


def _tiny_cs(mod):
    cs = mod.ConstraintSystem(num_public=1)
    cs.alloc(4)          # wires 1 (public z), 2 (x), 3 (y), 4 (bit)
    cs.enforce(mod.lc((2, 1)), mod.lc((3, 1)), mod.lc((1, 1)))
    cs.enforce_bit(4)
    return cs


def _chains(cer, con, mod, **dev):
    """(phase-1 tables [p0..p3], links [c1..c3], phase-2 keys [pk0..pk3],
    links [d1..d3], cs)."""
    p0 = cer.dev_ptau(4)
    p1, c1 = con.phase1_contribute(p0, b"entropy-A", con.GENESIS, **dev)
    p2, c2 = con.phase1_contribute(p1, b"entropy-B", c1.new_hash, **dev)
    p3, c3 = con.phase1_beacon(p2, "00deadbeef", c2.new_hash, n_iters=64,
                               **dev)
    cs = _tiny_cs(mod)
    assert (1 << p3.power) >= 2 * qap.domain_size(cs.num_constraints, 1)
    pk0, _ = cer.pk_from_ptau(p3, cs, **dev)
    h0 = c3.new_hash                           # phase 2 chains onto 1
    pk1, d1 = con.phase2_contribute(pk0, b"delta-A", h0, **dev)
    pk2, d2 = con.phase2_contribute(pk1, b"delta-B", d1.new_hash, **dev)
    pk3, d3 = con.phase2_beacon(pk2, "00cafe", d2.new_hash, n_iters=64,
                                **dev)
    return [p0, p1, p2, p3], [c1, c2, c3], [pk0, pk1, pk2, pk3], \
        [d1, d2, d3], cs


@pytest.fixture(scope="module")
def port():
    return _chains(ceremony, contribute, r1cs, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return _chains(jcer, jcon, jr1cs)


def _same_links(a, b):
    assert a.prev_hash == b.prev_hash and a.new_hash == b.new_hash
    assert (a.is_beacon, a.beacon_hex, a.beacon_iters) == \
        (b.is_beacon, b.beacon_hex, b.beacon_iters)
    assert sorted(a.keys) == sorted(b.keys)
    for name in a.keys:
        assert dataclasses.asdict(a.keys[name]) == \
            dataclasses.asdict(b.keys[name])


def test_phase1_chain_equals_jax(port, ref):
    for a, b in zip(port[0], ref[0]):
        for f in PTAU_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    for a, b, p in zip(port[1], ref[1], port[0][1:]):
        _same_links(a, b)
        assert a.after == {"tau": p.tau_g1[1], "alpha": p.alpha_tau_g1[0],
                           "beta": p.beta_tau_g1[0]}


def test_phase2_chain_equals_jax(port, ref):
    for a, b in zip(port[2], ref[2]):
        for f in ceremony.PK_FIELDS + ("n_vars", "n_public", "domain"):
            assert getattr(a, f) == getattr(b, f), f
    for a, b, k in zip(port[3], ref[3], port[2][1:]):
        _same_links(a, b)
        assert a.after == {"delta": k.delta_g1}


def test_phase1_chain_verifies(port):
    ptaus, cons = port[0], port[1]
    assert contribute.verify_phase1_chain(ptaus[0], ptaus[3], cons,
                                          intermediate=ptaus[1:3])
    assert contribute.verify_phase1_chain(ptaus[0], ptaus[3], cons)


def test_phase1_tamper_rejected(port):
    (p0, p1, p2, p3), cons = port[0], port[1]
    mids = [p1, p2]
    # (a) swapped contribution order breaks the hash chain
    assert not contribute.verify_phase1_chain(
        p0, p3, [cons[1], cons[0], cons[2]], intermediate=mids)
    # (b) a replayed key under a different transcript position fails PoK
    bad = dataclasses.replace(
        cons[1], keys={**cons[1].keys, "tau": cons[0].keys["tau"]})
    assert not contribute.verify_phase1_chain(
        p0, p3, [cons[0], bad, cons[2]], intermediate=mids)
    # (c) a corrupted final table fails internal consistency
    p_bad = dataclasses.replace(
        p3, tau_g1=[p3.tau_g1[0], p3.tau_g1[1], p3.tau_g1[3],
                    p3.tau_g1[2]] + p3.tau_g1[4:])
    assert not contribute.verify_phase1_chain(p0, p_bad, cons,
                                              n_samples=14)
    # (d) a beacon lying about its public value is rejected
    fake = dataclasses.replace(cons[2], beacon_hex="1234")
    assert not contribute.verify_phase1_chain(
        p0, p3, [cons[0], cons[1], fake], intermediate=mids)


def test_phase1_intermediate_off_the_chain_rejected(port):
    """An intermediate transcript must hold its link's after-points."""
    (p0, p1, p2, p3), cons = port[0], port[1]
    assert not contribute.verify_phase1_chain(p0, p3, cons,
                                              intermediate=[p2, p1])


def test_phase1_forged_final_rejected_where_jax_accepts(port, ref):
    """The JAX verifier without intermediates never binds the final
    tables to the chain: a consistent transcript from other toxic waste
    passes it.  The port's walks the after-points and rejects it."""
    forged_ref = jcer.dev_ptau(4, seed=b"other")
    assert jcon.verify_phase1_chain(ref[0][0], forged_ref, ref[1])
    forged = ceremony.dev_ptau(4, seed=b"other")
    assert not contribute.verify_phase1_chain(port[0][0], forged, port[1])


def test_phase2_chain_verifies_and_tamper_rejected(port):
    pks, ds = port[2], port[3]
    h0 = port[1][-1].new_hash
    assert contribute.verify_phase2_chain(pks[0], pks[3], ds, h0)
    # a dropped link breaks the hash chain
    assert not contribute.verify_phase2_chain(pks[0], pks[3],
                                              [ds[0], ds[2]], h0)
    # a scaled C-table point breaks the table consistency
    bad_k = list(pks[3].k_g1)
    bad_k[0] = ec.G1.mul(3, bad_k[0])
    pk_bad = dataclasses.replace(pks[3], k_g1=bad_k)
    assert not contribute.verify_phase2_chain(pks[0], pk_bad, ds, h0,
                                              n_samples=len(bad_k))


def test_phase2_forged_delta_rejected_where_jax_accepts(port, ref):
    """The JAX verifier never links the final delta to the chain: a key
    rescaled by a secret the attacker knows, from the initial key, passes
    it with the honest links.  The port's walks delta_g1 through each
    link's after-point and rejects it."""
    h0 = ref[1][-1].new_hash
    pk_evil_ref, _ = jcon.phase2_contribute(ref[2][0], b"", h0,
                                            _secret=424242)
    assert jcon.verify_phase2_chain(ref[2][0], pk_evil_ref, ref[3], h0)
    pk_evil, _ = contribute.phase2_contribute(port[2][0], b"", h0,
                                              _secret=424242, device="cpu")
    assert not contribute.verify_phase2_chain(port[2][0], pk_evil, port[3],
                                              h0)


def test_contribute_defaults_to_the_card(port):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contribute.phase1_contribute(port[0][0], b"x", contribute.GENESIS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contribute.phase2_contribute(port[2][0], b"x", contribute.GENESIS)


@pytest.mark.slow
def test_ceremony_end_to_end_proves(port):
    """The final key of the contributed chains proves x*y = z on the host;
    the vk carries the final delta_g2."""
    from zkfranchise_tpu_torch.groth16 import prove as gprove
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify

    pks, cs = port[2], port[4]
    _, vk0 = ceremony.pk_from_ptau(port[0][3], cs, device="cpu")
    vk_dict = vk0.to_dict()
    vk_dict["vk_delta_2"] = gsetup._g2j(pks[3].delta_g2)
    vk = gverify.VerifyingKey(vk_dict)
    w = [1, 21, 3, 7, 1]                        # z = x*y, bit = 1
    assert cs.check_satisfied(w) is None
    proof = gprove.prove_host(pks[3], cs.constraints, w, r=123, s=456)
    assert gverify.verify(vk, proof, [21])
    assert not gverify.verify(vk, proof, [22])
    assert not gverify.verify(vk0, proof, [21])

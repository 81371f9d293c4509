"""The port's ceremony (ptau -> proving key) against the JAX package's.

The CPU route of zkfranchise_tpu_torch.groth16.ceremony runs the JAX
package's algorithm over the port's copy of native, so its outputs are
held point for point against the JAX functions.  The card route's
primitives (ops/ec_batch.py) run here on CPU tensors, through the plain
versions of scalar_mul and padd, at n = 8 (G1) and n = 4 (G2), against
native and the JAX ceremony._ec_ntt / _wire_combo.  The whole plane
route of pk_from_ptau on CPU tensors is marked slow (about a minute).
Every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import ceremony as jcer
from zkfranchise_tpu.models import r1cs as jr1cs
from zkfranchise_tpu.utils import native as jnative
from zkfranchise_tpu.utils import serialize as jser
from zkfranchise_tpu_torch.groth16 import ceremony, poly, qap, setup
from zkfranchise_tpu_torch.models import r1cs
from zkfranchise_tpu_torch.ops import ec, ec_batch, ff
from zkfranchise_tpu_torch.utils import native, serialize

torch.set_num_threads(1)
P = ff.P_FR
CPU = torch.device("cpu")


def _tiny_cs(mod):
    """x * y = z (public z) plus a bit constraint (tests/test_ceremony.py)."""
    cs = mod.ConstraintSystem(num_public=1)
    cs.alloc(4)
    cs.enforce(mod.lc((2, 1)), mod.lc((3, 1)), mod.lc((1, 1)))
    cs.enforce_bit(4)
    return cs


def _points(kind, n, seed, none_at=()):
    rng = random.Random(seed)
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    return [None if i in none_at else mul(rng.randrange(1, 1 << 62))
            for i in range(n)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ec_lagrange_cpu_route_matches_jax_and_scalar_oracle(kind):
    n = 16
    tau = 98765432123456789
    fixed = native.g1_fixed_base_mul if kind == "g1" else \
        native.g2_fixed_base_mul
    powers = fixed([pow(tau, i, P) for i in range(n)])
    port = ceremony.ec_lagrange_g1 if kind == "g1" else \
        ceremony.ec_lagrange_g2
    jax_fn = jcer.ec_lagrange_g1 if kind == "g1" else jcer.ec_lagrange_g2
    lag = port(powers, device="cpu")
    assert lag == fixed(poly.lagrange_evals_at(tau, n))
    assert lag == jax_fn(powers)


@pytest.mark.parametrize("kind,n", [("g1", 8), ("g2", 4)])
def test_ec_ntt_plane_matches_native_and_jax(kind, n):
    root = ff.inv_mod(poly.root_of_unity(n.bit_length() - 1), P)
    pts = _points(kind, n, seed=n, none_at=(1,))
    plane = ec_batch.to_plane(pts, kind, CPU)
    got = ec_batch.to_affine(ec_batch.ec_ntt_plane(plane, root, kind), kind)
    scale, add = ((jnative.g1_scale_batch, jnative.g1_add_batch)
                  if kind == "g1" else
                  (jnative.g2_scale_batch, jnative.g2_add_batch))
    neg = jcer._g1_neg if kind == "g1" else jcer._g2_neg
    assert got == jcer._ec_ntt(pts, root, scale, add, neg)
    # the port's host route is the same algorithm over the port's native
    tscale, tadd, tneg, _ = ceremony._HOST[kind]
    assert got == ceremony._ec_ntt(pts, root, tscale, tadd, tneg)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_segsum_plane_matches_native(kind):
    """A long segment, singletons, an odd-length segment, a None point,
    and ids with no entry (the identity: None)."""
    ids = [5, 0, 5, 2, 5, 5, 7, 2, 5, 5, 0, 5, 9, 5, 5]
    pts = _points(kind, len(ids), seed=3, none_at=(4,))
    segsum = native.g1_segsum if kind == "g1" else native.g2_segsum
    plane = ec_batch.to_plane(pts, kind, CPU)
    got = ec_batch.to_affine(ec_batch.segsum_plane(plane, ids, 11, kind),
                             kind)
    assert got == segsum(pts, ids, 11)
    assert got[1] is None and got[10] is None


def test_segsum_plan_pairs_each_segment():
    ids = np.array([3, 1, 3, 3, 1, 0, 3, 3, 3])
    rounds, order, seg = ec_batch.segsum_plan(ids)
    # the longest segment (id 3, six lanes) takes ceil(log2 6) = 3 rounds
    assert len(rounds) == 3
    assert sum(len(a) for a, _, _ in rounds) == len(ids) - 3
    assert seg.tolist() == [0, 1, 3] and len(order) == 3
    assert ec_batch.segsum_plan(np.array([4, 2]))[0] == []


def test_wire_combo_plane_matches_jax():
    """_wire_combo on a basis plane against the JAX one over native."""
    n, m = 8, 6
    basis = _points("g1", n, seed=5)
    rng = random.Random(9)
    entries = [(r, w, c) for r, w, c in (
        (0, 1, 1), (3, 1, P - 1), (2, 4, 7), (5, 4, rng.randrange(P)),
        (7, 4, 2), (1, 0, rng.randrange(1 << 40)), (6, 1, 3))]
    want = jcer._wire_combo(entries, basis, jnative.g1_segsum, m)
    rows, wires, coeffs = (np.array([e[0] for e in entries]),
                           np.array([e[1] for e in entries]),
                           [e[2] for e in entries])
    plane = ec_batch.to_plane(basis, "g1", CPU)
    got = ceremony._wire_combo((rows, wires, coeffs), plane, "g1", m)
    assert ec_batch.to_affine(got, "g1") == want
    host = ceremony._wire_combo((rows, wires, coeffs), basis, "g1", m)
    assert host == want
    assert host[2] is None and host[3] is None


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_scale_plane_per_lane_and_shared(kind):
    pts = _points(kind, 5, seed=11, none_at=(2,))
    scale = native.g1_scale_batch if kind == "g1" else native.g2_scale_batch
    plane = ec_batch.to_plane(pts, kind, CPU)
    scalars = [3, 0, 1 << 40, 12345, 1]
    got = ec_batch.to_affine(ec_batch.scale_plane(plane, scalars, kind),
                             kind)
    assert got == scale(scalars, pts)
    assert got[1] is None and got[2] is None
    got = ec_batch.to_affine(ec_batch.scale_plane(plane, 77, kind), kind)
    assert got == scale([77] * 5, pts)
    with pytest.raises(ValueError):
        ec_batch.scale_plane(plane, [1, 2], kind)


def test_scalar_bits_vectorised():
    rng = random.Random(4)
    xs = [0, 1, P - 1, rng.randrange(P), 1 << 200]
    bits = ec_batch.scalar_bits(xs)
    assert bits.shape == (254, 5) and bits.dtype == np.int32
    for t, x in enumerate(xs):
        assert bits[:, t].tolist() == [(x >> i) & 1 for i in range(254)]
    assert ec_batch.scalar_bits([0, 0]).shape == (1, 2)
    assert ec_batch.scalar_bits([5], nbits=8)[:, 0].tolist() == \
        [1, 0, 1, 0, 0, 0, 0, 0]
    assert ec_batch.shared_bits(6).tolist() == [0, 1, 1]


def test_dev_ptau_and_write_ptau_bytes_equal_jax():
    port = ceremony.dev_ptau(3)
    ref = jcer.dev_ptau(3)
    data = serialize.write_ptau(port)
    assert data == jser.write_ptau(ref)
    back = serialize.read_ptau(data)
    assert back.tau_g1 == ref.tau_g1 and back.beta_g2 == ref.beta_g2
    assert ceremony.dev_ptau(3, seed=b"x").tau_g1 != port.tau_g1


def _assert_key_equal(pk, vk, pkj, vkj):
    for f in ceremony.PK_FIELDS + ("n_vars", "n_public", "domain"):
        assert getattr(pk, f) == getattr(pkj, f), f
    assert vk.to_dict() == vkj.to_dict()


def test_pk_from_ptau_cpu_route_equals_jax_and_dev_setup():
    cs = _tiny_cs(r1cs)
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    ptau = serialize.read_ptau(serialize.write_ptau(
        ceremony.dev_ptau(n.bit_length())))
    pk, vk = ceremony.pk_from_ptau(ptau, cs, device="cpu")
    pkj, vkj = jcer.pk_from_ptau(jcer.dev_ptau(n.bit_length()),
                                 _tiny_cs(jr1cs))
    _assert_key_equal(pk, vk, pkj, vkj)
    _assert_key_equal(pk, vk, *setup.dev_setup(cs))
    assert ceremony.verify_pk(pk, cs, ptau=ptau, device="cpu")
    assert ceremony.verify_pk(pk, cs)
    bad = setup.ProvingKey(**{**pk.__dict__})
    bad.beta_g1 = ec.g1_mul(999)
    assert not ceremony.verify_pk(bad, cs)
    assert not ceremony.verify_pk(bad, cs, ptau=ptau, device="cpu")


def test_pk_from_ptau_refuses_a_transcript_at_the_domain_size():
    """H needs tau^(n+i) for i < n: 2n G1 powers, one more than a
    transcript of power log2(n) holds (the JAX package's derivation
    fails there with an IndexError)."""
    cs = _tiny_cs(r1cs)
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    with pytest.raises(ValueError, match="capacity"):
        ceremony.pk_from_ptau(ceremony.dev_ptau(n.bit_length() - 1), cs,
                              device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cs = _tiny_cs(r1cs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ceremony.pk_from_ptau(ceremony.dev_ptau(3), cs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ceremony.ec_lagrange_g1(_points("g1", 4, seed=1))


@pytest.mark.slow
def test_pk_from_ptau_plane_route_on_cpu_tensors_equals_jax():
    """The card route's code on CPU tensors (plain scalar_mul and padd):
    the same key, point for point."""
    cs = _tiny_cs(r1cs)
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    ptau = ceremony.dev_ptau(n.bit_length())
    delta = setup._derive_scalars(b"zkfranchise-dev-setup",
                                  ["delta"])["delta"]
    seconds = {}
    tables = ceremony._tables_planes(ptau, cs, n, delta, CPU,
                                     ceremony._StageClock(seconds, CPU))
    pk, vk = ceremony._assemble(ptau, cs, n, delta, *tables)
    pkj, vkj = jcer.pk_from_ptau(jcer.dev_ptau(n.bit_length()),
                                 _tiny_cs(jr1cs))
    _assert_key_equal(pk, vk, pkj, vkj)
    assert set(seconds) >= {"convert_in", "intt_tau_g1", "intt_h",
                            "convert_out"}

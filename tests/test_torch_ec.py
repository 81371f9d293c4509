"""Port EC planes (ops/ec_lm.py, ops/ec_affine.py and the EC kernel
wrappers' plain versions) against the JAX package on the same points."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfranchise_tpu.ops import ec_affine as jaff
from zkfranchise_tpu.ops import ec_lm as jec
from zkfranchise_tpu.ops.pallas import lm_kernels as JK
from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, msm_lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

RNG = np.random.default_rng(5)
N = 8


def _pool(kind):
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    return [mul(int(k)) for k in RNG.integers(1, 1 << 40, size=N)]


def _planes(kind):
    """(p, q) (2, rows, N) projective planes with identity, doubling and
    P + (-P) lanes, built through the JAX package's own padd so that Z is
    not 1 and limbs are redundant."""
    table = jec.g1_table if kind == "g1" else jec.g2_table
    padd = jec.padd_g1 if kind == "g1" else jec.padd_g2
    a, b, c, d = (jnp.asarray(np.stack([table(_pool(kind)).T] * 2))
                  for _ in range(4))
    p = np.array(padd(a, b))
    q = np.array(padd(c, d))
    q[..., 1:2] = msm_lm._neg_plane(torch.as_tensor(p[..., 1:2]),
                                    kind).numpy()
    q[..., 2] = p[..., 2]
    p[..., 3] = jec.g1_identity_plane((2,), 1)[..., 0] if kind == "g1" \
        else jec.g2_identity_plane((2,), 1)[..., 0]
    q[..., 4] = p[..., 3]
    q[..., 3] = p[..., 3]
    return p, q


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_padd_and_fold_match_jax(kind):
    p, q = _planes(kind)
    padd = jec.padd_g1 if kind == "g1" else jec.padd_g2
    want = padd(jnp.asarray(p), jnp.asarray(q))
    assert _eq(want, K.padd(torch.as_tensor(p), torch.as_tensor(q), kind))
    assert _eq(want, K.padd_ref(torch.as_tensor(p), torch.as_tensor(q),
                                kind))
    x = np.concatenate([p, q], -1)
    assert _eq(JK.fold_padd(jnp.asarray(x), kind),
               K.fold_padd(torch.as_tensor(x), kind))
    affine = (ec_lm.g1_plane_to_affine if kind == "g1"
              else ec_lm.g2_plane_to_affine)
    grp = ec.G1 if kind == "g1" else ec.G2
    got = affine(K.padd(torch.as_tensor(p[0]), torch.as_tensor(q[0]), kind))
    want_pts = [grp.add(u, v) for u, v in zip(affine(torch.as_tensor(p[0])),
                                               affine(torch.as_tensor(q[0])))]
    assert got == want_pts


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_padd_aa_and_fold_match_jax(kind):
    pts = _pool(kind)
    pts[2] = None
    pts[5] = None
    table = ec_affine.affine_table(pts, kind)
    assert np.array_equal(table, jaff.affine_table(pts, kind))
    half = table.T[None]                                  # (1, arows, N)
    neg = ec_affine.neg_affine(torch.as_tensor(half), kind).numpy()
    assert _eq(jaff.neg_affine(jnp.asarray(half), kind),
               torch.as_tensor(neg))
    other = half[..., ::-1].copy()
    other[..., 0] = neg[..., 0]                           # P + (-P)
    other[..., 1] = half[..., 1]                          # doubling
    other[..., 2] = half[..., 2]                          # inf + inf
    x = np.concatenate([half, other], -1)
    want = jec.padd_aa(jnp.asarray(half), jnp.asarray(other), kind)
    assert _eq(want, K.fold_padd_aa(torch.as_tensor(x), kind))
    assert _eq(JK.fold_padd_aa(jnp.asarray(x), kind),
               K.fold_padd_aa_ref(torch.as_tensor(x), kind))
    assert _eq(jaff.to_projective(jnp.asarray(half), kind),
               ec_affine.to_projective(torch.as_tensor(half), kind))


def test_identity_planes_and_tables():
    pts = _pool("g1")[:3] + [None]
    assert np.array_equal(ec_lm.g1_table(pts), jec.g1_table(pts))
    pts2 = _pool("g2")[:3] + [None]
    assert np.array_equal(ec_lm.g2_table(pts2), jec.g2_table(pts2))
    for kind in ("g1", "g2"):
        assert np.array_equal(
            ec_lm.identity_plane(kind, (2,), 3, "cpu").numpy(),
            JK.identity_plane(kind, (2,), 3))
        assert np.array_equal(ec_affine.identity_rows(kind, 3),
                              jaff.identity_rows(kind, 3))
    assert np.array_equal(ec_lm.pack_ec_consts()[:, 0],
                          jec.pack_ec_consts(1)[:, 0])


def test_wrappers_reject_bad_shapes():
    x = torch.zeros((2, 63, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.padd(x, x, "g3")
    with pytest.raises(TypeError):
        K.fold_padd(x.long(), "g1")

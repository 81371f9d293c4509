"""The assembly's double-and-add on the port (scalar_mul with a scalar per
lane, plain version and dispatcher on CPU tensors) and the port's
assemble_stage against the JAX package.  Exact comparisons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import device as jdevice
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.ops import ec, ec_lm, ff, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)


def _plane(kind: str, n: int, rng) -> np.ndarray:
    """(rows, n) projective plane of real points with Z != 1 (sums of two
    multiples of the generator), the identity in lane 1."""
    mul, table = (ec.g1_mul, ec_lm.g1_table) if kind == "g1" else \
        (ec.g2_mul, ec_lm.g2_table)
    pts = [mul(int(k)) for k in rng.integers(1, 1 << 40, size=2 * n)]
    proj = torch.as_tensor(np.ascontiguousarray(table(pts).T))
    out = K.padd_ref(proj[:, :n], proj[:, n:], kind)
    out[:, 1:2] = ec_lm.identity_plane(kind, (), 1, "cpu")
    return out.numpy()


def _scalars(n: int, rng) -> np.ndarray:
    """(21, n) plain limbs of random scalars below p."""
    return lm.ints_to_lm([int.from_bytes(rng.bytes(32), "big") % ff.P_FR
                          for _ in range(n)])


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_scalar_mul_ref_per_lane_bits_matches_jax(kind):
    """Three lanes, a 64-bit scalar each (lane 2's is all zeros)."""
    rng = np.random.default_rng(3 if kind == "g1" else 4)
    pts = _plane(kind, 3, rng)
    bits = rng.integers(0, 2, size=(64, 3)).astype(np.int32)
    bits[:, 2] = 0
    got = tdevice.scalar_mul_plane(torch.as_tensor(pts),
                                   torch.as_tensor(bits), kind)
    want = jax.jit(jdevice.scalar_mul_plane, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(bits), kind)
    assert np.array_equal(np.asarray(want), got.numpy())
    # the dispatcher on CPU tensors is the plain version, with no launch
    K.reset_launches()
    assert torch.equal(K.scalar_mul(torch.as_tensor(pts),
                                    torch.as_tensor(bits), kind), got)
    assert not any(K.LAUNCHES.values())
    # one scalar for all lanes equals the same scalar given per lane
    shared = torch.as_tensor(bits[:, 0])
    assert torch.equal(
        K.scalar_mul_ref(torch.as_tensor(pts), shared, kind),
        K.scalar_mul_ref(torch.as_tensor(pts),
                         shared[:, None].expand(64, 3), kind))


def test_assemble_stage_matches_jax():
    """Two voters: pi_a, pi_b and pi_c from random MSM outputs, alpha,
    beta, and 254-bit r and s."""
    rng = np.random.default_rng(11)
    B = 2
    g1 = _plane("g1", 2 * B + 2, rng)
    g2 = _plane("g2", B + 1, rng)

    def rows_first(x):                          # (rows, B) -> (B, rows, 1)
        return np.ascontiguousarray(x.T[:, :, None])

    args = [rows_first(g1[:, :B]), rows_first(g1[:, B:2 * B]),
            rows_first(g2[:, :B]), rows_first(g1[:, 1:B + 1]),
            _scalars(B, rng), _scalars(B, rng),
            g1[:, 2 * B:2 * B + 1], g1[:, 2 * B + 1:], g2[:, B:]]
    got = tdevice.assemble_stage(*(torch.as_tensor(a) for a in args))
    want = jax.jit(jdevice.assemble_stage)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_scalar_mul_rejects_bad_bit_shapes():
    pts = torch.as_tensor(_plane("g1", 3, np.random.default_rng(5)))
    for shape in [(8, 4), (8, 3, 1), ()]:
        with pytest.raises(ValueError):
            K.scalar_mul(pts, torch.zeros(shape, dtype=torch.int32), "g1")
        with pytest.raises(ValueError):
            K.scalar_mul_ref(pts, torch.zeros(shape, dtype=torch.int32),
                             "g1")

"""The port's model-sharded MSM (parallel/prove.py _sharded_msm: each rank
runs the MSM of its table slice, the partials are all-gathered and added
in a tree) on 2 and 4 gloo ranks on the CPU against the JAX package's
_sharded_msm under shard_map on the virtual CPU devices, G1 and G2, in
projective limbs; and the tree reduction at odd counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from zkfranchise_tpu.parallel import prove as jprove
from zkfranchise_tpu_torch.ops import ec, ec_affine, lm
from zkfranchise_tpu_torch.parallel import jobs, launch
from zkfranchise_tpu_torch.parallel import prove as tprove

torch.set_num_threads(1)

N_POINTS, B = 64, 2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    tables = {}
    for kind, group, gen in (("g1", ec.G1, ec.G1_GEN),
                             ("g2", ec.G2, ec.G2_GEN)):
        pts = [group.mul(int(k), gen)
               for k in rng.integers(1, 1 << 40, N_POINTS)]
        tables[kind] = ec_affine.affine_table(pts, kind)
    scalars = np.stack([lm.ints_to_lm(
        [int.from_bytes(rng.bytes(31), "big") for _ in range(B)])
        for _ in range(N_POINTS)])                      # (64, 21, B) plain
    return scalars, tables


def _jax_sharded_msm(scalars, table, kind, nm):
    mesh = Mesh(np.asarray(jax.devices()[:nm]), ("model",))
    fn = shard_map(
        lambda sc, tab: jprove._sharded_msm(sc, tab, kind, N_POINTS // nm,
                                            "model"),
        mesh=mesh, in_specs=(P(), P("model", None)), out_specs=P(),
        check_rep=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(scalars), jnp.asarray(table)))


@pytest.mark.parametrize("nm", [2, 4])
def test_sharded_msm_matches_jax(inputs, nm):
    if len(jax.devices()) < nm:
        pytest.skip("needs the conftest's virtual CPU devices")
    scalars, tables = inputs
    res = launch.run(jobs.msm_job, nm, backend="gloo",
                     args=(scalars, tables, "cpu"), timeout_s=200)
    for kind, table in tables.items():
        want = _jax_sharded_msm(scalars, table, kind, nm)
        for rank, got in enumerate(res):
            assert got[kind].shape == want.shape
            assert np.array_equal(got[kind], want), (kind, rank)


@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_tree_reduce_axis0_matches_jax(inputs, kind, S):
    """Gather order, pairwise adds, an identity pad on odd counts."""
    _, tables = inputs
    pts = ec_affine.to_projective(
        torch.as_tensor(tables[kind][:S * B]).reshape(S, B, -1, 1), kind)
    got = tprove._tree_reduce_axis0(pts, kind)
    want = jprove._tree_reduce_axis0(jnp.asarray(pts.numpy()), kind)
    assert np.array_equal(got.numpy(), np.asarray(want))

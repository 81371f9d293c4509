"""The port's domain-sharded NTT (ops/ntt_dist.py) against the JAX
package's: the plan's tables, and intt_dist / ntt_dist /
coset_evals_dist with unstride on 2, 4 and 8 gloo ranks on the CPU
against the JAX functions under shard_map on the virtual CPU devices and
against the port's local ntt.  Exact equality throughout."""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from zkfranchise_tpu.ops import ntt_dist as jntt_dist
from zkfranchise_tpu_torch.ops import ntt_dist
from zkfranchise_tpu_torch.parallel import jobs, launch

torch.set_num_threads(1)

LOG_N, T = 6, 4


@pytest.mark.parametrize("nm", [2, 4, 8])
def test_plan_tables_match_jax(nm):
    want = jntt_dist.DistNTTPlan(LOG_N, nm)
    got = ntt_dist.DistNTTPlan(LOG_N, nm)
    assert (got.n, got.nm, got.b, got.log_b) == \
        (want.n, want.nm, want.b, want.log_b)
    for name in ("m_fwd", "m_inv", "tw_inv", "tw_fwd", "shift_strided",
                 "shift_inv_strided"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    # a rank's device tables are its slices
    for i in range(nm):
        on = got.on("cpu", i)
        assert np.array_equal(on["tw_inv"].numpy(), want.tw_inv[i])
        assert np.array_equal(on["tw_fwd"].numpy(), want.tw_fwd[i])
        assert np.array_equal(on["shift"].numpy(), want.shift_strided[i])


def _jax_pipeline(x: np.ndarray, nm: int):
    """The JAX functions under shard_map on nm virtual devices -> (natural
    coefficients, ntt_dist of them, coset evals), numpy."""
    plan = jntt_dist.DistNTTPlan(LOG_N, nm)
    mesh = Mesh(np.asarray(jax.devices()[:nm]), ("model",))

    def pipeline(xl):
        co = jntt_dist.intt_dist(xl, "model", plan)
        natural = jntt_dist.unstride(jax.lax.all_gather(co, "model"), nm)
        return (natural, jntt_dist.ntt_dist(co, "model", plan),
                jntt_dist.coset_evals_dist(xl, "model", plan))

    fn = shard_map(pipeline, mesh=mesh, in_specs=(P("model"),),
                   out_specs=(P(None), P("model"), P("model")),
                   check_rep=False)
    return [np.asarray(a) for a in jax.jit(fn)(x)]


@pytest.mark.parametrize("nm", [2, 4, 8])
def test_dist_ntt_matches_jax_and_local(nm):
    if len(jax.devices()) < nm:
        pytest.skip("needs the conftest's virtual CPU devices")
    x = jobs.random_plane(1 << LOG_N, T, 9 + nm)
    res = launch.run(jobs.ntt_job, nm, backend="gloo",
                     args=(x, LOG_N, "cpu", True), timeout_s=150)
    got = res[0]
    # the port's own check against its local ntt on rank 0
    assert got["inverse_equal"] and got["roundtrip_equal"] \
        and got["coset_equal"]
    assert not got["staged_through_host"]
    inverse, roundtrip, coset = _jax_pipeline(x, nm)
    assert np.array_equal(got["inverse"], inverse)
    assert np.array_equal(got["roundtrip"], roundtrip)
    assert np.array_equal(got["coset"], coset)


def test_unstride_order():
    g = torch.arange(4 * 3).reshape(4, 3)          # 4 shards of 3 rows
    want = np.asarray(jntt_dist.unstride(np.arange(12).reshape(4, 3), 4))
    assert np.array_equal(ntt_dist.unstride(g, 4).numpy(), want)


def test_plan_refuses_bad_sizes():
    with pytest.raises(ValueError):
        ntt_dist.DistNTTPlan(3, 4)                 # nm^2 > n
    with pytest.raises(ValueError):
        ntt_dist.DistNTTPlan(6, 3)                 # not a power of two

"""Port MSM (ops/msm_lm.py) against the JAX package's msm_lm.msm and the
host Pippenger (groth16/prove.pippenger_host) at the sizes of
tests/test_msm_lm.py: m = 128, 130, 160 and 256, G1 and G2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import prove as jprove
from zkfranchise_tpu.ops import ec as jec
from zkfranchise_tpu.ops import msm_lm as jmsm
from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, ff, lm, msm_lm

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

RNG = np.random.default_rng(3)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_msm(sc, table, kind):
    return jmsm.msm(sc, table, kind)


def _case(n, kind, b=1):
    scal = [[int.from_bytes(RNG.bytes(32), "big") % ff.P_FR
             for _ in range(n)] for _ in range(b)]
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    pts = [mul(j + 3) for j in range(n)]
    pts[n // 3] = None
    sc = np.stack([lm.ints_to_lm([scal[j][i] for j in range(b)])
                   for i in range(n)])                     # (n, 21, b)
    return scal, pts, sc, ec_affine.affine_table(pts, kind)


@pytest.mark.parametrize("n,kind", [(128, "g1"), (160, "g1"), (256, "g1"),
                                    (130, "g2")])
def test_msm_matches_jax_and_host(n, kind):
    scal, pts, sc, table = _case(n, kind)
    out = msm_lm.msm(torch.as_tensor(sc), torch.as_tensor(table), kind)
    want = _jax_msm(jnp.asarray(sc), jnp.asarray(table), kind)
    assert np.array_equal(np.asarray(want), out.numpy())
    plane = out[..., 0].transpose(0, 1)
    affine = (ec_lm.g1_plane_to_affine if kind == "g1"
              else ec_lm.g2_plane_to_affine)
    grp = jec.G1 if kind == "g1" else jec.G2
    assert affine(plane) == [jprove.pippenger_host(row, pts, grp)
                             for row in scal]


def test_msm_small_chunks_and_window_groups(monkeypatch):
    """Two chunks (the small-tree path) and window groups of 8 give the
    same result as one group."""
    monkeypatch.setattr(msm_lm, "MIN_CHUNK", 4)
    assert msm_lm._chunks(9) == [(0, 8, 8), (8, 1, 1)]
    scal, pts, sc, table = _case(9, "g1", b=2)
    sc_t, tab_t = torch.as_tensor(sc), torch.as_tensor(table)
    out = msm_lm.msm(sc_t, tab_t, "g1")
    assert torch.equal(msm_lm.msm(sc_t, tab_t, "g1", window_group=8), out)
    got = ec_lm.g1_plane_to_affine(out[..., 0].transpose(0, 1))
    assert got == [ec.msm_host(row, pts, ec.G1) for row in scal]


def test_default_window_group_caps():
    assert msm_lm.default_window_group(32768, 128, "cpu") == 32
    assert msm_lm.default_window_group(32768, 128, "cuda") == 1
    assert msm_lm.default_window_group(8192, 16, "cuda") == 8
    assert msm_lm.default_window_group(2048, 64, "cuda") == 2

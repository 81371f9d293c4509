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


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_chunk(sc, table, kind):
    return jmsm.chunk_window_sums(sc, table, kind)


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("chunk", [0, 1])
def test_chunk_window_sums_on_the_prebuilt_table_equals_the_plane_path(
        monkeypatch, kind, chunk):
    """A chunk's window sums from its [P | -P] rows built once
    (extend_table, read through the sort's index) equal, limb for limb,
    the JAX package's, which gathers the fold-order plane.  300 points
    split into a chunk of 256 and one of 44 padded to 64 (the small-tree
    path); random scalars mix signed digits of both signs, and one point
    is the identity."""
    monkeypatch.setattr(msm_lm, "MIN_CHUNK", 4)
    _, _, sc, table = _case(300, kind, b=2)
    sc_t, tab_t = torch.as_tensor(sc), torch.as_tensor(table)
    chunks = msm_lm.plan(tab_t, kind)
    assert [c[:3] for c in chunks] == [(0, 256, 256), (256, 44, 64)]
    start, real, m, ext = chunks[chunk]
    s, tab = msm_lm.pad_chunk(sc_t, tab_t, start, real, m, kind)
    assert torch.equal(ext, msm_lm.extend_table(tab, kind))
    got = msm_lm.chunk_window_sums(s, ext, kind)
    want = _jax_chunk(jnp.asarray(s.numpy()), jnp.asarray(tab.numpy()), kind)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_device_prover_msm_equals_msm_at_small_chunk_sizes():
    """DeviceProver._msm over its tables planned once equals the JAX
    package's msm on the same tables, limb for limb, at the small-tree
    sizes (A 41 points -> a chunk of 64, B1 and B2 21 of them (one wire
    compacted away) -> 32) and at one chunk of exactly 128 (C, 101
    points)."""
    from zkfranchise_tpu_torch.groth16 import qap
    from zkfranchise_tpu_torch.groth16 import setup as tsetup
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit

    circuit = CensusCircuit(4)
    cs = circuit.cs
    g1 = [ec.g1_mul(k + 5) for k in range(110)]
    g2 = [ec.g2_mul(k + 7) for k in range(21)]
    b_g1, b_g2 = g1[40:61], g2[:]
    b_g1[3] = b_g2[3] = None
    pk = tsetup.ProvingKey(
        n_vars=cs.num_vars, n_public=cs.num_public,
        domain=qap.domain_size(cs.num_constraints, cs.num_public),
        alpha_g1=g1[0], beta_g1=g1[1], beta_g2=g2[0], delta_g1=g1[2],
        delta_g2=g2[1], a_g1=g1[:40], b_g1=b_g1, b_g2=b_g2,
        k_g1=g1[:60], h_g1=g1[60:100])
    prover = DeviceProver(circuit, pk, device="cpu")
    tables = {"a": (prover.a_tab, "g1"), "b1": (prover.b1_tab, "g1"),
              "b2": (prover.b2_tab, "g2"), "c": (prover.c_tab, "g1")}
    assert {k: t.shape[0] for k, (t, _) in tables.items()} == \
        {"a": 41, "b1": 21, "b2": 21, "c": 101}
    rng = np.random.default_rng(21)
    for key, (tab, kind) in tables.items():
        n = tab.shape[0]
        sc = torch.as_tensor(np.stack([lm.ints_to_lm(
            [int.from_bytes(rng.bytes(32), "big") % ff.P_FR])
            for _ in range(n)]))
        want = _jax_msm(jnp.asarray(sc.numpy()), jnp.asarray(tab.numpy()),
                        kind)
        assert np.array_equal(np.asarray(want), prover._msm(sc, key).numpy())

"""Port quotient stage (ops/sparse.py, ops/ntt.py, groth16/device.py
quotient_stage) against the JAX package on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import device as jdevice
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu.ops import ntt as jntt
from zkfranchise_tpu.ops import sparse as jsparse
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import poly, qap
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import ff, lm, ntt, sparse

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

RNG = np.random.default_rng(21)
P = ff.P_FR


def _mont_plane(n, T):
    vals = [int.from_bytes(RNG.bytes(32), "big") % P for _ in range(n * T)]
    plain = np.ascontiguousarray(
        np.moveaxis(lm.ints_to_lm(vals).reshape(21, n, T), 0, 1))
    return lm.to_mont(torch.as_tensor(plain))


def _sparse(nnz, n_rows, n_cols):
    rows = np.sort(RNG.integers(0, n_rows, size=nnz)).astype(np.int32)
    cols = RNG.integers(0, n_cols, size=nnz).astype(np.int32)
    coeffs = [int.from_bytes(RNG.bytes(32), "big") % P for _ in range(nnz)]
    cm = np.asarray(lm.ints_to_lm([c * lm.FR.r_mod_p % P for c in coeffs]),
                    np.int32).T[:, :, None]
    return rows, cols, cm


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_spmv_matches_jax(monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(sparse, "MAX_NNZ_CHUNK", chunk)
        monkeypatch.setattr(jsparse, "MAX_NNZ_CHUNK", chunk)
    rows, cols, cm = _sparse(300, 40, 30)
    w = _mont_plane(30, 3)
    got = sparse.spmv(torch.as_tensor(rows).long(), torch.as_tensor(cols).long(),
                      torch.as_tensor(cm), 40, w)
    want = jsparse.spmv(rows, cols, cm, 40, jnp.asarray(w.numpy()))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_ntt_matches_jax_and_host():
    x = _mont_plane(32, 3)
    xj = jnp.asarray(x.numpy())
    fwd = ntt.ntt(x)
    assert np.array_equal(np.asarray(jax.jit(jntt.ntt)(xj)), fwd.numpy())
    inv = ntt.ntt(fwd, inverse=True)
    assert np.array_equal(
        np.asarray(jax.jit(lambda v: jntt.ntt(v, inverse=True))(
            jnp.asarray(fwd.numpy()))), inv.numpy())
    assert torch.equal(lm.from_mont(inv), lm.from_mont(x))
    cos = ntt.coset_evals_from_domain_evals(x)
    assert np.array_equal(
        np.asarray(jax.jit(jntt.coset_evals_from_domain_evals)(xj)),
        cos.numpy())
    col = lm.lm_to_ints(lm.from_mont(x[..., :1]))
    assert lm.lm_to_ints(lm.from_mont(fwd[..., :1])) == poly.ntt(col)
    assert lm.lm_to_ints(lm.from_mont(cos[..., :1])) == \
        poly.coset_evals_from_domain_evals(col)


def test_quotient_stage_matches_jax():
    circuit = CensusCircuit(4)
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(4, 2, seed=1, device="cpu"), 4)
    w = circuit.witness({k: torch.as_tensor(v) for k, v in arrs.items()})
    cs = circuit.cs
    arrays = cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public))
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    dev_arrays = {k: (torch.as_tensor(arrays[k][0]).long(),
                      torch.as_tensor(arrays[k][1]).long(),
                      torch.as_tensor(arrays[k][2])) for k in "abc"}
    q = tdevice.quotient_stage(dev_arrays, n, w)
    jarrays = JaxCircuit(4).cs.export_arrays(
        extra_rows=qap.binding_rows(cs.num_public))
    want = jax.jit(lambda v: jdevice.quotient_stage(jarrays, n, v))(
        jnp.asarray(w.numpy()))
    assert q.shape == (n, 21, 2)
    assert np.array_equal(np.asarray(want), q.numpy())
    # the A/B-only branch (keys without a C matrix) gives the same quotient
    ab = {k: dev_arrays[k] for k in "ab"}
    assert torch.equal(tdevice.quotient_stage(ab, n, w), q)

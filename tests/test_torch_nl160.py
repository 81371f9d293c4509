"""nlevels=160, the package's default configuration, against the JAX
package on the CPU: the R1CS export (rows, columns and coefficients of A,
B and C), the mock batch's arrays, and the chunked sparse.spmv at the 160
A and B matrices on a seeded Montgomery witness.  Exact comparisons.

(The witness at 160 is left out here: the JAX one takes about 30 s on the
CPU, the port's plain versions about 200 s; the proofs that verify against
the committed dev/160 key on the card cover it there.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu import inputs as jinputs
from zkfranchise_tpu.groth16 import qap as jqap
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu.ops import sparse as jsparse
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import qap
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import sparse

# one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

NL = 160
# (wires, constraints, domain) and the nonzeros with the binding rows
SIZES = (81572, 81721, 1 << 17)
NNZ = {"a": 763434, "b": 1420148, "c": 80415}


@pytest.fixture(scope="module")
def exports():
    """(port arrays, JAX arrays, port constraint system) at nlevels=160."""
    cs = CensusCircuit(NL).cs
    jcs = JaxCircuit(NL).cs
    return (cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public)),
            jcs.export_arrays(extra_rows=jqap.binding_rows(jcs.num_public)),
            cs)


def test_export_arrays_equal_jax(exports):
    got, want, cs = exports
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    assert (cs.num_vars, cs.num_constraints, n) == SIZES
    assert got["num_constraints"] == cs.num_constraints + \
        len(qap.binding_rows(cs.num_public))
    for key in ("num_constraints", "num_vars", "num_public"):
        assert got[key] == want[key]
    for k in "abc":
        assert int(got[k][0].shape[0]) == NNZ[k]
        for g, w in zip(got[k], want[k]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)


def test_mock_batch_arrays_equal_jax():
    got = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, 2, seed=7, device="cpu"), NL)
    want = jinputs.batch_to_arrays(jinputs.mock_batch(NL, 2, seed=7), NL)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert got["censusSiblings"].shape == (NL + 1, 21, 2)


@pytest.mark.parametrize("matrix", ["a", "b"])
def test_chunked_spmv_equals_jax(exports, matrix):
    """A (6 chunks) and B (11 chunks) pass 2 * MAX_NNZ_CHUNK: the chunked
    branch, each chunk padded and summed into a fresh accumulator."""
    got_arrays, jarrays, cs = exports
    rows, cols, coeffs = got_arrays[matrix]
    assert rows.shape[0] > 2 * sparse.MAX_NNZ_CHUNK
    n = SIZES[2]
    rng = np.random.default_rng(160)
    w = rng.integers(0, 1 << 13, size=(cs.num_vars, 21, 2), dtype=np.int32)
    w[:, 19] &= 0x7F
    w[:, 20] = 0
    got = sparse.spmv(torch.as_tensor(rows).long(),
                      torch.as_tensor(cols).long(),
                      torch.as_tensor(np.ascontiguousarray(coeffs)), n,
                      torch.as_tensor(w))
    want = jax.jit(lambda v: jsparse.spmv(*jarrays[matrix], n, v))(
        jnp.asarray(w))
    assert got.shape == (n, 21, 2)
    assert np.array_equal(np.asarray(want), got.numpy())

"""The Poseidon permutation of the port (plain versions, and the
dispatcher on CPU tensors) against the JAX package: the witness's hash with
its S-box trace and the bare permutation, at widths 3, 4 and 5.  Integer
arithmetic throughout: exact comparisons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.models import census as jcensus
from zkfranchise_tpu.ops import poseidon as jposeidon
from zkfranchise_tpu_torch.models import census
from zkfranchise_tpu_torch.ops import ff, lm, poseidon
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)


def _mont_inputs(k: int, T: int, seed: int) -> np.ndarray:
    """(k, 21, T) Montgomery limbs of random field elements (a zero lane
    among them)."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(32), "big") % ff.P_FR
             for _ in range(T)] for _ in range(k)]
    vals[0][0] = 0
    x = torch.as_tensor(np.stack([lm.ints_to_lm(v) for v in vals]))
    return lm.to_mont(x).numpy()


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("t", [3, 4, 5])
def test_poseidon_trace_ref_matches_jax(t, T):
    x = _mont_inputs(t - 1, T, 10 * t + T)
    out, trace = K.poseidon_trace_ref(torch.as_tensor(x))
    want_out, want_trace = jax.jit(jcensus.eval_poseidon_trace)(
        jnp.asarray(x))
    assert trace.shape == (K.poseidon_trace_rows(t), 21, T)
    assert K.poseidon_trace_rows(t) == {3: 243, 4: 264, 5: 300}[t]
    assert np.array_equal(np.asarray(want_out), out.numpy())
    assert np.array_equal(np.asarray(want_trace), trace.numpy())


@pytest.mark.parametrize("t", [3, 4, 5])
def test_permutation_ref_matches_jax(t):
    """A whole state (element 0 not zero), with a leading batch axis."""
    x = _mont_inputs(2 * t, 3, t).reshape(2, t, 21, 3)
    got = K.permutation_ref(torch.as_tensor(x), t)
    want = jax.jit(jposeidon.permutation, static_argnums=1)(jnp.asarray(x), t)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("t", [3, 4, 5])
def test_dispatchers_on_cpu_run_the_plain_version(t):
    """CPU tensors go to the plain versions, and no kernel launch is
    counted."""
    x = torch.as_tensor(_mont_inputs(t - 1, 4, 7 * t))
    state = torch.cat([torch.zeros_like(x[:1]), x], 0)
    K.reset_launches()
    out, trace = census.eval_poseidon_trace(x)
    want_out, want_trace = K.poseidon_trace_ref(x)
    assert torch.equal(out, want_out) and torch.equal(trace, want_trace)
    assert torch.equal(K.poseidon_trace(x)[1], want_trace)
    perm = poseidon.permutation(state, t)
    assert torch.equal(perm, K.permutation_ref(state, t))
    assert torch.equal(perm[0], out)
    assert torch.equal(poseidon.poseidon_mont(x), out)
    assert not any(K.LAUNCHES.values())


def test_widths_other_than_3_4_5_raise():
    x = torch.as_tensor(_mont_inputs(1, 2, 1))
    with pytest.raises(ValueError):
        K.poseidon_trace(x)
    with pytest.raises(ValueError):
        K.permutation(torch.cat([x, x, x], 0), 6)

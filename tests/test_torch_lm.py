"""Port field core (zkfranchise_tpu_torch/ops/lm.py) against the JAX
package's ops/lm.py on the same seeded inputs: limbs must be equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu_torch.ops import ff, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.utils import devices

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

RNG = np.random.default_rng(11)
FIELDS = [(jlm.FR, lm.FR), (jlm.FQ, lm.FQ)]


def _limbs(shape, top_bits=7):
    """Normalized random limbs with value < 2^(247 + top_bits)."""
    x = RNG.integers(0, (1 << 13) + 64, size=shape, dtype=np.int32)
    x[..., 19, :] &= (1 << top_bits) - 1
    x[..., 20, :] = 0
    return x


def _canonical(shape, p):
    vals = [int.from_bytes(RNG.bytes(32), "big") % p
            for _ in range(int(np.prod(shape[:-2])) * shape[-1])]
    planes = lm.ints_to_lm(vals).reshape(21, -1, shape[-1])
    return np.ascontiguousarray(np.moveaxis(planes, 0, -2)).reshape(shape)


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("field", [0, 1], ids=["fr", "fq"])
@pytest.mark.parametrize("b_lanes", [16, 1], ids=["full", "bcast"])
def test_mont_mul_matches_jax(field, b_lanes):
    fj, ft = FIELDS[field]
    a = _limbs((3, 4, 21, 16))
    b = _limbs((4, 21, b_lanes))
    want = jlm.mont_mul(jnp.asarray(a), jnp.asarray(b), fj)
    got = lm.mont_mul(torch.as_tensor(a), torch.as_tensor(b), ft)
    assert got.shape == (3, 4, 21, 16)
    assert _eq(want, got)
    assert torch.equal(got, K.mont_mul_ref(torch.as_tensor(a),
                                           torch.as_tensor(b), ft))


@pytest.mark.parametrize("field", [0, 1], ids=["fr", "fq"])
def test_mont_reduce_from_mont_canon(field):
    fj, ft = FIELDS[field]
    cols = RNG.integers(0, 1 << 26, size=(5, 43, 8), dtype=np.int32)
    cols[:, 36:, :] = 0
    assert _eq(jlm.mont_reduce(jnp.asarray(cols), fj),
               lm.mont_reduce(torch.as_tensor(cols), ft))
    a = _limbs((5, 21, 8))
    assert _eq(jlm.from_mont(jnp.asarray(a), fj),
               lm.from_mont(torch.as_tensor(a), ft))
    assert _eq(jlm.canon(jnp.asarray(a), fj), lm.canon(torch.as_tensor(a), ft))
    # values: canon(a) is a mod p, exact
    ints = lm.lm_to_ints(lm.canon(torch.as_tensor(a), ft))
    assert ints == [v % ft.p for v in lm.lm_to_ints(a)]


def test_to_mont_roundtrip_and_subtract():
    x = _canonical((6, 21, 4), ff.P_FR)
    xm = lm.to_mont(torch.as_tensor(x))
    assert _eq(jlm.to_mont(jnp.asarray(x)), xm)
    assert torch.equal(lm.from_mont(xm), torch.as_tensor(x))
    y = lm.to_mont(torch.as_tensor(_canonical((6, 21, 4), ff.P_FR)))
    d = lm.from_mont(lm.sub_n(xm, y))
    want = [(u - v) % ff.P_FR for u, v in
            zip(lm.lm_to_ints(x), lm.lm_to_ints(lm.from_mont(y)))]
    assert lm.lm_to_ints(d) == want
    assert _eq(jlm.neg_n(jnp.asarray(y.numpy())), lm.neg_n(y))


def test_window_digits_and_bits():
    x = _canonical((7, 21, 3), ff.P_FR)
    assert _eq(jlm.window_digits(jnp.asarray(x), 8, 32),
               lm.window_digits(torch.as_tensor(x), 8, 32))
    assert _eq(jlm.bits_from_plain(jnp.asarray(x[0]), 254),
               lm.bits_from_plain(torch.as_tensor(x[0]), 254))


def test_norm_exact_carry():
    t = RNG.integers(0, 1 << 20, size=(4, 21, 8), dtype=np.int32)
    wj, cj = jlm.norm_exact_carry(jnp.asarray(t))
    wt, ct = lm.norm_exact_carry(torch.as_tensor(t))
    assert _eq(wj, wt) and _eq(cj, ct)


def test_cpu_dispatch_and_checks():
    a = torch.as_tensor(_limbs((2, 21, 4)))
    with pytest.raises(TypeError):
        K.mont_mul(a.long(), a)
    with pytest.raises(ValueError):
        K.mont_mul(a.to("meta"), a.to("meta"))
    K.reset_launches()
    K.mont_mul(a, a)
    assert K.LAUNCHES["mont_mul"] == 0          # CPU: plain version only


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve(None)
    assert devices.resolve("cpu").type == "cpu"


def test_collapse_leading_dims():
    """The mont_mul wrapper's stride collapsing (run on the card only):
    contiguous dims merge, broadcast dims keep stride 0, size-1 dims go."""
    a = torch.zeros((3, 4, 21, 8), dtype=torch.int32)
    b = torch.zeros((4, 21, 1), dtype=torch.int32).expand(3, 4, 21, 8)
    assert K._collapse((3, 4), a.stride()[:2], b.stride()[:2]) == \
        [(3, 672, 0), (4, 168, 21)]
    assert K._collapse((3, 4), a.stride()[:2], a.stride()[:2]) == \
        [(12, 168, 168)]
    m = torch.zeros((5, 5, 21, 1), dtype=torch.int32)
    s = torch.zeros((1, 5, 21, 8), dtype=torch.int32).expand(5, 5, 21, 8)
    assert K._collapse((5, 5), m.stride()[:2], s.stride()[:2]) == \
        [(5, 105, 0), (5, 21, 168)]
    assert K._collapse((1, 7), (0, 3), (0, 5)) == [(7, 3, 5)]

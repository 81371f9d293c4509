"""Port batch-affine fold (ops/ec_affine.fold_affine) and the batch
inversion under it (fold_mul, inv, batch_inv) against the JAX package on
the same numpy inputs.  All arithmetic is integer: every comparison is
np.array_equal on every limb, no tolerance.  On the CPU the port's
wrappers run their plain versions and the JAX package's run lm.mont_mul /
lm.inv."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import ec_affine as jaff
from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu.ops.pallas import lm_kernels as JK
from zkfranchise_tpu_torch.ops import ec, ec_affine, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools.verify_kernels import affine_plane_to_host

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

N_CASES = 8


def _cases(kind):
    """The case lists of tests/test_ec_affine.py: (name, P, Q)."""
    grp, mul = (ec.G1, ec.g1_mul) if kind == "g1" else (ec.G2, ec.g2_mul)
    P, Q = mul(5), mul(9)
    last = ("double_negative", grp.neg(P), grp.neg(P)) if kind == "g1" \
        else ("opposite_swapped", grp.neg(Q), Q)
    return [("add", P, Q), ("double", P, P), ("opposite", P, grp.neg(P)),
            ("inf_left", None, Q), ("inf_right", P, None),
            ("inf_both", None, None), ("add_other", mul(7), mul(11)), last]


@functools.lru_cache(maxsize=None)
def _folded(kind):
    """One fold of the whole case list through both packages ->
    (cases, JAX output, port output), each output (arows, N_CASES)."""
    cases = _cases(kind)
    pts = [p for _, p, _ in cases] + [q for _, _, q in cases]
    tab = ec_affine.affine_table(pts, kind)
    # state crosses as numpy: the tables are the same on both sides
    assert np.array_equal(tab, jaff.affine_table(pts, kind))
    x = np.ascontiguousarray(tab.T[None])                # (1, arows, 2n)
    want = jax.jit(lambda v: jaff.fold_affine(v, kind))(jnp.asarray(x))
    got = ec_affine.fold_affine(torch.as_tensor(x), kind)
    assert got.dtype == torch.int32
    return cases, np.asarray(want)[0], got[0].numpy()


@pytest.mark.parametrize("case", range(N_CASES))
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_fold_affine_case_matches_jax_and_host(kind, case):
    cases, want, got = _folded(kind)
    assert len(cases) == N_CASES
    name, p, q = cases[case]
    assert np.array_equal(got[:, case], want[:, case]), name
    grp = ec.G1 if kind == "g1" else ec.G2
    host = affine_plane_to_host(torch.as_tensor(got[:, case:case + 1]), kind)
    assert host == [grp.add(p, q)], name


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_fold_chain_matches_sum_and_jax_levels(kind):
    """Fold 16 points (two at infinity) to the total: every level equals
    the JAX package's, the total equals the host sum."""
    grp, mul = (ec.G1, ec.g1_mul) if kind == "g1" else (ec.G2, ec.g2_mul)
    pts = [mul(3 + j) for j in range(14)] + [None, None]
    x = np.ascontiguousarray(ec_affine.affine_table(pts, kind).T[None])
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    while xt.shape[-1] > 1:
        xj = jaff.fold_affine(xj, kind)
        xt = ec_affine.fold_affine(xt, kind)
        assert np.array_equal(np.asarray(xj), xt.numpy()), xt.shape
    want = None
    for p in pts:
        want = grp.add(want, p)
    assert affine_plane_to_host(xt[0], kind) == [want]


def _fq_limbs(shape, seed, zero_lane=None):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape[:-2])) * shape[-1]
    vals = [int.from_bytes(rng.bytes(32), "big") % lm.FQ.p or 1
            for _ in range(n)]
    x = lm.ints_to_lm(vals)                              # (21, n)
    assert np.array_equal(x, jlm.ints_to_lm(vals))
    x = np.ascontiguousarray(
        x.reshape(21, *shape[:-2], shape[-1]).transpose(1, 0, 2)
        if len(shape) == 3 else x)
    if zero_lane is not None:
        x[..., zero_lane] = 0
    return x


@pytest.mark.parametrize("op", ["fold_mul", "inv", "batch_inv"])
def test_batch_inv_parts_match_jax(op):
    """(2, 21, 16) over Fq; inv on (21, 16) with a zero lane."""
    if op == "fold_mul":
        x = _fq_limbs((2, 21, 16), 1)
        want = JK.fold_mul(jnp.asarray(x), jlm.FQ)
        for fn in (K.fold_mul, K.fold_mul_ref):
            assert np.array_equal(np.asarray(want),
                                  fn(torch.as_tensor(x), lm.FQ).numpy())
    elif op == "inv":
        a = _fq_limbs((21, 16), 2, zero_lane=3)
        want = np.asarray(JK.inv(jnp.asarray(a), jlm.FQ))
        for fn in (K.inv, K.inv_ref):
            got = fn(torch.as_tensor(a), lm.FQ).numpy()
            assert np.array_equal(want, got)
        assert not got[:, 3].any()                       # inv(0) = 0
        # a * a^-1 = 1 on every other lane
        prod = lm.lm_to_ints(lm.from_mont(lm.mont_mul(
            torch.as_tensor(got), torch.as_tensor(a), lm.FQ), lm.FQ))
        assert prod == [0 if t == 3 else 1 for t in range(16)]
    else:
        d = _fq_limbs((2, 21, 16), 3)
        want = np.asarray(JK.batch_inv(jnp.asarray(d), jlm.FQ))
        for fn in (K.batch_inv, K.batch_inv_ref):
            assert np.array_equal(want,
                                  fn(torch.as_tensor(d), lm.FQ).numpy())
        one = K.batch_inv(torch.as_tensor(d[..., :1].copy()), lm.FQ)
        assert np.array_equal(
            one.numpy(), K.inv_ref(torch.as_tensor(d[:, :, 0].T.copy()),
                                   lm.FQ).T[:, :, None].numpy())


def test_field_spec_bits_and_wrapper_checks():
    for fs, jfs in ((lm.FQ, jlm.FQ), (lm.FR, jlm.FR)):
        assert np.array_equal(fs.p_minus_2_bits, jfs.p_minus_2_bits)
    assert lm.FQ.p_minus_2_bits.shape == (254,)
    assert int(lm.FQ.p_minus_2_bits.sum()) == 110
    x = torch.zeros((2, 21, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.batch_inv(x, lm.FQ)                            # 6: no power of two
    with pytest.raises(TypeError):
        K.fold_mul(x.long(), lm.FQ)
    # the four stacked products of _fq2_mul reach mont_mul as ONE leading
    # dim: the kernel reads them in place, without a copy
    a = torch.zeros((3, 4, 21, 5), dtype=torch.int32)
    assert K._collapse(a.shape[:-2], a.stride()[:-2],
                       a.stride()[:-2]) == [(12, 105, 105)]
    K.reset_launches()
    K.batch_inv(x[..., :2] + 1, lm.FQ)
    assert all(v == 0 for v in K.LAUNCHES.values())      # CPU: no kernels

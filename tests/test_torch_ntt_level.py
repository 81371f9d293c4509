"""One NTT butterfly level (ops/ntt.py ntt_level_ref, the dispatch
ntt_level), the operand patterns of mont_mul and the Fermat inversion
against the JAX package on the same numpy inputs, with np.array_equal on
every limb.  On the CPU the port's wrappers run their plain versions; the
JAX level is built from the JAX package's own functions as its tests run
them on the CPU (the K.mont_mul path, lm.weak_norm, lm.sub_n).

    python -m pytest tests/test_torch_ntt_level.py -q
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu.ops import ntt as jntt
from zkfranchise_tpu.ops.pallas import lm_kernels as JK
from zkfranchise_tpu_torch.ops import ff, lm, ntt
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

RNG = np.random.default_rng(31)


def _mont_plane(n, T):
    """(n, 21, T) Montgomery-form Fr elements as numpy."""
    vals = [int.from_bytes(RNG.bytes(32), "big") % ff.P_FR
            for _ in range(n * T)]
    plain = np.ascontiguousarray(
        np.moveaxis(lm.ints_to_lm(vals).reshape(21, n, T), 0, 1))
    return lm.to_mont(torch.as_tensor(plain)).numpy()


def _jax_level(x, g, tw):
    """One level of the JAX package's ntt._transform."""
    h = x.shape[0] // 2
    paired = x[jnp.asarray(g)]
    lo, hi = paired[:h], paired[h:]
    hi = JK.mont_mul(hi, jnp.asarray(tw), jlm.FR)
    return jnp.concatenate([jlm.weak_norm(lo + hi),
                            jlm.sub_n(lo, hi, jlm.FR)], axis=0)


@pytest.mark.parametrize("log_n", [6, 10])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("sched", ["fwd", "inv"])
def test_ntt_level_ref_matches_jax_at_every_level(log_n, T, sched):
    """Every level of the schedule, each fed the previous level's output;
    the port's plan (gathers, twiddles) equals the JAX package's too."""
    jplan = jntt.NTTPlan(log_n)
    gs, tws, final = ntt.plan(log_n).on("cpu")[sched]
    jgs = jplan.fwd_g if sched == "fwd" else jplan.inv_g
    jtws = jplan.fwd_tw if sched == "fwd" else jplan.inv_tw
    assert len(gs) == len(jgs) == log_n
    x = _mont_plane(1 << log_n, T)
    for g, tw, jg, jtw in zip(gs, tws, jgs, jtws):
        assert np.array_equal(g.numpy(), jg)
        assert np.array_equal(tw.numpy(), jtw)
        want = np.asarray(_jax_level(jnp.asarray(x), jg, jtw))
        xt = torch.as_tensor(x)
        got = ntt.ntt_level_ref(xt, g, tw)
        assert np.array_equal(want, got.numpy())
        assert torch.equal(got, ntt.ntt_level(xt, g, tw))
        assert torch.equal(got, ntt.ntt_level_ref(xt, g, tw,
                                                  mul=lm.mont_mul_ref))
        x = got.numpy()


@pytest.mark.parametrize("log_n,T", [(6, 2), (10, 1)])
def test_ntt_through_the_level_dispatch_matches_jax(monkeypatch, log_n, T):
    """ntt (forward, inverse) and coset_evals_from_domain_evals go through
    ntt_level once a level and equal the JAX package's."""
    calls = []
    level = K.ntt_level

    def counted(x, g, tw):
        calls.append(x.shape)
        return level(x, g, tw)

    monkeypatch.setattr(K, "ntt_level", counted)
    x = _mont_plane(1 << log_n, T)
    xj = jnp.asarray(x)
    xt = torch.as_tensor(x)
    fwd = ntt.ntt(xt)
    assert np.array_equal(np.asarray(jntt.ntt(xj)), fwd.numpy())
    inv = ntt.ntt(fwd, inverse=True)
    assert np.array_equal(
        np.asarray(jntt.ntt(jnp.asarray(fwd.numpy()), inverse=True)),
        inv.numpy())
    assert torch.equal(lm.from_mont(inv), lm.from_mont(xt))
    assert len(calls) == 2 * log_n
    cos = ntt.coset_evals_from_domain_evals(xt)
    assert np.array_equal(
        np.asarray(jntt.coset_evals_from_domain_evals(xj)), cos.numpy())
    assert len(calls) == 4 * log_n


def _level_args(case):
    x = torch.zeros((16, 21, 3), dtype=torch.int32)
    g = torch.arange(16)
    tw = torch.zeros((8, 21, 1), dtype=torch.int32)
    if case == "g_int32":
        g = g.int()
    elif case == "g_short":
        g = g[:15]
    elif case == "g_2d":
        g = g.reshape(2, 8)
    elif case == "tw_lanes":
        tw = torch.zeros((8, 21, 3), dtype=torch.int32)
    elif case == "tw_rows":
        tw = tw[:4]
    elif case == "limbs_20":
        x = x[:, :20]
    elif case == "odd_n":
        x = x[:15]
    return x, g, tw


@pytest.mark.parametrize("case", ["g_int32", "g_short", "g_2d", "tw_lanes",
                                  "tw_rows", "limbs_20", "odd_n"])
def test_ntt_level_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        K.ntt_level(*_level_args(case))


def test_ntt_level_takes_no_other_type():
    x, g, tw = _level_args(None)
    assert K.ntt_level(x, g, tw).shape == x.shape
    with pytest.raises(TypeError):
        K.ntt_level(x.long(), g, tw)


def _limbs(shape):
    x = RNG.integers(0, (1 << 13) + 64, size=shape, dtype=np.int32)
    x[..., 19, :] &= 0x7F
    x[..., 20, :] = 0
    return x


# (a, b, field, the launch mont_mul would make: leading dims as (size,
# stride a, stride b) or None for a copy, lanes a block, MONT_SHAPES key)
COLLAPSE = {
    "col": ((8, 21, 16), (8, 21, 1), "fr",
            [(1, 0, 0), (1, 0, 0), (8, 336, 21)], 16,
            "full*col/R8/T16"),
    "const": ((8, 21, 16), (21, 1), "fr",
              [(1, 0, 0), (1, 0, 0), (8, 336, 0)], 16,
              "full*const/R8/T16"),
    "table": ((3, 21, 5), (21, 5), "fq",
              [(1, 0, 0), (1, 0, 0), (3, 105, 0)], 8, "full*table/R3/T5"),
    "full": ((2, 3, 21, 4), (2, 3, 21, 4), "fq",
             [(1, 0, 0), (1, 0, 0), (6, 84, 84)], 4, "full*full/R6/T4"),
    "strided": ((4, 21, 1), "half", "fq",
                [(1, 0, 0), (1, 0, 0), (4, 21, 336)], 1,
                "full*strided/R4/T1"),
    "three_dims": ((3, 4, 5, 21, 9), (3, 1, 5, 21, 1), "fq",
                   [(3, 3780, 105), (4, 945, 0), (5, 189, 21)], 16,
                   "full*col/R60/T9"),
    "six_dims": ((3, 2, 5, 7, 21, 3), "sub", "fq", None, 4,
                 "full*table/R210/T3"),
}


@pytest.mark.parametrize("pattern", sorted(COLLAPSE))
def test_mont_mul_patterns_match_jax(pattern):
    """The launch geometry of each operand pattern (no leading dim needs a
    copy up to three dims; no thread divides 64-bit indices) and the
    product against the JAX package's."""
    sa, sb, field, dims, tx, key = COLLAPSE[pattern]
    a = torch.as_tensor(_limbs(sa))
    if sb == "half":
        b = torch.as_tensor(_limbs((4, 21, 16)))[..., 8:9]
    elif sb == "sub":
        b = a[:, :1, :, :1]
    else:
        b = torch.as_tensor(_limbs(sb))
    shape = torch.broadcast_shapes(a.shape, b.shape)
    ae, be = a.expand(shape), b.expand(shape)
    assert K.mont_launch(shape, ae.stride(), be.stride()) == (dims, tx, key)
    fs, jfs = (lm.FR, jlm.FR) if field == "fr" else (lm.FQ, jlm.FQ)
    want = JK.mont_mul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jfs)
    assert np.array_equal(np.asarray(want), K.mont_mul(a, b, fs).numpy())


def test_lane_block():
    assert [K.lane_block(T) for T in (1, 2, 3, 4, 5, 128, 129, 1000)] == [
        (1, 128), (2, 64), (4, 32), (4, 32), (8, 16), (128, 1), (128, 1),
        (128, 1)]


@pytest.mark.parametrize("T", [1, 129])
def test_inv_matches_jax(T):
    """a^(p-2) with zero lanes (inv(0) = 0), Fq, against the JAX lm.inv."""
    a = _limbs((21, T))
    a[:, ::64] = 0
    want = np.asarray(jlm.inv(jnp.asarray(a), jlm.FQ))
    got = K.inv(torch.as_tensor(a), lm.FQ).numpy()
    assert np.array_equal(want, got)
    assert not got[:, ::64].any()

"""padd at the shapes the main path launches it with (tools.padd_shapes),
against the JAX package's padd_g1 / padd_g2 on the same planes, and the
constants the cooperative CUDA add keeps in constant memory against the
packed EC block.  Integer arithmetic throughout: every comparison is exact.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import ec_lm as jec
from zkfranchise_tpu_torch.ops import ec_lm, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch import tools
from zkfranchise_tpu_torch.tools import padd_shapes

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

SOURCE = pathlib.Path(K.__file__).resolve().parents[2] / "csrc" / \
    "lm_kernels.cu"


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("name,B,T", padd_shapes.SMALL_SHAPES)
def test_padd_at_main_path_shapes_matches_jax(kind, name, B, T):
    rng = np.random.default_rng(21)
    p, q = padd_shapes.padd_inputs(kind, B, T, rng, "cpu")
    assert p.shape == q.shape == (B, ec_lm.ROWS[kind], T)
    jpadd = jec.padd_g1 if kind == "g1" else jec.padd_g2
    want = np.asarray(jpadd(jnp.asarray(p.numpy()), jnp.asarray(q.numpy())))
    assert np.array_equal(want, K.padd(p, q, kind).numpy())


def test_padd_inputs_mix_the_special_cases():
    """A quarter of the adds are P + (-P), doublings, O + Q and P + O."""
    rng = np.random.default_rng(22)
    p, q = padd_shapes.padd_inputs("g1", 4, 16, rng, "cpu")
    ident = ec_lm.identity_plane("g1", (), 1, "cpu")[:, 0]
    flat_p = p.permute(1, 0, 2).reshape(63, -1)
    flat_q = q.permute(1, 0, 2).reshape(63, -1)
    same = (flat_p == flat_q).all(0)
    p_id = (flat_p == ident[:, None]).all(0)
    q_id = (flat_q == ident[:, None]).all(0)
    neg_y = lm.weak_norm(lm.const(lm.FQ.sub_d, "cpu") - flat_p[21:42])
    opposite = (flat_q[21:42] == neg_y).all(0) & \
        (flat_q[:21] == flat_p[:21]).all(0)
    for mask in (same, p_id, q_id, opposite):
        assert int(mask.sum()) >= 4


def _constant_arrays() -> dict:
    src = SOURCE.read_text()
    out = {}
    for m in re.finditer(r"__constant__ int (\w+)\[[^\]]*\] = \{([^}]*)\}",
                         src):
        out[m.group(1)] = [int(v) for v in m.group(2).replace("\n", " ")
                           .split(",")]
    return out


def test_padd_constants_equal_the_packed_block():
    block = ec_lm.pack_ec_consts()[:, 0].tolist()
    row = {name: block[21 * i:21 * (i + 1)] for i, name in enumerate(
        ["p", "np", "sub_d", "one", "sub_d1", "sub_d2", "b3g1", "b3g2_re",
         "b3g2_im"])}
    arrays = _constant_arrays()
    assert arrays == {"FQ_P": row["p"], "FQ_NP": row["np"],
                      "FQ_SUBD": row["sub_d"], "FQ_SUBD2": row["sub_d2"],
                      "FQ_ONE": row["one"], "EC_B3G1": row["b3g1"],
                      "EC_B3G2": row["b3g2_re"] + row["b3g2_im"]}


def test_padd_shapes_tool_passes_on_cpu(capsys):
    assert padd_shapes.main("cpu", small=True) == 0
    out = capsys.readouterr().out
    assert "VERDICT: PASS" in out and "nothing timed" in out


def test_padd_shapes_bounds_take_the_larger_time():
    b = padd_shapes.bounds("g2", 128, 128, 1980.0)
    assert b["bound_by"] == "operations"
    # a G2 add of the cooperative kernel: 31,758 multiply-adds
    assert b["bound_ms"] == pytest.approx(2 * 31758 * 16384 / 67e12 * 1e3)
    # the integer ceiling: 64 multiply-adds per clock per SM, 132 SMs
    assert b["int_ceiling_ms"] == pytest.approx(
        31758 * 16384 / (64 * 132 * 1980e6) * 1e3)


# (form, kind): multiply-adds of one add with schoolbook column products
# (441 each), then with the cooperative kernels' Karatsuba (342).  G1 RCB15:
# 8 products, 3 reductions of 2 lazy terms; G2: 16 of 2 lazy Fq products,
# 6 of 4; the mixed adds: 4 and 3 (G1), 8 and 6 (G2).
ADD_MADS = {("padd", "g1"): (8 * 1113 + 3 * 1554, 8 * 915 + 3 * 1257),
            ("padd", "g2"): (16 * 1554 + 6 * 2436, 16 * 1257 + 6 * 1941),
            ("padd_aa", "g1"): (4 * 1113 + 3 * 1554, 4 * 915 + 3 * 1257),
            ("padd_aa", "g2"): (8 * 1554 + 6 * 2436, 8 * 1257 + 6 * 1941)}


@pytest.mark.parametrize("form,kind", sorted(ADD_MADS))
def test_add_mads_count_each_product(form, kind):
    school, kara = ADD_MADS[(form, kind)]
    assert tools.add_mads(form, kind, tools.COLS_SCHOOLBOOK) == school
    assert tools.add_mads(form, kind) == kara
    assert (school, kara) == {("padd", "g1"): (13566, 11091),
                              ("padd", "g2"): (39480, 31758),
                              ("padd_aa", "g1"): (9114, 7431),
                              ("padd_aa", "g2"): (27048, 21702)}[(form, kind)]

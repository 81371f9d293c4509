"""The port's in-kernel chains (plain versions) and its three tools
(tools.verify_kernels, tools.verify_lm, tools.micro_montmul) on the CPU:
against the integer formulas, the host bigint oracle and the JAX package's
lm.mont_mul.  Integer arithmetic throughout, exact comparisons."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu_torch.ops import ec, ec_lm, ff, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import (micro_montmul, verify_kernels,
                                         verify_lm)

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

P = ff.P_FQ
TOOLS = {"verify_kernels": verify_kernels, "verify_lm": verify_lm,
         "micro_montmul": micro_montmul}


@pytest.mark.parametrize("iters", [1, 3])
def test_mont_chain_ref_matches_formula_and_jax(iters):
    rng = np.random.default_rng(iters)
    xs = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(6)]
    ys = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(6)]
    a, b = lm.ints_to_lm(xs), lm.ints_to_lm(ys)
    assert np.array_equal(a, jlm.ints_to_lm(xs))
    want = jnp.asarray(a)
    for _ in range(iters):
        want = jlm.mont_mul(want, jnp.asarray(b), jlm.FQ)
    for fn in (K.mont_chain, K.mont_chain_ref):
        got = fn(torch.as_tensor(a), torch.as_tensor(b), iters, lm.FQ)
        assert np.array_equal(np.asarray(want), got.numpy())
    rinv = pow(1 << lm.R_BITS, -1, P)
    assert [g % P for g in lm.lm_to_ints(got)] == \
        [x * pow(y * rinv, iters, P) % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("kind,lanes", [("g1", 4), ("g2", 2)])
def test_scalar_mul_ref_matches_host(kind, lanes):
    """A 16-bit scalar that starts on a zero bit; lane 1 is the identity."""
    k = 0b1011_0110_0101_1010
    if kind == "g1":
        grp, mul, table, to_aff = (ec.G1, ec.g1_mul, ec_lm.g1_table,
                                   ec_lm.g1_plane_to_affine)
    else:
        grp, mul, table, to_aff = (ec.G2, ec.g2_mul, ec_lm.g2_table,
                                   ec_lm.g2_plane_to_affine)
    pts = [mul(7 + j) for j in range(lanes)]
    pts[1] = None
    plane = torch.as_tensor(np.ascontiguousarray(table(pts).T))
    bits = verify_lm.scalar_bits(k, 16)
    assert sum(int(b) << i for i, b in enumerate(bits)) == k
    got = K.scalar_mul(plane, bits, kind)
    assert torch.equal(got, K.scalar_mul_ref(plane, bits, kind))
    assert to_aff(got) == [grp.mul(k, p) for p in pts]


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_passes_on_cpu_at_reduced_sizes(tool, capsys):
    assert TOOLS[tool].main("cpu", small=True) == 0
    out = capsys.readouterr().out
    assert "VERDICT: PASS" in out and "FAIL" not in out


def test_tool_reports_a_wrong_kernel(monkeypatch, capsys):
    """A chain that is off by one limb makes the tool return non-zero."""
    def wrong(a, b, iters, fs):
        out = K.mont_chain_ref(a, b, iters, fs).clone()
        out[0] += 1
        return out

    monkeypatch.setattr(K, "mont_chain", wrong)
    assert micro_montmul.main("cpu", small=True) == 1
    assert "FAIL" in capsys.readouterr().out


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for tool in TOOLS.values():
        with pytest.raises(RuntimeError):
            tool.main()

"""The five kernels of the layout experiments (plain versions) and the two
tools (tools.layout_expt, tools.layout_expt2) on the CPU, against the JAX
package's plain references of the Pallas bodies: iterated lm.mont_mul,
ec_lm.padd_g1 / padd_g2 on the paired lanes, and jnp for the two int32
controls.  Integer arithmetic throughout: every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import ec_lm as jec_lm
from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu_torch.ops import ec, ec_lm, lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import layout_expt, layout_expt2

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

TOOLS = {"layout_expt": layout_expt, "layout_expt2": layout_expt2}


def _limbs(seed, shape):
    return layout_expt.random_limbs(np.random.default_rng(seed), shape)


@pytest.mark.parametrize("tile,chain", [(16, 1), (64, 2), (256, 8), (7, 3)])
def test_mm2d_matches_jax_chain(tile, chain):
    a, b = _limbs(1, (21, 256)), _limbs(2, (21, 256))
    want = jnp.asarray(a)
    for _ in range(chain):
        want = jlm.mont_mul(want, jnp.asarray(b), jlm.FQ)
    for fn in (K.mm2d, K.mm2d_ref):
        got = fn(torch.as_tensor(a), torch.as_tensor(b), tile, chain)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("tile,blk", [(16, 1), (16, 2), (64, 4)])
def test_mm3d_matches_jax(tile, blk):
    a, b = _limbs(3, (4, 21, 64)), _limbs(4, (4, 21, 64))
    want = jlm.mont_mul(jnp.asarray(a), jnp.asarray(b), jlm.FQ)
    for fn in (K.mm3d, K.mm3d_ref):
        got = fn(torch.as_tensor(a), torch.as_tensor(b), tile, blk)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kind,tile,m", [
    pytest.param("g1", 2, 8, id="g1-2"), pytest.param("g1", 8, 8, id="g1-8"),
    pytest.param("g2", 4, 8, id="g2-4"),
    # a segment half-width of 37: not a multiple of the kernel's groups of
    # 32 adds, so a block's last group is ragged
    pytest.param("g1", 33, 74, id="g1-33-m74"),
    pytest.param("g2", 512, 74, id="g2-512-m74")])
def test_fold2d_matches_jax_padd_on_paired_lanes(kind, tile, m):
    """(rows, B*m) flat: lane b*m + j is added to lane b*m + m/2 + j.
    Real points, with an identity lane and a doubling pair."""
    B = 3
    rng = np.random.default_rng(5)
    mul, table, jpadd = (
        (ec.g1_mul, ec_lm.g1_table, jec_lm.padd_g1) if kind == "g1"
        else (ec.g2_mul, ec_lm.g2_table, jec_lm.padd_g2))
    pts = [mul(int(k)) for k in rng.integers(1, 1 << 30, size=B * m)]
    pts[2] = None                                   # O + Q
    pts[m // 2 + 1] = pts[1]                        # doubling
    x = np.ascontiguousarray(table(pts).T)          # (rows, B*m)
    left = [b * m + j for b in range(B) for j in range(m // 2)]
    right = [i + m // 2 for i in left]
    want = jpadd(jnp.asarray(x[:, left]), jnp.asarray(x[:, right]))
    for fn in (K.fold2d, K.fold2d_ref):
        got = fn(torch.as_tensor(x), tile, kind, m)
        assert got.shape == (x.shape[0], B * m // 2)
        assert np.array_equal(np.asarray(want), got.numpy())
    # and it is the segmented fold_padd of the (B, rows, m) plane
    seg = torch.as_tensor(x).reshape(-1, B, m).permute(1, 0, 2)
    assert torch.equal(K.fold_padd(seg.contiguous(), kind).permute(1, 0, 2)
                       .reshape(-1, B * m // 2), got)


@pytest.mark.parametrize("rows,tile", [(21, 16), (24, 64), (8, 5)])
def test_add_one_matches_jnp(rows, tile):
    a = np.random.default_rng(6).integers(-2**31, 2**31, (rows, 96),
                                          dtype=np.int64).astype(np.int32)
    a[0, 0] = 2**31 - 1                             # wraps as in JAX
    want = np.asarray(jnp.asarray(a) + 1)
    for fn in (K.add_one, K.add_one_ref):
        assert np.array_equal(want, fn(torch.as_tensor(a), tile).numpy())


@pytest.mark.parametrize("m", [2, 64, 256])
def test_fused_upsweep_matches_jnp_halving_loop(m):
    x = np.random.default_rng(m).integers(-2**31, 2**31, (5, m),
                                          dtype=np.int64).astype(np.int32)
    cur, outs = jnp.asarray(x), []
    while cur.shape[-1] > 1:
        h = cur.shape[-1] // 2
        cur = cur[..., :h] + cur[..., h:]
        outs.append(cur)
    want = np.asarray(jnp.concatenate(outs, axis=-1))
    assert want.shape == (5, m - 1)
    for fn in (K.fused_upsweep, K.fused_upsweep_ref):
        assert np.array_equal(want, fn(torch.as_tensor(x), 512).numpy())
    assert np.array_equal(want,
                          layout_expt2.level_adds(torch.as_tensor(x)).numpy())


def test_wrappers_refuse_bad_geometry_and_shapes():
    a = torch.as_tensor(_limbs(7, (21, 16)))
    with pytest.raises(ValueError):
        K.mm2d(a, a, 0, 1)
    with pytest.raises(ValueError):
        K.mm3d(a[None], a[None], 16, 0)
    with pytest.raises(ValueError):
        K.fold2d(torch.zeros((63, 24), dtype=torch.int32), 4, "g1", 16)
    with pytest.raises(ValueError):
        K.fused_upsweep(torch.zeros((3, 24), dtype=torch.int32))
    with pytest.raises(TypeError):
        K.add_one(a.long(), 16)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_layout_tool_passes_on_cpu_at_reduced_sizes(tool, capsys):
    K.reset_launches()
    assert TOOLS[tool].main("cpu", small=True) == 0
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU: no kernels
    out = capsys.readouterr().out
    assert "VERDICT: PASS" in out and "FAIL" not in out
    assert "nothing timed" in out


@pytest.mark.parametrize("tool,name", [("layout_expt", "fold2d"),
                                       ("layout_expt", "mm3d"),
                                       ("layout_expt2", "fused_upsweep"),
                                       ("layout_expt2", "add_one")])
def test_layout_tool_reports_a_wrong_kernel(tool, name, monkeypatch, capsys):
    """A kernel that is off by one in one place makes the tool FAIL."""
    ref = getattr(K, name + "_ref")

    def wrong(*args, **kw):
        out = ref(*args, **kw).clone()
        out[0, -1] += 1
        return out

    monkeypatch.setattr(K, name, wrong)
    assert TOOLS[tool].main("cpu", small=True) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "VERDICT: PASS" not in out


def test_layout_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for tool in TOOLS.values():
        with pytest.raises(RuntimeError):
            tool.main()

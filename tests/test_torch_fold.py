"""The sum tree's folds: fold_padd_levels (several levels a launch on the
card) and fold_padd_aa against the JAX package's fold_padd and
fold_padd_aa on the same planes, the MSM upsweep against the JAX
upsweep's planes, and the launch plan (fold_plan) against the MSM's
launch table and the shared memory of one block.  Integer arithmetic
throughout: every comparison is exact.
"""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import ec_lm as jec
from zkfranchise_tpu.ops.pallas import lm_kernels as JK
from zkfranchise_tpu_torch.ops import ec_lm, msm_lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import fold_shapes

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

SOURCE = pathlib.Path(K.__file__).resolve().parents[2] / "csrc" / \
    "lm_kernels.cu"
M = 16                                  # plane width: levels 8, 4, 2, 1


@functools.lru_cache(maxsize=None)
def _plane_and_jax_levels(kind):
    """A (2, rows, 16) projective plane with identity, doubling and
    P + (-P) pairs, and its four levels from four calls of the JAX
    package's fold_padd.  Each call takes a plane of the same shape, so
    JAX compiles once: level l's input of width 2w sits in lanes [0, w)
    and [8, 8 + w) of a plane of identities, and the fold's first w
    lanes are level l + 1."""
    x = fold_shapes.fold_inputs("fold", kind, 2, M, np.random.default_rng(
        31), "cpu")
    ident = (jec.g1_identity_plane if kind == "g1"
             else jec.g2_identity_plane)((2,), M)
    levels, y = [], x.numpy()
    while y.shape[-1] > 1:
        w = y.shape[-1] // 2
        e = ident.copy()
        e[..., :w] = y[..., :w]
        e[..., M // 2:M // 2 + w] = y[..., w:]
        y = np.asarray(JK.fold_padd(jnp.asarray(e), kind))[..., :w]
        levels.append(y)
    return x, levels


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_fold_padd_levels_matches_jax(kind, n):
    x, want = _plane_and_jax_levels(kind)
    got = K.fold_padd_levels(x, kind, n)
    assert [tuple(g.shape) for g in got] == \
        [(2, ec_lm.ROWS[kind], M >> (i + 1)) for i in range(n)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert torch.equal(K.fold_padd(x, kind), got[0])


def test_fold_padd_aa_matches_jax_g2():
    """(G1's fold_padd_aa is held against JAX in the upsweep test.)"""
    a = fold_shapes.fold_inputs("aa", "g2", 2, M, np.random.default_rng(
        32), "cpu")
    want = np.asarray(JK.fold_padd_aa(jnp.asarray(a.numpy()), "g2"))
    assert np.array_equal(K.fold_padd_aa(a, "g2").numpy(), want)


@pytest.mark.parametrize("m", [256, 512])
def test_upsweep_matches_jax_planes(m):
    """The port's upsweep (fold_padd_aa reading a table's rows through an
    index, then fold_padd_levels by the plan) against the JAX upsweep's
    planes over the plane those rows make: fold_padd_aa, then fold_padd
    level by level, to width 128."""
    a = fold_shapes.fold_inputs("aa", "g1", 1, m, np.random.default_rng(
        33), "cpu")
    # the plane's lanes as rows of a table, in a shuffled order
    order = torch.as_tensor(np.random.default_rng(35).permutation(m))
    table = torch.empty((m, a.shape[1]), dtype=torch.int32)
    table[order] = a[0].T
    y = JK.fold_padd_aa(jnp.asarray(a.numpy()), "g1")
    want = [np.asarray(y)]
    while y.shape[-1] > msm_lm.WFLOOR:
        y = JK.fold_padd(y, "g1")
        want.append(np.asarray(y))
    got = msm_lm.upsweep(table, order[None].to(torch.int32), "g1",
                         msm_lm.WFLOOR)
    assert len(got) == len(want) == m.bit_length() - 8
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_fold_plan_gives_the_launch_table():
    """At batch 128 the main path's chunks (32,768 C; 8,192 A, B1, B2;
    2,048 A's remainder) fold in 608 launches a step: fold_padd G1 288
    (640 at one level a launch), G2 160, fold_padd_aa 128 and 32."""
    assert K.fold_plan("g1", 16384, 128) == [1, 1, 3, 2]
    assert K.fold_plan("g1", 4096, 128) == [3, 2]
    assert K.fold_plan("g1", 1024, 128) == [3]
    assert K.fold_plan("g2", 4096, 128) == [1] * 5
    assert K.fold_plan("g1", 128, 128) == []
    step: dict = {}
    for n, kind in ((10150, "g1"), (6916, "g1"), (6916, "g2"),
                    (26524, "g1")):
        for key, v in msm_lm.msm_fold_launches(n, 128, kind).items():
            step[key] = step.get(key, 0) + v
    by_form: dict = {}
    levels_by_width: dict = {}
    for key, v in step.items():
        name, kind, b, h, n = key.split("/")
        assert b == "B128"
        by_form[f"{name}/{kind}"] = by_form.get(f"{name}/{kind}", 0) + v
        for i in range(int(n[1:])):
            w = (name, kind, int(h[1:]) >> i)
            levels_by_width[w] = levels_by_width.get(w, 0) + v
    assert by_form == {"fold_padd/g1": 288, "fold_padd/g2": 160,
                       "fold_padd_aa/g1": 128, "fold_padd_aa/g2": 32}
    assert sum(step.values()) == 608
    # one level a launch, the issue's table: launches by output width
    assert {w: v for (nm, k, w), v in levels_by_width.items()
            if (nm, k) == ("fold_padd", "g1")} == {
        8192: 32, 4096: 32, 2048: 96, 1024: 96, 512: 128, 256: 128,
        128: 128}
    assert {w: v for (nm, k, w), v in levels_by_width.items()
            if (nm, k) == ("fold_padd", "g2")} == {
        2048: 32, 1024: 32, 512: 32, 256: 32, 128: 32}
    assert {(k, w): v for (nm, k, w), v in levels_by_width.items()
            if nm == "fold_padd_aa"} == {
        ("g1", 16384): 32, ("g1", 4096): 64, ("g1", 1024): 32,
        ("g2", 4096): 32}


def test_fold_plan_fits_shared_memory():
    """Every launch fits one block's 227 KB whatever its levels, by the
    byte formula whose constants are the source's; the plan never takes
    more levels than the kernel is compiled for."""
    src = SOURCE.read_text()
    for kind, (stride, consts) in K.FOLD_REGION.items():
        group = "G1" if kind == "g1" else "G2"
        assert re.search(rf"#define {group}_STRIDE {stride}\b", src)
        assert K.fold_smem_bytes(kind) <= K.BLOCK_SHARED_MAX
    assert re.search(rf"NCONST = NL, MAX_LEVELS = {K.FOLD_LEVELS['g1']};",
                     src)
    assert re.search(rf"NCONST = 3 \* NL, MAX_LEVELS = "
                     rf"{K.FOLD_LEVELS['g2']};", src)
    for kind in ("g1", "g2"):
        for h in (16384, 4096, 1024, 256):
            plan = K.fold_plan(kind, h, 128)
            assert max(plan, default=1) <= K.FOLD_LEVELS[kind]
            widths = [h >> (i + 1) for i in range(sum(plan))]
            starts = [widths[sum(plan[:i])] for i in range(len(plan))]
            assert all(n == 1 for n, w in zip(plan, starts)
                       if w > K.FOLD_WIDE)


def test_fold_padd_levels_rejects_what_it_does_not_take():
    x = torch.zeros((2, 63, 24), dtype=torch.int32)
    assert len(K.fold_padd_levels(x, "g1", 3)) == 3   # 12, 6, 3
    for n in (0, 4, 5):                               # 24 % 16, n < 1
        with pytest.raises(ValueError):
            K.fold_padd_levels(x, "g1", n)
    with pytest.raises(ValueError):
        K.fold_padd_levels(torch.zeros((2, 63, 2), dtype=torch.int32),
                           "g1", 2)                   # n > log2(2h)
    with pytest.raises(ValueError):
        K.fold_padd_levels(x[:, :62], "g1", 1)
    with pytest.raises(TypeError):
        K.fold_padd_levels(x.long(), "g1", 1)
    with pytest.raises(ValueError):
        K.fold_plan("g1", 96, 1)                      # 96 -> 3 is odd


def test_fold_padd_aa_through_an_index_rejects_what_it_does_not_take():
    table = torch.zeros((8, 43), dtype=torch.int32)
    idx = torch.zeros((2, 6), dtype=torch.int32)
    assert K.fold_padd_aa(table, "g1", idx=idx).shape == (2, 63, 3)
    for t, i in ((table, idx[:, :5]), (table[:, :42], idx), (table[None], idx),
                 (table, idx[0])):
        with pytest.raises(ValueError):
            K.fold_padd_aa(t, "g1", idx=i)
    with pytest.raises(TypeError):
        K.fold_padd_aa(table, "g1", idx=idx.long())
    with pytest.raises(ValueError):
        K.fold_padd_aa(table, "g2", idx=idx)          # G2 rows are 85
    for bad in (8, -1):                   # past the table, and a negative
        out = idx.clone()
        out[1, 4] = bad
        with pytest.raises(IndexError):
            K.fold_padd_aa(table, "g1", idx=out)


def test_fold_launches_of_a_small_chunk():
    """Below width 128 the tree goes to width 1 and the bucket sums are
    reduced by one-level folds (_tree_reduce_lanes)."""
    got = msm_lm.fold_launches(64, 2, "g1", G=8)
    assert got["fold_padd_aa/g1/B16/h32/n1"] == 4
    assert got["fold_padd/g1/B16/h16/n3"] == 4
    assert got["fold_padd/g1/B16/h2/n2"] == 4
    assert sum(v for k, v in got.items() if k.endswith("/n1")
               and k.startswith("fold_padd/")) == 7 * 4


def test_fold_shapes_tool_passes_on_cpu(capsys):
    assert fold_shapes.main("cpu", small=True) == 0
    out = capsys.readouterr().out
    assert "VERDICT: PASS" in out and "nothing timed" in out


def test_fold_inputs_mix_the_special_cases():
    x = fold_shapes.fold_inputs("aa", "g2", 2, 64, np.random.default_rng(
        34), "cpu")
    h = 32
    flags_l, flags_r = x[:, 84, :h], x[:, 84, h:]
    assert int((flags_l == 1).sum()) >= 2 and int((flags_r == 1).sum()) >= 2
    same = (x[..., :h] == x[..., h:]).all(1)
    assert int(same.sum()) >= 2


def test_sass_mix_counts_the_product_pipe():
    text = """
        Function : _Z10add_kernelI6PaddG1Lb0EEvPKiS2_Pixxxxxxxx
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/              @!P0 IMAD R3, R2, R4, R3 ;
        /*0020*/                   IMAD R5, R2, R4, R5 ;
        /*0030*/                   LOP3.LUT R1, R2, 0x1fff, RZ, 0xc0, !PT ;
        /*0040*/                   LEA.HI R1, R2, R3, RZ, 0x13 ;
"""
    mix = fold_shapes.parse_sass(text)
    (name, m), = mix.items()
    assert "add_kernel" in name
    assert (m["instructions"], m["IMAD"], m["IMAD_other"]) == (5, 2, 1)
    assert m["top"]["LOP3"] == 1 and m["top"]["LEA"] == 1

"""batch_inv's own kernels on the CPU: the plan of its launches, the plain
versions that walk the kernels' tiles and one buffer, and the whole held
against the JAX package's batch_inv.  All arithmetic is integer: every
comparison is exact, on every limb."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import lm as jlm
from zkfranchise_tpu.ops.pallas import lm_kernels as JK
from zkfranchise_tpu_torch.ops import lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import INV_CHAIN_FQ, batch_inv_work

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

BLOCK_SHARED_MAX = 232448                       # 227 KB a block (H100)


def _fq(shape, seed, one_lane=None):
    """Montgomery Fq values < p as (B, 21, X) int32 limbs; lane `one_lane`
    of every row set to one (where the caller maps a zero)."""
    rng = np.random.default_rng(seed)
    B, _, X = shape
    vals = [int.from_bytes(rng.bytes(32), "big") % lm.FQ.p or 1
            for _ in range(B * X)]
    x = lm.ints_to_lm([v * (1 << lm.R_BITS) % lm.FQ.p for v in vals])
    x = np.ascontiguousarray(x.reshape(21, B, X).transpose(1, 0, 2))
    if one_lane is not None:
        x[..., one_lane] = np.asarray(lm.FQ.one_mont)[:, 0][None, :]
    return x


@pytest.mark.parametrize("n", range(16))
def test_plan_covers_every_level_once(n):
    """Every level of the tree is formed by exactly one launch on the way
    up and one on the way down; the heap lanes of the levels are disjoint
    and inside [1, X); each block fits in shared memory; at most 6
    launches, and one at X <= 32."""
    X = 1 << n
    for B in (1, 3, 128):
        plan = K.batch_inv_plan(B, X)
        kinds = [p[0] for p in plan]
        assert kinds.count("top") == 1
        assert len(plan) <= 6 and (len(plan) == 1) == (X <= 32)
        ups = [p for p in plan if p[0] == "fold_mul_levels"]
        downs = [p for p in plan if p[0] == "down"]
        top = plan[len(ups)]
        assert kinds == ["fold_mul_levels"] * len(ups) + ["top"] + \
            ["down"] * len(downs)
        # up: levels 1 .. t0 once each, in order; the top t0+1 .. n
        formed = [lv for _, lo, k, *_ in ups for lv in range(lo + 1,
                                                             lo + k + 1)]
        assert formed == list(range(1, top[1] + 1))
        assert top[1] + top[2] == n and 1 <= X >> top[1] <= K.INV_TOP
        # down: u_{t0 - 1} .. u_0 once each, in order
        walked = [lv for _, lo, k, *_ in downs
                  for lv in range(lo + k - 1, lo - 1, -1)]
        assert walked == list(range(top[1] - 1, -1, -1))
        for kernel, lo, k, grid, threads, smem in plan:
            assert smem <= BLOCK_SHARED_MAX
            if kernel == "top":
                assert grid == (B, 1) and threads == 32
                continue
            cols = K.inv_cols(X, lo, k)
            assert 1 <= k <= K.INV_LEVELS and threads == K.THREADS
            assert cols in (K.INV_COLS, 2 * K.INV_COLS)
            assert grid == ((X >> (lo + k)) // cols, B)
            assert (X >> (lo + k)) % cols == 0
        heap = K.batch_inv_heap(X)
        assert sorted(heap) == list(range(1, top[1] + 1))
        spans = sorted((at, at + w) for at, w in heap.values())
        assert all(1 <= a < b <= X for a, b in spans)
        assert all(b <= a2 for (_, b), (a2, _) in zip(spans, spans[1:]))


def test_plan_at_the_affine_trees_widest_call():
    """X = 16384: two launches up, the top, two down, 4 + 5 tile levels a
    way.  The wide launches (four levels) give a block 64 columns and 43
    KB of strips, and the walk down 21 KB of stage slots beside them, so
    four and three blocks fit an SM; the narrow ones (five levels, a top
    level of 32 lanes) 32 columns."""
    plan = K.batch_inv_plan(128, 16384)
    assert [(p[0], p[1], p[2]) for p in plan] == [
        ("fold_mul_levels", 0, 4), ("fold_mul_levels", 4, 5),
        ("top", 9, 5), ("down", 4, 5), ("down", 0, 4)]
    assert [p[3] for p in plan] == [(16, 128), (1, 128), (128, 1),
                                    (1, 128), (16, 128)]
    assert [p[5] for p in plan] == [43008, 43008, K.INV_TOP_SMEM,
                                    64512, 64512]
    assert 4 * 43008 <= 233472 and 3 * 64512 <= 233472   # 228 KB an SM


@pytest.mark.parametrize("X", [1, 2, 32, 64, 1024])
def test_composed_plain_versions_equal_jax_batch_inv(X):
    """The plan's plain versions, composed as batch_inv composes them on
    the CPU, against the JAX package's batch_inv (its fold_mul, inv and
    mont_mul on the CPU) limb for limb, B = 3, lane 1 mapped to one."""
    d = _fq((3, 21, X), X, one_lane=1 if X > 1 else None)
    want = np.asarray(JK.batch_inv(jnp.asarray(d), jlm.FQ))
    K.reset_launches()
    got = K.batch_inv(torch.as_tensor(d), lm.FQ)
    assert np.array_equal(want, got.numpy())
    assert not any(K.LAUNCHES.values())                  # CPU: no kernels
    assert np.array_equal(want, K.batch_inv_ref(torch.as_tensor(d),
                                                lm.FQ).numpy())
    # every lane times its inverse is one
    prod = lm.from_mont(lm.mont_mul(got, torch.as_tensor(d), lm.FQ), lm.FQ)
    assert lm.lm_to_ints(prod.permute(1, 0, 2).reshape(21, -1)) == \
        [1] * (3 * X)


def _levels(d):
    """v_0 .. v_n of the plain tree (lm.batch_inv_lanes's pairs)."""
    levels = [d]
    while levels[-1].shape[-1] > 1:
        x = levels[-1]
        h = x.shape[-1] // 2
        levels.append(lm.mont_mul_ref(x[..., :h], x[..., h:], lm.FQ))
    return levels


@pytest.mark.parametrize("X", [64, 2048, 4096])
def test_heap_holds_exactly_the_levels_on_the_way_up(X):
    """After the walk up the buffer holds v_l at lanes [X >> l, 2 (X >>
    l)) for every level the tile launches form, and nothing else is
    written (the rest keeps a marker)."""
    d = torch.as_tensor(_fq((2, 21, X), 7))
    heap = torch.full_like(d, -7)
    for kernel, lo, k, *_ in K.batch_inv_plan(2, X):
        if kernel == "fold_mul_levels":
            K.fold_mul_levels(d, heap, lo, k, lm.FQ)
    levels = _levels(d)
    written = torch.zeros(X, dtype=torch.bool)
    for lv, (at, w) in K.batch_inv_heap(X).items():
        assert torch.equal(heap[..., at:at + w], levels[lv])
        written[at:at + w] = True
    assert bool((heap[..., ~written] == -7).all())


@pytest.mark.parametrize("X", [64, 2048])
def test_each_launch_walks_its_tiles(X):
    """Each plain version alone: the top leaves u_t0 at lanes [0, X >> t0)
    and each walk down u_lo at lanes [0, X >> lo), u_l being the batch
    inversion of level l (the same pairs, so the same limbs); u_0 is
    batch_inv_ref's."""
    d = torch.as_tensor(_fq((2, 21, X), 11))
    levels = _levels(d)
    heap = torch.empty_like(d)
    for kernel, lo, k, *_ in K.batch_inv_plan(2, X):
        if kernel == "fold_mul_levels":
            K.fold_mul_levels_ref(d, heap, lo, k, lm.FQ)
        elif kernel == "top":
            K.batch_inv_top_ref(d, heap, lo, lm.FQ)
            assert torch.equal(heap[..., :X >> lo],
                               lm.batch_inv_lanes(levels[lo], lm.FQ))
        else:
            K.batch_inv_down_ref(d, heap, lo, k, lm.FQ)
            assert torch.equal(heap[..., :X >> lo],
                               lm.batch_inv_lanes(levels[lo], lm.FQ))
    assert torch.equal(heap, K.batch_inv_ref(d, lm.FQ))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    d = torch.as_tensor(_fq((2, 21, 64), 3))
    heap = torch.empty_like(d)
    with pytest.raises(ValueError):
        K.batch_inv(d[..., :48], lm.FQ)                 # no power of two
    with pytest.raises(ValueError):
        K.fold_mul_levels(d, heap[..., :32], 0, 1, lm.FQ)   # heap's shape
    with pytest.raises(ValueError):
        K.batch_inv_down(d, heap.transpose(0, 1), 0, 1, lm.FQ)
    with pytest.raises(TypeError):
        K.batch_inv_top(d.long(), heap.long(), 1, lm.FQ)
    with pytest.raises(ValueError):
        K.batch_inv_levels(48)
    # launches the plan never makes: six levels, a top level narrower
    # than a block's 32 columns, a top wider than 32 lanes
    with pytest.raises(ValueError):
        K.fold_mul_levels(d, heap, 0, 6, lm.FQ)
    with pytest.raises(ValueError):
        K.batch_inv_down(d, heap, 0, 2, lm.FQ)
    with pytest.raises(ValueError):
        K.batch_inv_top(d, heap, 0, lm.FQ)
    # the launches' 32-bit indices: at most 65535 rows, fewer than 2^31
    # elements (a meta tensor: shape only, nothing allocated)
    big = torch.empty((1, 21, 1 << 27), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        K.batch_inv(big, lm.FQ)
    rows = torch.ones((65536, 21, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="65535 rows"):
        K.batch_inv(rows, lm.FQ)
    with pytest.raises(ValueError, match="65535 rows"):
        K.batch_inv_top(rows, torch.empty_like(rows), 0, lm.FQ)


def test_batch_inv_bound_counts_the_least_work():
    """B * 915 (3 (X - 1) + 363) multiply-adds (every product, the Fermat
    chain's too, at the Karatsuba's count) and d read plus the result
    written once: at (128, 21, 16384) 0.1731 ms of operations and a 0.3467
    ms integer ceiling at 1,980 MHz."""
    from zkfranchise_tpu_torch import tools

    nbytes, mads = batch_inv_work(128, 16384)
    assert INV_CHAIN_FQ == len(lm.FQ.p_minus_2_bits) - 1 + \
        int(lm.FQ.p_minus_2_bits.sum())
    assert mads == 128 * 915 * (3 * 16383 + 363)
    assert nbytes == 4 * 21 * 2 * 16384 * 128
    ms, by = tools.bound_ms(nbytes, mads)
    assert ms == pytest.approx(0.1731, abs=5e-5) and by == "operations"
    assert tools.int_ceiling_ms(mads, 1980) == pytest.approx(0.3467,
                                                             abs=5e-5)


@pytest.mark.parametrize("X", [1, 32, 64, 1024, 16384, 32768])
def test_each_launchs_work_sums_to_the_calls(X):
    """The multiply-adds of the plan's launches (tools.batch_inv_step_work,
    what phase kernels bounds each launch by) add up to the whole call's:
    every product of the tree and the one chain, once."""
    from zkfranchise_tpu_torch import tools

    steps = [tools.batch_inv_step_work(kernel, lo, k, 3, X)
             for kernel, lo, k, *_ in K.batch_inv_plan(3, X)]
    assert sum(m for _, m in steps) == batch_inv_work(3, X)[1]

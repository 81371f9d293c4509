"""The port's CUDA kernels against their plain versions on the card.

These tests need a CUDA device and skip without one.  They import neither
jax nor the JAX package, so they also run where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, lm, msm_lm, ntt
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools.fold_shapes import fold_at_inputs, \
    fold_inputs
from zkfranchise_tpu_torch.tools.padd_shapes import padd_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(kind, rng, n=16):
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    return [mul(int(k)) for k in rng.integers(1, 1 << 40, size=n)]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul(dev, field):
    fs = lm.FR if field == "fr" else lm.FQ
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 5, 21, 130),
                                     dtype=np.int32), device=dev)
    a[..., 19:, :] = 0
    b = a[0, :, :, :1]                               # lane-broadcast column
    K.reset_launches()
    got = K.mont_mul(a, b, fs)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "mont_mul": 1}
    assert torch.equal(got, K.mont_mul_ref(a, b, fs))
    assert torch.equal(K.mont_mul(a, a.flip(-1), fs),
                       K.mont_mul_ref(a, a.flip(-1), fs))


# (a shape, b shape or a view of a, field): every operand pattern the port
# launches mont_mul with (MONT_SHAPES) and more than three leading dims
MONT_PATTERNS = {
    "col": ((300, 21, 128), (300, 21, 1), "fr"),
    "const": ((300, 21, 128), (21, 1), "fr"),
    "table": ((6, 21, 130), (21, 130), "fq"),
    "full": ((300, 21, 33), (300, 21, 33), "fr"),
    "narrow": ((1000, 21, 4), (1000, 21, 1), "fr"),
    "rows_T1": ((128, 21, 1), (128, 21, 1), "fq"),
    "strided": ((128, 21, 1), "half", "fq"),
    "three_dims": ((3, 4, 5, 21, 9), (3, 1, 5, 21, 1), "fq"),
    "six_dims": ((3, 2, 5, 7, 21, 3), "sub", "fq"),
}


@pytest.mark.parametrize("pattern", sorted(MONT_PATTERNS))
def test_mont_mul_patterns(dev, pattern):
    sa, sb, field = MONT_PATTERNS[pattern]
    fs = lm.FR if field == "fr" else lm.FQ
    rng = np.random.default_rng(20)
    a = _limbs(rng, sa, dev)
    if sb == "half":                         # batch_inv's strided half
        b = _limbs(rng, (128, 21, 64), dev)[..., 32:]
    elif sb == "sub":
        b = a[:, :1, :, :1]
    else:
        b = _limbs(rng, sb, dev)
    K.reset_launches()
    got = K.mont_mul(a, b, fs)
    assert K.LAUNCHES["mont_mul"] == 1 and sum(K.MONT_SHAPES.values()) == 1
    assert torch.equal(got, K.mont_mul_ref(a, b, fs))
    assert torch.equal(K.mont_mul(b, a, fs), got)


@pytest.mark.parametrize("log_n,T", [(6, 1), (6, 4), (6, 128), (14, 4),
                                     (14, 128), (17, 16)])
def test_ntt_level_every_level(dev, log_n, T):
    """Every level of both schedules, each fed the previous output, against
    the plain version (mont_mul_ref) and the level before this kernel (the
    general mont_mul kernel); one launch a level.  (17, 16): nlevels=160
    at batch 16."""
    rng = np.random.default_rng(21)
    tabs = ntt.plan(log_n).on(str(dev))
    for sched in ("fwd", "inv"):
        gs, tws, _ = tabs[sched]
        x = lm.to_mont(_limbs(rng, (1 << log_n, 21, T), dev))
        for g, tw in zip(gs, tws):
            K.reset_launches()
            got = K.ntt_level(x, g, tw)
            assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                                  "ntt_level": 1}
            assert torch.equal(got, ntt.ntt_level_ref(x, g, tw,
                                                      mul=lm.mont_mul_ref))
            assert torch.equal(got, ntt.ntt_level_ref(x, g, tw))
            x = got


def test_ntt_on_card_equals_cpu(dev):
    rng = np.random.default_rng(22)
    x = lm.to_mont(_limbs(rng, (1 << 10, 21, 3), dev))
    K.reset_launches()
    got = ntt.coset_evals_from_domain_evals(x)
    assert K.LAUNCHES["ntt_level"] == 20
    assert torch.equal(got.cpu(), ntt.coset_evals_from_domain_evals(x.cpu()))


@pytest.mark.parametrize("T", [1, 31, 128, 129, 1000])
def test_inv_warp(dev, T):
    """A warp a lane, a zero lane, and a strided view."""
    rng = np.random.default_rng(23)
    a = _limbs(rng, (21, T), dev)
    a[:, T // 2] = 0
    K.reset_launches()
    got = K.inv(a, lm.FQ)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "inv": 1}
    assert torch.equal(got, K.inv_ref(a, lm.FQ))
    assert not got[:, T // 2].any()
    at = a.T.contiguous().T
    assert torch.equal(K.inv(at, lm.FQ), got)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ec_kernels(dev, kind):
    rng = np.random.default_rng(2)
    table = ec_lm.g1_table if kind == "g1" else ec_lm.g2_table
    proj = torch.as_tensor(table(_pool(kind, rng)).T, device=dev)
    p = K.padd_ref(proj[None], proj.flip(-1)[None], kind)
    q = K.padd_ref(proj[None].roll(3, -1), proj[None], kind)
    q[..., 1:2] = msm_lm._neg_plane(p[..., 1:2], kind)      # P + (-P)
    q[..., 2] = p[..., 2]                                   # doubling
    p[..., 3:4] = ec_lm.identity_plane(kind, (1,), 1, dev)  # O + Q
    K.reset_launches()
    assert torch.equal(K.padd(p, q, kind), K.padd_ref(p, q, kind))
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), f"padd/{kind}": 1}
    x = torch.cat([p, q], -1)
    for width in (x.shape[-1], 2):                          # down to h = 1
        assert torch.equal(K.fold_padd(x[..., :width].contiguous(), kind),
                           K.fold_padd_ref(x[..., :width], kind))
    pts = _pool(kind, rng)
    pts[1] = None
    a = torch.as_tensor(ec_affine.affine_table(pts, kind).T[None],
                        device=dev)
    a = torch.cat([a, a.flip(-1)], -1)
    assert torch.equal(K.fold_padd_aa(a, kind), K.fold_padd_aa_ref(a, kind))


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("B,T", [(1, 1), (1, 32), (1, 128), (128, 1),
                                 (128, 32), (128, 128), (3, 45)])
def test_padd_at_main_path_widths(dev, kind, B, T):
    """Widths 1, 32 and 128 with one and 128 batch rows (and a ragged
    block); identity, doubling and P + (-P) adds mixed in."""
    p, q = padd_inputs(kind, B, T, np.random.default_rng(14), dev)
    K.reset_launches()
    got = K.padd(p, q, kind)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), f"padd/{kind}": 1}
    assert K.PADD_SHAPES == {f"{kind}/B{B}/T{T}": 1}
    assert torch.equal(got, K.padd_ref(p, q, kind))


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_padd_reads_broadcast_and_strided_operands(dev, kind):
    p, q = padd_inputs(kind, 4, 40, np.random.default_rng(15), dev)
    col = q[0, :, 5:6]                      # one point for every add
    plane = q[1:2]                          # one plane for every batch row
    strided = p.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for a, b in ((p, col), (col, p), (p, plane), (p[0], q[..., 3:4]),
                 (strided, q), (p[..., ::2], q[..., 1::2])):
        assert torch.equal(K.padd(a, b, kind), K.padd_ref(a, b, kind))


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("form", ["fold", "aa"])
@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("h", [1, 33, 128, 1024])
def test_fold_forms_at_widths(dev, kind, form, B, h):
    """fold_padd and fold_padd_aa, one launch each, with identity (an
    infinity flag), doubling and P + (-P) pairs mixed in."""
    x = fold_inputs(form, kind, B, 2 * h, np.random.default_rng(16), dev)
    fn = K.fold_padd if form == "fold" else K.fold_padd_aa
    ref = K.fold_padd_ref if form == "fold" else K.fold_padd_aa_ref
    K.reset_launches()
    got = fn(x, kind)
    name = "fold_padd" if form == "fold" else "fold_padd_aa"
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), f"{name}/{kind}": 1}
    assert K.FOLD_SHAPES == {f"{name}/{kind}/B{B}/h{h}/n1": 1}
    assert torch.equal(got, ref(x, kind))


# (kind, lanes, chunk m): ragged widths, then nlevels=160's level 0 at
# batch 16 (C's chunk of 262,144 at twice its 32 lanes; A's, B1's, B2's
# chunks of 65,536 at 128)
@pytest.mark.parametrize("kind,B,m", [("g1", 1, 2), ("g2", 3, 66),
                                      ("g1", 64, 262144),
                                      ("g1", 128, 65536),
                                      ("g2", 128, 65536)])
def test_fold_padd_aa_through_the_index_equals_the_plane(dev, kind, B, m):
    """fold_padd_aa reading the [P | -P] rows through each lane's index
    equals fold_padd_aa on the plane that index gathers, limb for limb,
    with identity rows, negative digits (rows m and on), doublings and
    P + (-P) among the operands, and counts as that plane's launch."""
    table, idx = fold_at_inputs(kind, B, m, np.random.default_rng(18), dev)
    assert int((idx >= m).sum()) > 0
    K.reset_launches()
    got = K.fold_padd_aa(table, kind, idx=idx)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          f"fold_padd_aa/{kind}": 1}
    assert K.FOLD_SHAPES == {f"fold_padd_aa/{kind}/B{B}/h{m // 2}/n1": 1}
    plane = table[idx.long()].transpose(-1, -2).contiguous()
    assert torch.equal(got, K.fold_padd_aa(plane, kind))
    if m <= 66:
        assert torch.equal(got, K.fold_padd_aa_ref(plane, kind))


def test_fold_padd_aa_through_an_index_refuses_rows_outside_the_table(dev):
    """An index past the table's last row, or a negative one, raises
    IndexError before any launch, as the CPU path does."""
    table, idx = fold_at_inputs("g1", 2, 8, np.random.default_rng(19), dev)
    for bad in (table.shape[0], -1):
        out = idx.clone()
        out[1, 5] = bad
        K.reset_launches()
        with pytest.raises(IndexError):
            K.fold_padd_aa(table, "g1", idx=out)
        with pytest.raises(IndexError):
            K.fold_padd_aa(table.cpu(), "g1", idx=out.cpu())
        assert not any(K.LAUNCHES.values())
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("h", [1, 33, 128, 1024])
def test_fold_padd_levels_launches(dev, kind, B, h):
    """Every level count the width allows up to 3, and the most it allows
    (h = 1024: 11 levels, down to width 1), in one launch each, or in as
    many as it needs (G1 3 levels a launch, G2 1)."""
    m = 2 * h
    top = (m & -m).bit_length() - 1                # m % 2^n == 0 up to top
    x = fold_inputs("fold", kind, B, m, np.random.default_rng(17), dev)
    want = K.fold_padd_levels_ref(x, kind, top)
    for n in sorted({1, 2, 3, top} & set(range(1, top + 1))):
        K.reset_launches()
        got = K.fold_padd_levels(x, kind, n)
        assert K.LAUNCHES[f"fold_padd/{kind}"] == \
            -(-n // K.FOLD_LEVELS[kind])
        assert len(got) == n
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _limbs(rng, shape, dev):
    x = rng.integers(0, 1 << 13, size=shape, dtype=np.int32)
    x[..., 19:, :] = 0
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fold_mul_and_inv(dev, field):
    fs = lm.FR if field == "fr" else lm.FQ
    rng = np.random.default_rng(3)
    x = _limbs(rng, (3, 21, 260), dev)
    K.reset_launches()
    for width in (260, 2):                                  # h = 130, h = 1
        xw = x[..., :width].contiguous()
        assert torch.equal(K.fold_mul(xw, fs), K.fold_mul_ref(xw, fs))
    assert K.LAUNCHES["fold_mul"] == 2
    a = _limbs(rng, (21, 130), dev)
    a[:, 7] = 0                                             # inv(0) = 0
    got = K.inv(a, fs)
    assert K.LAUNCHES["inv"] == 1
    assert torch.equal(got, K.inv_ref(a, fs))
    assert not got[:, 7].any()
    # a transposed view is read in place and gives the same limbs
    at = a.T.contiguous().T
    assert at.stride() == (1, 21)
    assert torch.equal(K.inv(at, fs), got)
    one = lm.const(fs.one_mont, dev).expand(21, 130)
    prod = lm.from_mont(K.mont_mul(got, a, fs), fs)
    want = lm.from_mont(one.contiguous(), fs)
    want[:, 7] = 0
    assert torch.equal(prod, want)


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("width", [1, 2, 32, 64, 1024, 16384])
def test_batch_inv(dev, width, B):
    """The launches batch_inv_plan makes (fold_mul_levels counted as
    fold_mul, the top, the walks down; no inv, no mont_mul), and the
    limbs of the plain version's."""
    rng = np.random.default_rng(4)
    d = _limbs(rng, (B, 21, width), dev)
    d[..., 0, :] |= 1                                       # no zero lane
    K.reset_launches()
    got = K.batch_inv(d, lm.FQ)
    kinds = [p[0] for p in K.batch_inv_plan(B, width)]
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          "fold_mul": kinds.count("fold_mul_levels"),
                          "batch_inv/top": 1,
                          "batch_inv/down": kinds.count("down")}
    assert len(kinds) <= 6 and (len(kinds) == 1) == (width <= 32)
    assert torch.equal(got, K.batch_inv_ref(d, lm.FQ))
    if width <= 1024:
        assert torch.equal(got.cpu(), K.batch_inv(d.cpu(), lm.FQ))


def test_batch_inv_launches_take_the_plans_geometry(dev):
    """The entry points launch the columns and shared bytes they are
    given and refuse any that the kernels cannot take: too little shared
    memory for the strips (or the stage slots going down), columns other
    than 32 or 64 or wider than the launch's top level, a top kernel's
    shared bytes other than its static ones."""
    rng = np.random.default_rng(4)
    B, X = 2, 1024
    d = _limbs(rng, (B, 21, X), dev)
    d[..., 0, :] |= 1
    heap = torch.zeros_like(d)
    chains = K._chains()
    pn = K._FIELD_PN[lm.FQ.p].ctypes.data
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = K.batch_inv_plan(B, X)
    assert [p[0] for p in plan] == ["fold_mul_levels", "top", "down"]
    _, lo, k, _, _, smem = plan[0]
    cols = K.inv_cols(X, lo, k)

    def up(cols, smem):
        return chains.zk_fold_mul_levels(d.data_ptr(), heap.data_ptr(), pn,
                                         B, X, lo, k, cols, smem, stream)

    def down(cols, smem):
        return chains.zk_batch_inv_down(d.data_ptr(), heap.data_ptr(), pn,
                                        B, X, lo, k, cols, smem, stream)

    down_smem = plan[2][5]
    for bad in ((cols, smem - 4), (48, smem), (X >> (lo + k) << 1, smem)):
        assert up(*bad) != 0
    assert down(cols, down_smem - 4) != 0 and down(cols, smem) != 0
    assert up(cols, smem) == 0
    torch.cuda.synchronize()
    want = torch.zeros_like(d)
    K.fold_mul_levels_ref(d, want, lo, k, lm.FQ)
    assert torch.equal(heap, want)
    consts = K._field_consts("t", lm.FQ, dev)
    bits = lm.const(lm.FQ.p_minus_2_bits, dev)
    for smem_top, ok in ((K.INV_TOP_SMEM, True), (K.INV_TOP_SMEM + 4, False)):
        rc = chains.zk_batch_inv_top(d.data_ptr(), heap.data_ptr(),
                                     consts.data_ptr(), bits.data_ptr(),
                                     bits.shape[0], B, X, plan[1][1],
                                     smem_top, stream)
        assert (rc == 0) == ok
    torch.cuda.synchronize()


@pytest.mark.parametrize("T,iters", [(130, 0), (130, 1), (130, 5),
                                     (130, 20), (128, 364), (131072, 20)])
def test_mont_chain(dev, T, iters):
    """mm2d's body one lane a thread: a ragged last block, no product,
    inv's 364 and the tool's (21, 131072) x 20."""
    rng = np.random.default_rng(5)
    a, b = _limbs(rng, (21, T), dev), _limbs(rng, (21, T), dev)
    K.reset_launches()
    assert torch.equal(K.mont_chain(a, b, iters, lm.FQ),
                       K.mont_chain_ref(a, b, iters, lm.FQ))
    assert K.LAUNCHES["mont_chain"] == 1


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_scalar_mul(dev, kind):
    rng = np.random.default_rng(6)
    table = ec_lm.g1_table if kind == "g1" else ec_lm.g2_table
    pool = _pool(kind, rng) * 9
    pool[3] = None                                          # k * O = O
    pts = torch.as_tensor(table(pool[:130]).T.copy(), device=dev)
    pts = K.padd_ref(pts, pts.roll(1, -1), kind)            # Z != 1
    bits = rng.integers(0, 2, size=40).astype(np.int32)
    bits[:3] = (0, 1, 1)                                    # starts on a 0
    K.reset_launches()
    got = K.scalar_mul(pts, bits, kind)
    assert K.LAUNCHES[f"scalar_mul/{kind}"] == 1
    assert torch.equal(got, K.scalar_mul_ref(pts, bits, kind))
    one = K.scalar_mul(pts[:, :1].contiguous(), bits, kind)  # T = 1
    assert torch.equal(one, got[:, :1])


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("T", [1, 128, 130])
@pytest.mark.parametrize("per_lane", [False, True])
def test_scalar_mul_ladder(dev, kind, T, per_lane):
    """Shared and per-lane bits (a lane of all zeros, a lane of all ones),
    one launch; 254 bits at T = 128 (the assembly's shape), 24 otherwise."""
    rng = np.random.default_rng(16)
    table = ec_lm.g1_table if kind == "g1" else ec_lm.g2_table
    pool = (_pool(kind, rng) * 9)[:T]
    if T > 3:
        pool[3] = None                                      # k * O = O
    pts = torch.as_tensor(table(pool).T.copy(), device=dev)
    pts = K.padd_ref(pts, pts.roll(1, -1), kind)            # Z != 1
    nbits = 254 if T == 128 else 24
    bits = rng.integers(0, 2, size=(nbits, T) if per_lane else nbits)
    if per_lane and T > 2:
        bits[:, 1], bits[:, 2] = 0, 1
    bits = torch.as_tensor(bits.astype(np.int32), device=dev)
    K.reset_launches()
    got = K.scalar_mul(pts, bits, kind)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          f"scalar_mul/{kind}": 1}
    assert torch.equal(got, K.scalar_mul_ref(pts, bits, kind))


def test_assemble_stage_on_card_equals_cpu(dev):
    from zkfranchise_tpu_torch.groth16.device import assemble_stage

    rng = np.random.default_rng(17)
    B = 128
    g1 = ec_lm.g1_table(_pool("g1", rng, 2 * B + 2)).T.copy()
    g2 = ec_lm.g2_table(_pool("g2", rng, B + 1)).T.copy()

    def rows_first(x):                          # (rows, B) -> (B, rows, 1)
        return np.ascontiguousarray(x.T[:, :, None])

    def scalars():
        return lm.ints_to_lm([int.from_bytes(rng.bytes(31), "big")
                              for _ in range(B)])

    args = [rows_first(g1[:, :B]), rows_first(g1[:, B:2 * B]),
            rows_first(g2[:, :B]), rows_first(g1[:, 1:B + 1]), scalars(),
            scalars(), g1[:, 2 * B:2 * B + 1], g1[:, 2 * B + 1:], g2[:, B:]]
    K.reset_launches()
    got = assemble_stage(*(torch.as_tensor(a, device=dev) for a in args))
    assert K.LAUNCHES["scalar_mul/g1"] == 2
    want = assemble_stage(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("t", [3, 4, 5])
@pytest.mark.parametrize("T", [1, 4, 32, 128, 130])
def test_poseidon(dev, t, T):
    """The hash with its trace and the bare permutation (with a leading
    batch axis), one launch each, against the plain versions."""
    rng = np.random.default_rng(100 * t + T)
    x = lm.to_mont(torch.as_tensor(np.stack(
        [lm.ints_to_lm([int.from_bytes(rng.bytes(31), "big")
                        for _ in range(T)]) for _ in range(2 * t)])))
    x = x.to(dev)
    K.reset_launches()
    out, trace = K.poseidon_trace(x[:t - 1])
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          f"poseidon/t{t}": 1}
    want_out, want_trace = K.poseidon_trace_ref(x[:t - 1])
    assert torch.equal(out, want_out) and torch.equal(trace, want_trace)
    state = x.reshape(2, t, 21, T)
    K.reset_launches()
    got = K.permutation(state, t)
    assert K.LAUNCHES[f"poseidon/t{t}"] == 1
    assert torch.equal(got, K.permutation_ref(state, t))


# ---------------------------------------------------------------------------
# the witness's SMT chains: smt_walk's two launches (smt_fill, smt_levels)
# ---------------------------------------------------------------------------

def _smt_case(L, T, every_l, seed, device):
    """(depths, smt_chain's inputs) for two trees of T voters at L levels:
    every lane at d = L, or mixed depths with d = 0, 1, L // 2, L - 1 and L
    among the first lanes."""
    from zkfranchise_tpu_torch.tools import smt_inputs

    rng = np.random.default_rng(seed)
    depths = [L] * (2 * T) if every_l else \
        ([0, 1, L // 2, L - 1, L] +
         [int(d) for d in rng.integers(0, L + 1, 2 * T)])[:2 * T]
    return depths, smt_inputs(L, T, depths, seed, device)


@pytest.mark.parametrize("L,T,every_l", [(5, 1, False), (17, 16, False),
                                         (17, 17, False), (17, 33, False),
                                         (17, 16, True), (161, 16, False),
                                         (161, 16, True)])
def test_smt_chain_equals_the_per_level_loop(dev, L, T, every_l):
    """Roots and blocks limb for limb against the plain loop on the card
    (today's launches: a permutation and three products a level) and the
    walk's plain versions on the CPU; two launches; counts = depths."""
    depths, args = _smt_case(L, T, every_l, 10 * L + T, dev)
    K.smt_zero_table(args[0].device)            # the device's, made once
    K.reset_launches()
    root, blocks, hashed = K.smt_chain(*args)
    assert {k: v for k, v in K.LAUNCHES.items() if v} == \
        {"smt/fill": 1, "smt/levels": 1}
    assert hashed.tolist() == depths
    want_root, want_blocks, _ = K.smt_chain_ref(*args)
    assert torch.equal(root, want_root) and torch.equal(blocks, want_blocks)
    if L < 161:
        cpu_root, cpu_blocks, _ = K.smt_walk(*(a.cpu() for a in args))
        assert torch.equal(root.cpu(), cpu_root)
        assert torch.equal(blocks.cpu(), cpu_blocks)


@pytest.mark.parametrize("L,T", [(17, 17), (161, 16)])
def test_smt_fill_and_levels_equal_their_plain_versions(dev, L, T):
    """Each launch from the same block against its plain version."""
    depths, (bits, sib_plain, sib_mont, leaf, _) = _smt_case(
        L, T, False, L + T, dev)
    d = K.smt_depth(sib_plain)
    assert d.tolist() == depths
    block = torch.randint(0, 1 << 13, (2, K.smt_block_rows(L), 21, T),
                          dtype=torch.int32, device=dev)
    mine, want = block.clone(), block.clone()
    K.smt_fill(mine, bits, d, L)
    K.smt_fill_ref(want, bits, d, L)
    assert torch.equal(mine, want)
    got = K.smt_levels(mine, bits, sib_mont, leaf, d)
    ref = K.smt_levels_ref(want, bits, sib_mont, leaf, d)
    assert torch.equal(mine, want)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_smt_wrappers_refuse_what_the_kernels_do_not_take(dev):
    _, (bits, sib_plain, sib_mont, leaf, leaf_tr) = _smt_case(
        5, 2, False, 1, dev)
    with pytest.raises(ValueError):
        K.smt_chain(bits, sib_plain, sib_mont, leaf[:, :3], leaf_tr)
    with pytest.raises(ValueError):
        K.smt_chain(bits[:3], sib_plain, sib_mont, leaf, leaf_tr)
    block = torch.zeros((2, K.smt_block_rows(5) - 1, 21, 2),
                        dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.smt_fill(block, bits, K.smt_depth(sib_plain), 5)


def test_witness_at_nl160_equals_the_per_level_loop(dev, monkeypatch):
    """The whole witness at nlevels=160, 16 voters: through the two
    launches and through the plain loop on the card, equal limb for
    limb; the counts are the trees' depths."""
    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.models.census import CensusCircuit

    circuit = CensusCircuit(160)
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(160, 16, seed=7, device=dev), 160)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in arrs.items()}
    K.smt_zero_table(inputs["address"].device)  # the device's, made once
    K.reset_launches()
    w, hashed = circuit.witness_counted(inputs)
    assert K.LAUNCHES["poseidon/t3"] == 0
    assert (K.LAUNCHES["smt/fill"], K.LAUNCHES["smt/levels"]) == (1, 1)
    assert K.LAUNCHES["poseidon/t4"] == 2                 # SIK, both leaves
    depth = K.smt_depth(torch.cat([inputs["sikSiblings"],
                                   inputs["censusSiblings"]], -1))
    assert hashed.tolist() == depth.tolist()
    monkeypatch.setattr(K, "smt_chain", K.smt_chain_ref)
    want, want_hashed = circuit.witness_counted(inputs)
    assert torch.equal(w, want)
    assert want_hashed.tolist() == [161] * 32


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_fold_affine_on_card_equals_cpu(dev, kind):
    rng = np.random.default_rng(7)
    pts = _pool(kind, rng)
    grp = ec.G1 if kind == "g1" else ec.G2
    pts[1] = None
    pts[8 + 2] = pts[2]                                     # doubling
    pts[8 + 3] = grp.neg(pts[3])                            # P + (-P)
    x = torch.as_tensor(ec_affine.affine_table(pts, kind).T[None].copy())
    y = x.to(dev)
    while x.shape[-1] > 1:
        x = ec_affine.fold_affine(x, kind)
        y = ec_affine.fold_affine(y, kind)
        assert torch.equal(y.cpu(), x)


@pytest.mark.parametrize("tile,chain", [(512, 1), (100, 3), (4096, 8),
                                        (33, 0)])
def test_mm2d(dev, tile, chain):
    """Ragged edge (T not a multiple of tile), tile above and below T; a
    chain of 0 products copies a."""
    rng = np.random.default_rng(8)
    a, b = _limbs(rng, (21, 1300), dev), _limbs(rng, (21, 1300), dev)
    K.reset_launches()
    assert torch.equal(K.mm2d(a, b, tile, chain),
                       K.mm2d_ref(a, b, tile, chain))
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "mm2d": 1}


@pytest.mark.parametrize("tile,blk", [(512, 1), (100, 2), (2048, 8)])
def test_mm3d(dev, tile, blk):
    rng = np.random.default_rng(9)
    a, b = _limbs(rng, (5, 21, 700), dev), _limbs(rng, (5, 21, 700), dev)
    K.reset_launches()
    got = K.mm3d(a, b, tile, blk)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "mm3d": 1}
    assert torch.equal(got, K.mm3d_ref(a, b, tile, blk))
    assert torch.equal(got, K.mont_mul(a, b, lm.FQ))


@pytest.mark.parametrize("kind", ["g1", "g2"])
@pytest.mark.parametrize("h", [37, 64])
@pytest.mark.parametrize("tile", [1, 3, 31, 32, 33, 512])
def test_fold2d(dev, kind, tile, h):
    """Flat lane axis of B = 5 segments of m = 2h real points, with an
    identity lane, a doubling pair and an opposite pair: a block walks
    groups of 32 adds, the last one ragged where tile or h is not a
    multiple of 32; one fold2d launch and no other."""
    rng = np.random.default_rng(10)
    B, m = 5, 2 * h
    table = ec_lm.g1_table if kind == "g1" else ec_lm.g2_table
    grp = ec.G1 if kind == "g1" else ec.G2
    pts = (_pool(kind, rng) * 40)[:B * m]
    pts[1] = None
    pts[h + 2] = pts[2]
    pts[h + 3] = grp.neg(pts[3])
    x = torch.as_tensor(table(pts).T.copy(), device=dev)
    K.reset_launches()
    got = K.fold2d(x, tile, kind, m)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          f"fold2d/{kind}": 1}
    assert torch.equal(got, K.fold2d_ref(x, tile, kind, m))
    seg = x.reshape(-1, B, m).permute(1, 0, 2).contiguous()
    assert torch.equal(K.fold_padd(seg, kind).permute(1, 0, 2)
                       .reshape(-1, B * m // 2), got)


@pytest.mark.parametrize("rows,tile", [(21, 512), (24, 100), (8, 8192)])
def test_add_one(dev, rows, tile):
    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (rows, 3000),
                                     dtype=np.int64).astype(np.int32),
                        device=dev)
    a[0, 0] = 2**31 - 1                                     # wraps
    K.reset_launches()
    assert torch.equal(K.add_one(a, tile), K.add_one_ref(a, tile))
    assert K.LAUNCHES["add_one"] == 1


@pytest.mark.parametrize("T", [3001, 4099])
@pytest.mark.parametrize("tile", [1, 3, 100, 512])
def test_add_one_heads_and_tails(dev, tile, T):
    """T not a multiple of 4: rows start off a 16-byte boundary, so each
    block's rows have scalar heads and tails around the int4 body; and a
    view one int off the output's alignment takes the scalar path."""
    rng = np.random.default_rng(16)
    flat = torch.as_tensor(rng.integers(-2**31, 2**31, 21 * T + 1,
                                        dtype=np.int64).astype(np.int32),
                           device=dev)
    flat[T + 7] = 2**31 - 1                                 # wraps
    for a in (flat[:21 * T].view(21, T), flat[1:].view(21, T)):
        K.reset_launches()
        assert torch.equal(K.add_one(a, tile), K.add_one_ref(a, tile))
        assert K.LAUNCHES["add_one"] == 1


@pytest.mark.parametrize("m", [2, 1024, 1 << 16, 1 << 18])
def test_fused_upsweep_is_one_launch(dev, m):
    """Below, at and above the width that fits in shared memory."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.integers(-2**31, 2**31, (7, m),
                                     dtype=np.int64).astype(np.int32),
                        device=dev)
    K.reset_launches()
    got = K.fused_upsweep(x)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "fused_upsweep": 1}
    assert got.shape == (7, m - 1)
    assert torch.equal(got, K.fused_upsweep_ref(x))


def test_layout_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = _limbs(np.random.default_rng(13), (21, 64), dev)
    with pytest.raises(ValueError):
        K.mm2d(a, a[:, :32], 16, 1)
    with pytest.raises(ValueError):
        K.mm3d(a, a, 16, 1)                                 # not (B, 21, T)
    with pytest.raises(ValueError):
        K.mm2d(a, a.cpu(), 16, 1)
    with pytest.raises(ValueError):
        K.mm2d(a, a, 0, 1)                                  # tile < 1
    with pytest.raises(TypeError):
        K.fused_upsweep(a[:, :16].float())


# ---------------------------------------------------------------------------
# the proving step captured as one CUDA graph (groth16.device.FusedStep)
# ---------------------------------------------------------------------------

FUSED_NL = 4


@pytest.fixture(scope="module")
def fused_prover():
    """(prover, voters) at nlevels=4: a DeviceProver keyed from the
    committed dev/4 key, and voters(seeds) -> the inputs of two voters a
    seed side by side on the lane axis (a tree of depth 4 holds few
    random keys): every input is per lane."""
    import pathlib

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    pk = gsetup.ProvingKey.load(
        pathlib.Path(__file__).resolve().parent.parent / "artifacts" /
        "zkCensus" / "dev" / str(FUSED_NL) / "proving_key.pkl")
    prover = DeviceProver(CensusCircuit(FUSED_NL), pk, device=dev)

    def voters(seeds):
        parts = [inp.batch_to_arrays(inp.mock_batch(
            FUSED_NL, 2, seed=seed, device=dev), FUSED_NL) for seed in seeds]
        return {k: np.concatenate([p[k] for p in parts], -1)
                for k in parts[0]}
    return prover, voters


@pytest.fixture(scope="module")
def fused_steps(fused_prover):
    """batch -> (prover, FusedStep, two input sets, two (r, s) pairs) at
    nlevels=4, keyed from the committed dev/4 key; built once a batch."""
    from zkfranchise_tpu_torch.groth16.device import draw_rs

    prover, voters = fused_prover
    dev = prover.device
    cache = {}

    def get(B):
        if B not in cache:
            n = B // 2
            sets = [voters(range(1, n + 1)), voters(range(n + 1, B + 1))]
            rs = [tuple(torch.as_tensor(x, device=dev)
                        for x in draw_rs(seed, B)) for seed in (5, 6)]
            cache[B] = (prover, prover.capture(B, cut=False), sets, rs)
        return cache[B]
    return get


@pytest.mark.parametrize("B", [2, 8])
def test_fused_step_replay_equals_prove_arrays(fused_steps, B):
    prover, step, sets, rs = fused_steps(B)
    for arrs, (r, s) in zip(sets, rs):
        got = step(arrs, r, s)
        want = prover.prove_arrays(arrs, r, s)
        assert [tuple(g.shape) for g in got] == [(63, B), (126, B), (63, B),
                                                 (8, 21, B), (2 * B,)]
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("B", [2, 8])
def test_fused_step_clones_survive_the_next_replay(fused_steps, B):
    _, step, sets, rs = fused_steps(B)
    first = step(sets[0], *rs[0])
    kept = [g.clone() for g in first]
    second = step(sets[1], *rs[1])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("B", [2, 8])
def test_fused_step_refuses_other_shapes(fused_steps, B):
    _, step, sets, rs = fused_steps(B)
    narrow = {k: v[..., :B - 1] for k, v in sets[0].items()}
    with pytest.raises(ValueError, match="step inputs"):
        step(narrow, *rs[0])
    with pytest.raises(ValueError, match="step inputs"):
        step(sets[0], rs[0][0][:, :1], rs[0][1])
    with pytest.raises(ValueError, match="step inputs"):
        step({**sets[0], "address": sets[0]["address"].astype(np.int64)},
             *rs[0])


@pytest.mark.parametrize("B", [2, 8])
def test_fused_step_captures_prove_arrays_launches(fused_steps, B):
    prover, step, sets, rs = fused_steps(B)
    K.reset_launches()
    prover.prove_arrays(sets[0], *rs[0])
    assert step.launches == {k: v for k, v in K.LAUNCHES.items() if v}
    K.reset_launches()
    step(sets[0], *rs[0])
    assert not any(K.LAUNCHES.values())            # a replay ticks none


def test_captured_fold_launches_follow_the_msm_plan(fused_prover):
    """A capture (its warm-up and the captured run) launches the folds
    msm_lm.msm_fold_launches plans for the four tables, twice."""
    prover, _ = fused_prover
    planned: dict = {}
    for tab, kind in ((prover.a_tab, "g1"), (prover.b1_tab, "g1"),
                      (prover.b2_tab, "g2"), (prover.c_tab, "g1")):
        for key, v in msm_lm.msm_fold_launches(tab.shape[0], 4, kind,
                                               prover.window_group).items():
            planned[key] = planned.get(key, 0) + 2 * v
    K.reset_launches()
    prover.capture(4, cut=False)
    assert K.FOLD_SHAPES == planned


def test_fused_step_prove_batch_equals_prove_batch(fused_steps):
    prover, step, sets, _ = fused_steps(2)
    got = step.prove_batch(sets[1], seed=9)
    want = prover.prove_batch(sets[1], seed=9)
    assert [p.to_dict() for p in got[0]] == [p.to_dict() for p in want[0]]
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# the stream's prover on captured steps (groth16.device.ReplayProver)
# ---------------------------------------------------------------------------

def _replay_case(prover, voters, B, seed):
    """(inputs, r, s, prove_arrays' planes) for B (even) voters, from the
    mock batches of seeds seed .. seed + B/2 - 1."""
    from zkfranchise_tpu_torch.groth16.device import draw_rs

    arrs = voters(range(seed, seed + B // 2))
    r, s = (torch.as_tensor(x, device=prover.device)
            for x in draw_rs(seed, B))
    return arrs, r, s, prover.prove_arrays(arrs, r, s)


def test_replay_prover_sizes_in_one_pool_replay_in_any_order(fused_prover):
    from zkfranchise_tpu_torch.groth16.device import ReplayProver

    prover, voters = fused_prover
    replay = ReplayProver(prover)
    cases = {B: _replay_case(prover, voters, B, seed)
             for B, seed in ((2, 1), (4, 3), (8, 5))}
    for B in (2, 4, 8):                  # captured in this order
        replay.step(B)
    assert list(replay.steps) == [(2, False), (4, False), (8, False)]
    assert all(st.pool is replay.pool for st in replay.steps.values())
    assert all(st.launches for st in replay.steps.values())
    got = []
    for B in (8, 2, 4, 8, 2):            # and replayed in another
        arrs, r, s, want = cases[B]
        planes = replay.step(B)(arrs, r, s)
        assert all(torch.equal(g, w) for g, w in zip(planes, want)), B
        got.append((B, planes))
    # every clone survives the replays of the other sizes after it
    for B, planes in got:
        assert all(torch.equal(g, w) for g, w in zip(planes, cases[B][3]))
    assert list(replay.steps) == [(2, False), (4, False), (8, False)]


def test_replay_prover_stream_equals_eager_stream(fused_prover, tmp_path):
    import io

    from zkfranchise_tpu_torch import inputs as inp
    from zkfranchise_tpu_torch.groth16.device import ReplayProver
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    prover, _ = fused_prover
    voters = [v for seed in (1, 2, 3) for v in inp.mock_batch(
        FUSED_NL, 2, seed=seed, device=prover.device)][:5]
    replay = ReplayProver(prover)
    trees = []
    for p, name in ((replay, "graph"), (prover, "eager")):
        stream = ProofStream(p, tmp_path / name, batch_size=4,
                             metrics=Metrics(io.StringIO()))
        assert stream.run(voters, seed=3) == 5 and stream.cursor == 5
        root = tmp_path / name
        trees.append({str(f.relative_to(root)): f.read_bytes()
                      for f in sorted(root.rglob("*")) if f.is_file()})
    assert list(replay.steps) == [(4, False), (1, False)]
    assert trees[0] == trees[1] and len(trees[0]) == 2 * 5 + 1


def test_replay_prover_on_an_ingested_zkey(fused_prover):
    import json
    import pathlib

    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import (DeviceProver,
                                                      ReplayProver)
    from zkfranchise_tpu_torch.utils import serialize, zkey_compat

    prover, voters = fused_prover
    art = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
        "zkCensus" / "dev" / str(FUSED_NL)
    cs = prover.circuit.cs
    z = zkey_compat.zkey_from_pk(
        cs, gsetup.ProvingKey.load(art / "proving_key.pkl"),
        gverify.VerifyingKey(json.loads(
            (art / "verification_key.json").read_text())))
    data = serialize.write_zkey(zkey_compat.export_in_ordering(
        z, zkey_compat.census_circom_perm(cs)))
    zpk, _, arrays = zkey_compat.ingest_zkey(data, cs=cs,
                                             ordering="census-circom")
    assert "c" not in arrays                    # the A/B-only quotient
    zprover = DeviceProver(prover.circuit, zpk, arrays=arrays,
                           device=prover.device)
    replay = ReplayProver(zprover)
    arrs, r, s, want = _replay_case(zprover, voters, 4, 2)
    K.reset_launches()
    zprover.prove_arrays(arrs, r, s)
    eager = {k: v for k, v in K.LAUNCHES.items() if v}
    got = replay.step(4)(arrs, r, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert replay.steps[4, False].launches == eager
    proofs, pubs = replay.prove_batch(arrs, seed=9)
    wproofs, wpubs = zprover.prove_batch(arrs, seed=9)
    assert [p.to_dict() for p in proofs] == [p.to_dict() for p in wproofs]
    assert pubs == wpubs


# ---------------------------------------------------------------------------
# the trusted-setup path: ops/ec_batch.py, groth16/ceremony.py,
# groth16/contribute.py and the two entry tools on the card
# ---------------------------------------------------------------------------

def _host_points(kind, n, seed, none_at=()):
    import random

    from zkfranchise_tpu_torch.utils import native

    rng = random.Random(seed)
    fixed = native.g1_fixed_base_mul if kind == "g1" else \
        native.g2_fixed_base_mul
    pts = fixed([rng.randrange(1, ec.R_ORDER) for _ in range(n)])
    return [None if i in none_at else p for i, p in enumerate(pts)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ec_ntt_plane_matches_native(dev, kind):
    from zkfranchise_tpu_torch.groth16 import ceremony, poly
    from zkfranchise_tpu_torch.ops import ec_batch, ff

    n = 1 << 10
    root = ff.inv_mod(poly.root_of_unity(10), ff.P_FR)
    pts = _host_points(kind, n, seed=1, none_at=(3, 700))
    K.reset_launches()
    got = ec_batch.to_affine(ec_batch.ec_ntt_plane(
        ec_batch.to_plane(pts, kind, dev), root, kind), kind)
    assert K.LAUNCHES[f"scalar_mul/{kind}"] == 10
    assert K.LAUNCHES[f"padd/{kind}"] == 20
    scale, add, neg, _ = ceremony._HOST[kind]
    assert got == ceremony._ec_ntt(pts, root, scale, add, neg)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_segsum_plane_long_segment_and_empty_ids(dev, kind):
    from zkfranchise_tpu_torch.ops import ec_batch
    from zkfranchise_tpu_torch.utils import native

    rng = np.random.default_rng(2)
    ids = np.concatenate([np.full(1100, 4), rng.integers(6, 40, 300),
                          [0, 2, 2]])
    rng.shuffle(ids)
    pts = _host_points(kind, ids.size, seed=2, none_at=(5,))
    plane = ec_batch.to_plane(pts, kind, dev)
    got = ec_batch.to_affine(ec_batch.segsum_plane(plane, ids, 45, kind),
                             kind)
    segsum = native.g1_segsum if kind == "g1" else native.g2_segsum
    assert got == segsum(pts, ids.tolist(), 45)
    assert got[1] is None and got[44] is None


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_scale_plane_per_lane_shared_and_identity(dev, kind):
    from zkfranchise_tpu_torch.ops import ec_batch, ff
    from zkfranchise_tpu_torch.utils import native

    pts = _host_points(kind, 300, seed=3, none_at=(0, 131))
    rng = np.random.default_rng(3)
    scalars = [int.from_bytes(rng.bytes(32), "big") % ff.P_FR
               for _ in range(300)]
    scalars[7] = 0
    scale = native.g1_scale_batch if kind == "g1" else native.g2_scale_batch
    plane = ec_batch.to_plane(pts, kind, dev)
    K.reset_launches()
    got = ec_batch.to_affine(ec_batch.scale_plane(plane, scalars, kind),
                             kind)
    shared = ec_batch.to_affine(ec_batch.scale_plane(plane, scalars[1],
                                                     kind), kind)
    assert K.LAUNCHES[f"scalar_mul/{kind}"] == 2
    assert got == scale(scalars, pts)
    assert shared == scale([scalars[1]] * 300, pts)
    assert got[0] is None and got[7] is None and got[131] is None
    # the plane route's own plain version on the same plane
    want = K.scalar_mul_ref(plane[:, :4].cpu(), torch.as_tensor(
        ec_batch.scalar_bits(scalars[:4])), kind)
    assert torch.equal(K.scalar_mul(plane[:, :4].contiguous(),
                                    torch.as_tensor(ec_batch.scalar_bits(
                                        scalars[:4]), device=dev),
                                    kind).cpu(), want)


def test_pk_from_ptau_census4_equals_dev_setup(dev):
    from zkfranchise_tpu_torch.groth16 import ceremony, qap
    from zkfranchise_tpu_torch.groth16 import setup as gsetup
    from zkfranchise_tpu_torch.models.census import CensusCircuit

    cs = CensusCircuit(4).cs
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    ptau = ceremony.dev_ptau(n.bit_length())
    K.reset_launches()
    seconds = {}
    pk, vk = ceremony.pk_from_ptau(ptau, cs, device=dev, seconds=seconds)
    assert K.LAUNCHES["scalar_mul/g1"] and K.LAUNCHES["scalar_mul/g2"]
    assert K.LAUNCHES["padd/g1"] and K.LAUNCHES["mont_mul"]
    pk2, vk2 = gsetup.dev_setup(cs)
    for f in ceremony.PK_FIELDS:
        assert getattr(pk, f) == getattr(pk2, f), f
    assert vk.to_dict() == vk2.to_dict()
    assert "intt_h" in seconds and "convert_out" in seconds


def test_phase1_contribute_power10_equals_cpu_route(dev):
    from zkfranchise_tpu_torch.groth16 import ceremony, contribute

    p0 = ceremony.dev_ptau(10)
    got, con = contribute.phase1_contribute(p0, b"e", contribute.GENESIS,
                                            device=dev)
    want, con2 = contribute.phase1_contribute(p0, b"e", contribute.GENESIS,
                                              device="cpu")
    for f in ("tau_g1", "tau_g2", "alpha_tau_g1", "beta_tau_g1", "beta_g2"):
        assert getattr(got, f) == getattr(want, f), f
    assert con.new_hash == con2.new_hash and con.after == con2.after


def test_entry_tools_write_only_into_out(dev, tmp_path):
    import pathlib

    from zkfranchise_tpu_torch.tools import client_prove, compile_circuit

    root = pathlib.Path(__file__).resolve().parent.parent / "artifacts"

    def state():
        return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
                for p in sorted(root.rglob("*")) if p.is_file()}

    before = state()
    assert compile_circuit.main(["--out", str(tmp_path / "c"),
                                 "--nlevels", "4"]) == 0
    key = tmp_path / "c" / "zkCensus" / "dev" / "4"
    assert client_prove.main(["--out", str(tmp_path / "p"), "--key-dir",
                              str(key), "--nlevels", "4"]) == 0
    assert state() == before
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "inputs_example.json", "proof.json", "signals.json"]


# ---------------------------------------------------------------------------
# the parallel layer: ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def test_coset_evals_dist_two_ranks_on_the_card(dev):
    """intt_dist / ntt_dist / coset_evals_dist on 2 gloo ranks sharing the
    card at n = 2^10, T = 128, gathered, equal the local ntt on the card."""
    from zkfranchise_tpu_torch.parallel import jobs, launch

    K.build()                       # once here; the ranks only load them
    x = jobs.random_plane(1 << 10, 128, 3)
    res = launch.run(jobs.ntt_job, 2, backend="gloo", timeout_s=300,
                     args=(x, 10, "cuda", False))
    assert res[0]["inverse_equal"] and res[0]["roundtrip_equal"] \
        and res[0]["coset_equal"]


def test_sharded_prover_1x2_equals_device_prover(dev):
    """ShardedProver on a (1, 2) mesh of 2 gloo ranks sharing the card, at
    nlevels=4 from the committed dev/4 key: proof JSON byte-equal to
    DeviceProver.prove_batch on the card for the same seed."""
    import json
    import pathlib

    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.groth16 import setup as tsetup
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit
    from zkfranchise_tpu_torch.parallel import jobs, launch

    art = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
        "zkCensus" / "dev" / "4"
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(4, 4, seed=1, device=dev), 4)
    K.build()
    res = launch.run(jobs.prove_job, 2, backend="gloo", timeout_s=300,
                     args=(str(art / "proving_key.pkl"), 4, arrs, 3, 2,
                           "cuda"))
    assert [r["mesh"] for r in res] == [{"data": 1, "model": 2}] * 2
    assert res[0]["launches"]["mont_mul"] and res[1]["launches"]["padd/g1"]
    prover = DeviceProver(CensusCircuit(4), tsetup.ProvingKey.load(
        art / "proving_key.pkl"), device=dev)
    proofs, pubs = prover.prove_batch(arrs, seed=3)
    assert res[0]["proofs"] == [json.dumps(p.to_dict()) for p in proofs]
    assert res[0]["publics"] == pubs


def test_sharded_step_captured_1x2_equals_eager_and_device_prover(dev):
    """prove_job with the capture (ShardedProver.capture) on a (1, 2) mesh
    of 2 gloo ranks sharing the card, at nlevels=4 from the committed
    dev/4 key: for two seeds the replay's proof JSON equals the eager
    sharded step's and DeviceProver.prove_batch's; one graph more than
    collectives; the capture's launches by kernel equal one eager step's;
    a mismatched input raises."""
    import functools
    import json
    import pathlib

    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.groth16 import setup as tsetup
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit
    from zkfranchise_tpu_torch.parallel import jobs, launch

    art = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
        "zkCensus" / "dev" / "4"
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(4, 4, seed=1, device=dev), 4)
    K.build()
    prover = DeviceProver(CensusCircuit(4), tsetup.ProvingKey.load(
        art / "proving_key.pkl"), device=dev)
    for seed in (3, 4):
        res = launch.run(functools.partial(jobs.prove_job, capture=True), 2,
                         backend="gloo", timeout_s=300,
                         args=(str(art / "proving_key.pkl"), 4, arrs, seed,
                               2, "cuda"))
        for r in res:
            cap = r["capture"]
            assert len(cap["schedule"]) == 17
            assert cap["stretches"] == len(cap["schedule"]) + 1
            assert cap["launches"] == cap["eager_launches"]
            assert cap["launches"]["mont_mul"] and cap["launches"]["padd/g2"]
            assert "step inputs: password" in cap["mismatch"]
        proofs, pubs = prover.prove_batch(arrs, seed=seed)
        want = [json.dumps(p.to_dict()) for p in proofs]
        assert res[0]["proofs"] == want and res[0]["publics"] == pubs
        assert res[0]["replay_proofs"] == want
        assert res[0]["replay_publics"] == pubs


# ---------------------------------------------------------------------------
# nlevels=160 at batch 16, the package's default configuration
# ---------------------------------------------------------------------------

NL160, B160 = 160, 16


@pytest.fixture(scope="module")
def nl160():
    """(prover, arrays) at nlevels=160: a DeviceProver on the card keyed
    from the dev setup (its vk is the committed dev/160 one), and the
    circuit's exported R1CS arrays (numpy)."""
    from zkfranchise_tpu_torch.groth16 import qap
    from zkfranchise_tpu_torch.groth16 import setup as tsetup
    from zkfranchise_tpu_torch.groth16.device import DeviceProver
    from zkfranchise_tpu_torch.models.census import CensusCircuit

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    circuit = CensusCircuit(NL160)
    cs = circuit.cs
    arrays = cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public))
    pk, _ = tsetup.dev_setup(cs)
    return DeviceProver(circuit, pk, arrays=arrays,
                        device=torch.device("cuda")), arrays


@pytest.mark.parametrize("matrix,T", [("a", B160), ("b", 2)])
def test_chunked_spmv_on_card_equals_cpu(nl160, matrix, T):
    """A and B at 160 take spmv's chunked branch (6 and 11 chunks); A at
    the path's 16 lanes (chip_smoke.py holds it against the plain version
    on the card: on the host it takes 30-50 s)."""
    from zkfranchise_tpu_torch.ops import sparse

    prover, arrays = nl160
    rows, cols, coeffs = arrays[matrix]
    assert rows.shape[0] > 2 * sparse.MAX_NNZ_CHUNK
    n = prover.pk_meta[2]
    w = _limbs(np.random.default_rng(160), (prover.pk_meta[0], 21, T),
               "cpu")
    want = sparse.spmv(torch.as_tensor(rows).long(),
                       torch.as_tensor(cols).long(),
                       torch.as_tensor(np.ascontiguousarray(coeffs)), n, w)
    K.reset_launches()
    got = sparse.spmv(*prover._arrays_dev[matrix], n, w.to(prover.device))
    assert K.LAUNCHES["mont_mul"] == -(-rows.shape[0] //
                                       sparse.MAX_NNZ_CHUNK)
    assert torch.equal(got.cpu(), want)


def test_nl160_captured_step_equals_eager(nl160):
    """The 160 step at batch 16 captured through ReplayProver: proofs equal
    to the eager prove_batch's byte for byte, launches equal to one
    prove_arrays'."""
    import json

    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.groth16.device import ReplayProver, draw_rs

    prover, _ = nl160
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL160, B160, seed=7, device=prover.device), NL160)
    replay = ReplayProver(prover)
    got, got_pubs = replay.prove_batch(arrs, seed=1)
    want, want_pubs = prover.prove_batch(arrs, seed=1)
    assert [json.dumps(p.to_dict()) for p in got] == \
        [json.dumps(p.to_dict()) for p in want]
    assert got_pubs == want_pubs
    K.reset_launches()
    prover.prove_arrays(arrs, *(torch.as_tensor(x, device=prover.device)
                                for x in draw_rs(1, B160)))
    assert replay.steps[B160, True].launches == \
        {k: v for k, v in K.LAUNCHES.items() if v}


def test_nl160_replay_stream_equals_eager_stream(nl160, tmp_path):
    """The default deployment's stream (batch 16) over 7 voters: the tail
    ladder 4, 2, 1 on steps captured at 160 in one pool, its files byte-equal
    to the eager stream's."""
    import io

    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.groth16.device import ReplayProver
    from zkfranchise_tpu_torch.stream import ProofStream
    from zkfranchise_tpu_torch.utils.metrics import Metrics

    prover, _ = nl160
    voters = tinputs.mock_batch(NL160, 7, seed=5, device=prover.device)
    replay = ReplayProver(prover)
    trees = []
    for p, name in ((replay, "graph"), (prover, "eager")):
        stream = ProofStream(p, tmp_path / name, batch_size=B160,
                             metrics=Metrics(io.StringIO()))
        assert stream.run(voters, seed=3) == 7 and stream.cursor == 7
        root = tmp_path / name
        trees.append({str(f.relative_to(root)): f.read_bytes()
                      for f in sorted(root.rglob("*")) if f.is_file()})
    assert list(replay.steps) == [(4, True), (2, True), (1, True)]
    assert trees[0] == trees[1] and len(trees[0]) == 2 * 7 + 1


# ---------------------------------------------------------------------------
# the cut tables at nlevels=160 (groth16.device.SmtCut)
# ---------------------------------------------------------------------------

def _texts(proofs):
    import json

    return [json.dumps(p.to_dict()) for p in proofs]


@pytest.fixture(scope="module")
def nl160_steps(nl160):
    """(the shallow mock batch's arrays, the step captured on the cut
    tables, the step captured on the full ones) at batch 16."""
    from zkfranchise_tpu_torch import inputs as tinputs

    prover, _ = nl160
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL160, B160, seed=7, device=prover.device), NL160)
    return arrs, prover.capture(B160, cut=True), \
        prover.capture(B160, cut=False)


def test_nl160_cut_tables_and_their_captured_folds(nl160, nl160_steps):
    """The tables without the SMT levels 160 .. 65 of both trees: A 34,341
    rows, B 23,332, C 165,404, so 256,000 G1 and 24,576 G2 leaves a window
    (280,576 of the full tables' 475,136); the cut capture launches the
    folds msm_lm.msm_fold_launches plans for them, twice (warm-up and
    capture)."""
    prover, _ = nl160
    _, cut, full = nl160_steps
    assert prover.cut.depth == 64 and cut.cut and not full.cut
    rows = prover.msm_rows(cut=True)
    assert {k: r for k, (r, _) in rows.items()} == \
        {"a": 34341, "b1": 23332, "b2": 23332, "c": 165404}
    assert prover.msm_leaves(cut=True) == {"msm_leaves": 280576,
                                           "msm_leaves_full": 475136}
    planned: dict = {}
    for n, kind in rows.values():
        for key, v in msm_lm.msm_fold_launches(n, B160, kind,
                                               prover.window_group).items():
            planned[key] = planned.get(key, 0) + 2 * v
    K.reset_launches()
    step = prover.capture(B160, cut=True)
    assert K.FOLD_SHAPES == planned
    del step


@pytest.mark.parametrize("seed", [1, 2])
def test_nl160_cut_step_proofs_equal_the_full_steps(nl160, nl160_steps,
                                                     seed):
    """At batch 16 the captured step on the cut tables and the one on the
    full tables give the same proofs and signals byte for byte, and so do
    the eager prove_batch (which takes the cut) and prove_arrays on the full
    tables."""
    from zkfranchise_tpu_torch.groth16.device import draw_rs

    prover, _ = nl160
    arrs, cut, full = nl160_steps
    assert prover.takes_cut(arrs)
    got, got_pubs = cut.prove_batch(arrs, seed=seed)
    want, want_pubs = full.prove_batch(arrs, seed=seed)
    assert _texts(got) == _texts(want) and got_pubs == want_pubs
    eager, eager_pubs = prover.prove_batch(arrs, seed=seed)
    planes = prover.prove_arrays(arrs, *(torch.as_tensor(
        x, device=prover.device) for x in draw_rs(seed, B160)), cut=False)
    plain, plain_pubs = prover.finalize(*planes[:4])
    assert _texts(eager) == _texts(want) == _texts(plain)
    assert eager_pubs == want_pubs == plain_pubs


def test_nl160_deep_voter_takes_the_full_step(nl160, nl160_steps):
    """A slice with two leaves at depth 101: the host's test sends it to
    the full tables, ReplayProver captures and replays the full step there
    (after the cut one of a shallow slice), its proofs equal the eager
    prover's and verify; the cut step refuses the slice, and a cut step
    forced on it is stopped by finish's guard."""
    import json
    import pathlib

    from zkfranchise_tpu_torch import inputs as tinputs
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.groth16.device import ReplayProver, draw_rs
    from zkfranchise_tpu_torch.tools import deep_pair_batch

    prover, _ = nl160
    shallow, cut, _ = nl160_steps
    dev = prover.device
    arrs = tinputs.batch_to_arrays(
        deep_pair_batch(NL160, B160, 100, 11, dev), NL160)
    depth = K.smt_depth(torch.as_tensor(np.concatenate(
        [arrs["sikSiblings"], arrs["censusSiblings"]], -1)))
    assert depth.max() == 101 and (depth > 64).sum() == 4
    assert not prover.takes_cut(arrs) and prover.takes_cut(shallow)
    replay = ReplayProver(prover)
    replay.prove_batch(shallow, seed=1)
    got, got_pubs = replay.prove_batch(arrs, seed=3)
    assert list(replay.steps) == [(B160, True), (B160, False)]
    want, want_pubs = prover.prove_batch(arrs, seed=3)
    assert _texts(got) == _texts(want) and got_pubs == want_pubs
    vk = gverify.VerifyingKey(json.loads((
        pathlib.Path(__file__).resolve().parent.parent / "artifacts" /
        "zkCensus" / "dev" / str(NL160) / "verification_key.json")
        .read_text()))
    assert all(gverify.verify(vk, got[i], got_pubs[i]) for i in (0, 1))
    r, s = (torch.as_tensor(x, device=dev) for x in draw_rs(3, B160))
    with pytest.raises(ValueError, match="cut tables"):
        cut(arrs, r, s)
    *planes, hashed = prover.prove_arrays(arrs, r, s, cut=True)
    with pytest.raises(RuntimeError, match="smt cut"):
        prover.finish(planes, hashed, True)

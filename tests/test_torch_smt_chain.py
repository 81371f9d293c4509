"""The witness's SMT chains (ops/cuda/lm_kernels.py smt_chain): the card's
algorithm, smt_walk, run here on its plain versions (the zero-level table
and smt_fill_ref, the walk over the levels above each lane's leaf in
smt_levels_ref), held limb for limb against the per-level loop
(smt_chain_ref, the plain version) and, through the witness, against the
JAX package.  Integer arithmetic throughout: exact comparisons."""
import io
import json

import jax
import numpy as np
import pytest
import torch

from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16.device import smt_counts
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
from zkfranchise_tpu_torch.tools import smt_inputs
from zkfranchise_tpu_torch.utils import metrics

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)


def _depths(L: int, lanes: int, first: list, seed: int) -> list:
    """`first`, then random depths up to L, for `lanes` lanes."""
    rng = np.random.default_rng(seed)
    rest = [int(d) for d in rng.integers(0, L + 1, lanes)]
    return (first + rest)[:lanes]


# (nlevels, T, the first lanes' depths); two trees, so 2 T lanes
CASES = [
    (4, 1, [0, 1]),
    (4, 1, [4, 5]),                  # d = L - 1 and d = L
    (4, 5, [0, 1, 2, 4, 5]),
    (4, 16, [0, 1, 3, 4, 5, 5, 0]),
    (16, 5, [0, 1, 8, 16, 17]),
    # the deployment's shape at the depths of real trees: the loop hashes
    # all 161 levels, the walk the deepest lane's 20
    (160, 16, [0, 1, 20, 14, 9, 11]),
]


@pytest.mark.parametrize("nlevels,T,first", CASES)
def test_walk_equals_the_per_level_loop(nlevels, T, first):
    L = nlevels + 1
    top = L if nlevels < 160 else 20
    depths = _depths(top, 2 * T, first, 10 * nlevels + T)
    bits, sib_plain, sib_mont, leaf, leaf_tr = args = smt_inputs(
        L, T, depths, nlevels + T)
    K.reset_launches()
    root, blocks, hashed = K.smt_walk(*args)
    want_root, want_blocks, want_hashed = K.smt_chain_ref(*args)
    assert blocks.shape == (2 * K.smt_block_rows(L), 21, T)
    assert torch.equal(blocks, want_blocks)
    assert torch.equal(root, want_root)
    assert hashed.tolist() == depths
    assert sum(hashed.tolist()) == sum(depths)
    assert want_hashed.tolist() == [L] * (2 * T)
    assert not any(K.LAUNCHES.values())               # CPU: no kernels
    # what the case covers: zero levels under either key bit, and a zero
    # sibling under a nonzero one
    zero_bits = {int(bits[i, g % T]) for g, d in enumerate(depths)
                 for i in range(d, L)}
    if len(depths) >= 5:
        assert zero_bits == {0, 1}
        assert any(int(sib_plain[i, :, g].abs().sum()) == 0
                   for g, d in enumerate(depths) for i in range(d - 1))


def test_zero_table_holds_the_loops_rows_of_a_leaf_at_the_root():
    """A lane of depth 0 takes every level from the table (m1 of level 0
    aside, which is leaf R): the loop's rows of the top level and of one
    below it, for either key bit, are the table's four entries."""
    L, T = 3, 2
    bits, *rest = args = smt_inputs(L, T, [0] * (2 * T), 5)
    bits[:L] = torch.tensor([[0, 1], [0, 1], [1, 0]], dtype=torch.int32)
    _, blocks, _ = K.smt_chain_ref(bits, *rest)
    table = K.smt_zero_table(torch.device("cpu"))
    lr, head = K.smt_level_rows(), K.smt_head_rows(L)
    assert table.shape == (4, lr, 21) and lr == 246
    for v in range(T):
        for j, i in ((0, L - 1), (1, L - 2)):
            level = blocks[head + j * lr:head + (j + 1) * lr, :, v]
            assert torch.equal(level, table[2 * j + int(bits[i, v])])


def test_dispatch_on_the_cpu_runs_the_loop():
    args = smt_inputs(5, 2, [0, 5, 3, 1], 7)
    K.reset_launches()
    got = K.smt_chain(*args)
    want = K.smt_chain_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(K.LAUNCHES.values())


NL = 4


@pytest.fixture(scope="module")
def arrs():
    return tinputs.batch_to_arrays(tinputs.mock_batch(NL, 2, seed=3,
                                                      device="cpu"), NL)


def test_witness_through_the_walk_equals_jax(arrs, monkeypatch):
    """CensusCircuit.witness with the card's algorithm in place of the
    loop, against the JAX package's witness; the counts are the trees'
    depths, SIK tree first."""
    circuit = CensusCircuit(NL)
    inputs = {k: torch.as_tensor(v) for k, v in arrs.items()}
    monkeypatch.setattr(K, "smt_chain", K.smt_walk)
    w, hashed = circuit.witness_counted(inputs)
    want = jax.jit(JaxCircuit(NL).witness)(arrs)
    assert np.array_equal(np.asarray(want), w.numpy())
    depth = K.smt_depth(torch.cat([inputs["sikSiblings"],
                                   inputs["censusSiblings"]], -1))
    assert hashed.tolist() == depth.tolist()


def test_smt_counts_and_the_finalize_record():
    """The step's note on its step.finalize record: the levels hashed and
    the levels there are; a span inside it does not carry them."""
    hashed = torch.tensor([3, 0, 161, 12], dtype=torch.int32)
    assert smt_counts(hashed, 160) == {"smt_hashed": 176, "smt_levels": 644}
    buf = io.StringIO()
    m = metrics.Metrics(sink=buf)
    with metrics.recording(m):
        with m.stage("prove_batch", base=0, batch=2):
            with metrics.span("step.finalize"):
                with metrics.span("inner"):
                    metrics.note(other=1)
                metrics.note(**smt_counts(hashed, 160))
    metrics.note(nowhere=1)                     # outside a span: dropped
    inner, fin, stage = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert fin["name"] == "step.finalize" and fin["batch"] == 2
    assert (fin["smt_hashed"], fin["smt_levels"]) == (176, 644)
    assert inner["other"] == 1 and "smt_hashed" not in inner
    assert "other" not in fin and "smt_hashed" not in stage


def test_walk_makes_host_tensors_only_in_constant_caches():
    """The card's route copies nothing from the host but its constants (a
    copy inside a captured step breaks the capture)."""
    from zkfranchise_tpu_torch.tools import CONSTANT_CACHES, host_tensors

    args = smt_inputs(5, 2, [0, 5, 2, 4], 11)
    made: list = []
    with host_tensors(made):
        K.smt_walk(*args)
    assert {caller for _, caller in made} <= CONSTANT_CACHES, made

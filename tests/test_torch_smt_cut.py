"""The provers' cut MSM tables (groth16/device.py SmtCut) on the CPU: the
SMT levels below the cut depth, taken from the circuit's allocation; the
host's test of a slice's depths against lm_kernels.smt_depth; the premise
(one witness on every cut level of both trees, for every voter above the
cut) on the witness generator's own output at nlevels=16 with a cut depth
of 4, and its check raising on a doctored witness; the cut MSM plus the cut
rows' constant against the JAX package's msm on the whole table, as affine
points; and the guard of a step on the cut tables.

The whole proofs on the cut and the full tables are compared on the card
(tests/test_torch_cuda.py, nlevels=160) and, at nlevels=16, by the slow
test here: a CPU prove at nlevels=16 takes minutes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.ops import msm_lm as jmsm
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import qap
from zkfranchise_tpu_torch.models import census
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, ff, lm, msm_lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

# small tensors: one intra-op thread per test worker
torch.set_num_threads(1)

NL, DEPTH = 16, 4
LR = K.smt_level_rows()


def _depths(arrs) -> torch.Tensor:
    return K.smt_depth(torch.as_tensor(np.concatenate(
        [np.asarray(arrs["sikSiblings"]), np.asarray(arrs["censusSiblings"])],
        -1)))


def test_cut_vars_are_a_block_at_the_head_of_each_trees_levels():
    """nlevels=16, depth 4: the levels i = 16 .. 5 of each tree, 12 x 246
    wires right after the tree's head; none at depth >= 16; at nlevels=160
    and the cut depth 64 the levels 160 .. 65, 47,232 wires, of which
    46,656 have an A column and 31,680 a B column."""
    cs = CensusCircuit(NL).cs
    wires = census.smt_cut_vars(cs, NL, DEPTH)
    assert wires.shape == (2 * 12 * LR,)
    for tree, block in zip(("sik_tree", "census_tree"),
                           np.split(wires, 2)):
        start = cs.gadget_rows[tree]["vars"][0] + K.smt_head_rows(NL + 1)
        assert np.array_equal(block, np.arange(start, start + 12 * LR))
    assert not len(census.smt_cut_vars(cs, NL, NL))
    assert census.smt_cut_vars(cs, NL, NL - 1).shape == (2 * LR,)
    assert census.SMT_CUT_DEPTH == 64
    assert not len(census.smt_cut_vars(cs, NL, census.SMT_CUT_DEPTH))

    cs = CensusCircuit(160).cs
    wires = census.smt_cut_vars(cs, 160, census.SMT_CUT_DEPTH)
    assert wires.shape == (47232,)
    arrays = cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public))
    assert np.isin(wires, arrays["a"][1]).sum() == 46656
    assert np.isin(wires, arrays["b"][1]).sum() == 31680


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_host_depth_test_agrees_with_smt_depth(kind):
    """leaves_within(inputs, d) is (smt_depth <= d) over every lane of both
    trees, at every d, for lanes of depth 0 .. L with zero siblings under
    nonzero ones."""
    L, T = NL + 1, 6
    rng = np.random.default_rng(4)
    arrs = {}
    for key, depths in (("sikSiblings", [0, 3, 1, 9, 17, 2]),
                        ("censusSiblings", [5, 0, 4, 1, 2, 12])):
        sib = np.zeros((L, lm.N_LIMBS, T), np.int32)
        for lane, d in enumerate(depths):
            for i in range(d):
                if i == d - 1 or rng.random() < 0.5:
                    sib[i, rng.integers(lm.N_LIMBS), lane] = \
                        rng.integers(1, 1 << 13)
        arrs[key] = sib if kind == "numpy" else torch.as_tensor(sib)
    depth = _depths(arrs)
    assert depth.tolist() == [0, 3, 1, 9, 17, 2, 5, 0, 4, 1, 2, 12]
    for d in range(L + 1):
        assert census.leaves_within(arrs, d) == bool((depth <= d).all()), d
    one = {k: v[..., 2:3] for k, v in arrs.items()}     # depths 1 and 4
    assert [census.leaves_within(one, d) for d in (3, 4)] == [False, True]


@pytest.fixture(scope="module")
def witness():
    """(the cut wires at nlevels=16 and depth 4, the plain witness of
    census.shallow_voters' two lanes and two mock voters (leaves at depth
    <= 4) side by side, their depths)."""
    shallow = census.shallow_voters(NL, DEPTH)
    mock = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, 2, seed=3, device="cpu"), NL)
    arrs = {k: np.concatenate([shallow[k], mock[k]], -1) for k in shallow}
    circuit = CensusCircuit(NL)
    w = circuit.witness({k: torch.as_tensor(v) for k, v in arrs.items()})
    wires = census.smt_cut_vars(circuit.cs, NL, DEPTH)
    return wires, lm.from_mont(w, lm.FR), _depths(arrs)


def test_cut_levels_hold_one_witness_for_every_voter_above_the_cut(
        witness):
    """The witness generator's rows of the cut levels, for the synthetic
    voters (depths 0 and 4, key bits complementary) and two mock voters:
    m_sw 0, the trace of Poseidon(0, 0), m1 0, m2 0 on every cut level of
    both trees; cut_witness returns them."""
    wires, w, depth = witness
    assert depth.tolist()[:2] == [0, 4] and depth.tolist()[4:6] == [0, 4]
    assert int(depth.max()) <= DEPTH
    got = census.cut_witness(w[wires], NL - DEPTH)
    assert got.shape == (len(wires), lm.N_LIMBS, 1)
    _, trace = K.poseidon_trace(torch.zeros((2, lm.N_LIMBS, 1),
                                            dtype=lm.DTYPE))
    zero = torch.zeros((1, lm.N_LIMBS, 1), dtype=lm.DTYPE)
    level = torch.cat([zero, lm.from_mont(trace, lm.FR), zero, zero], 0)
    assert level.shape[0] == LR
    assert torch.equal(got, level.repeat(2 * (NL - DEPTH), 1, 1))
    assert torch.equal(w[wires], got.expand(-1, -1, 4))


@pytest.mark.parametrize("where", ["level", "tree", "lane"])
def test_cut_witness_raises_on_a_doctored_constant(witness, where):
    wires, w, _ = witness
    rows = w[wires].clone()
    row, lane = {"level": (5 * LR + 17, 0), "tree": (12 * LR + 3, 0),
                 "lane": (40, 3)}[where]
    rows[row, 0, lane] ^= 1
    with pytest.raises(RuntimeError, match="smt cut"):
        census.cut_witness(rows, NL - DEPTH)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_msm(sc, table, kind):
    return jmsm.msm(sc, table, kind)


def test_cut_msm_plus_its_constant_equals_jax_msm_on_the_full_table():
    """msm_lm.plan_cut: a G1 table of 300 points (one the identity) without
    a block of 120 rows (ten "levels" of 12) whose scalars are one pattern
    in every lane; the MSM over the 180 rows kept plus the cut rows' sum
    equals the JAX package's msm over the whole table for two lanes, as
    affine points."""
    rng = np.random.default_rng(22)

    def scalars(n):
        return [int.from_bytes(rng.bytes(32), "big") % ff.P_FR
                for _ in range(n)]

    n, cut = 300, np.arange(64, 184)
    pts = [ec.g1_mul(j + 3) for j in range(n)]
    pts[100] = None
    table = torch.as_tensor(ec_affine.affine_table(pts, "g1"))
    pattern = scalars(12)
    pattern[3] = 0
    lanes = [scalars(n) for _ in range(2)]
    for sc in lanes:
        sc[64:184] = pattern * 10
    sc = torch.as_tensor(np.stack([lm.ints_to_lm([lane[i] for lane in lanes])
                                   for i in range(n)]))
    keep, chunks, const = msm_lm.plan_cut(table, "g1", cut,
                                          sc[torch.as_tensor(cut), :, :1])
    assert np.array_equal(keep, np.r_[0:64, 184:300])
    assert [c[:3] for c in chunks] == [(0, 180, 256)]
    assert msm_lm.plan_leaves(chunks) == 256
    got = K.padd(msm_lm.msm_planned(sc[torch.as_tensor(keep)], chunks, "g1"),
                 const, "g1")
    want = torch.as_tensor(np.array(_jax_msm(jnp.asarray(sc.numpy()),
                                               jnp.asarray(table.numpy()),
                                               "g1")))

    def affine(x):
        return ec_lm.g1_plane_to_affine(x[..., 0].transpose(0, 1))
    assert affine(got) == affine(want)
    assert affine(got) == [ec.msm_host(lane, pts, ec.G1) for lane in lanes]


def test_the_cut_steps_guard():
    """finish's guard on a step on the cut tables: every lane's hashed
    levels (its depth, on the card) at most the cut depth."""
    tdevice.check_cut_depths([0, 3, 64, 12], 64)
    tdevice.check_cut_depths([], 64)
    with pytest.raises(RuntimeError, match="smt cut"):
        tdevice.check_cut_depths([0, 65, 3], 64)


@pytest.mark.slow
def test_cut_and_full_proofs_at_nl16():
    """nlevels=16 with the cut at depth 4, on the CPU (about 10 minutes):
    prove_arrays + finalize give the same proofs and signals on the cut and
    the full tables for a slice above the cut, and they verify; a slice
    with two leaves at depth 7 takes the full tables in prove_batch (its
    record's leaves are the full tables') and its proofs verify."""
    import io

    from zkfranchise_tpu_torch.groth16 import setup as tsetup
    from zkfranchise_tpu_torch.groth16 import verify as gverify
    from zkfranchise_tpu_torch.tools import deep_pair_batch
    from zkfranchise_tpu_torch.utils import metrics

    torch.set_num_threads(4)
    circuit = CensusCircuit(NL)
    pk, vk = tsetup.dev_setup(circuit.cs)
    prover = tdevice.DeviceProver(circuit, pk, device="cpu")
    prover.cut = prover._smt_cut(DEPTH)
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, 2, seed=3, device="cpu"), NL)
    assert prover.takes_cut(arrs)
    r, s = (torch.as_tensor(x) for x in tdevice.draw_rs(1, 2))
    cut = prover.finalize(*prover.prove_arrays(arrs, r, s, cut=True)[:4])
    full = prover.finalize(*prover.prove_arrays(arrs, r, s, cut=False)[:4])
    assert [p.to_dict() for p in cut[0]] == [p.to_dict() for p in full[0]]
    assert cut[1] == full[1]
    assert all(gverify.verify(vk, p, pub) for p, pub in zip(*cut))

    deep = tinputs.batch_to_arrays(deep_pair_batch(NL, 2, 6, 5, "cpu"), NL)
    assert _depths(deep).tolist() == [7, 7, 7, 7]
    assert not prover.takes_cut(deep)
    sink = io.StringIO()
    with metrics.recording(metrics.Metrics(sink)):
        proofs, pubs = prover.prove_batch(deep, seed=2)
    assert all(gverify.verify(vk, p, pub) for p, pub in zip(proofs, pubs))
    assert '"msm_leaves": 59392' in sink.getvalue()
    assert '"msm_leaves_full": 59392' in sink.getvalue()


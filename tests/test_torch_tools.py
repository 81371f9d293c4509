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
from zkfranchise_tpu_torch.tools import (ladder_teams, micro_montmul,
                                         tree_compare, verify_kernels,
                                         verify_lm)

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

P = ff.P_FQ
TOOLS = {"verify_kernels": verify_kernels, "verify_lm": verify_lm,
         "micro_montmul": micro_montmul, "ladder_teams": ladder_teams}


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


def _events(n, us, name="k"):
    return [(name, us)] * n, (64, 64)


@pytest.mark.parametrize("profiles,invalid,why,dev_ms", [
    ([_events(20, 2000.0)], False, [], 2.0),
    ([_events(20, 0.0)], True, ["zero", "below the bytes bound",
                                "below the integer ceiling"], 0.0),
    ([_events(20, 500.0)], True, ["below the bytes bound",
                                  "below the integer ceiling"], 0.5),
    ([_events(20, 1200.0)], True, ["below the integer ceiling"], 1.2),
    # events lost on every try: the port's kernels are scaled up to the
    # launches, a PyTorch kernel among them leaves the reading invalid
    ([_events(17, 1500.0)] * 3, False, [], 1.5),
    ([([("k", 1700.0)] * 16 + [("void at::native::copy", 10.0)],
       (64, 64))] * 3,
     True, ["events dropped"], (16 * 1700.0 + 10.0) / 20 / 1e3),
    ([_events(17, 1500.0), _events(20, 2000.0)], False, [], 2.0),
    # most leading spins lost: profiled again, invalid while it lasts
    ([([("k", 1000.0)] * 20, (4, 64)), _events(20, 2000.0)], False, [],
     2.0),
    ([([("k", 1500.0)] * 20, (4, 64))] * 3, True, ["window disturbed"],
     1.5),
    # windows the profiler traced nothing in, not even a spin: profiled
    # again; if every window stays empty, the event burst is the reading
    ([([], (0, 0))] * 4 + [_events(20, 2000.0)], False, [], 2.0),
    ([([], (0, 0))] * 8, False, [], 2.5),
])
def test_device_reading_marks_readings_no_card_can_give(
        monkeypatch, capsys, profiles, invalid, why, dev_ms):
    """A reading of one launch a call: 0, below the bytes bound (1 ms),
    below the integer ceiling (1.25 ms at 1,000 MHz), or with kernel
    events missing after every retry that cannot be scaled is invalid; a
    retry that records every event is kept, and a reading whose every
    window the profiler left empty comes from CUDA events."""
    import zkfranchise_tpu_torch.tools as tools

    seen = iter(profiles)
    monkeypatch.setattr(tools, "kernel_events", lambda fn, runs: next(seen))
    monkeypatch.setattr(tools, "burst_ms", lambda fn: 2.5)
    monkeypatch.setattr(tools, "max_sm_mhz", lambda: 1000.0)
    monkeypatch.setattr(tools, "EMPTY_PAUSE_S", 0.0)

    def one_launch():
        K.LAUNCHES["mont_mul"] += 1

    mads = 1.25 * tools.INT_MADS_PER_CLK_SM * tools.SMS * 1e6
    res = tools.device_reading("r", one_launch, tools.HBM_BYTES_PER_S * 1e-3,
                               mads)
    assert res["invalid"] is invalid and res.get("why", []) == why
    assert res["device_ms"] == pytest.approx(dev_ms)
    assert res["launches"] == 20 and res["burst_ms"] == 2.5
    assert res["attempts"] == len(profiles)
    assert res["source"] == ("cuda_events" if profiles[-1] == ([], (0, 0))
                             else "profiler")
    assert '"reading": "r"' in capsys.readouterr().out


@pytest.mark.parametrize("work,want_ms,by", [
    (("fold2d", "g1", 128, 8192), 0.1736, "operations"),
    (("fold2d", "g2", 128, 8192), 0.4970, "operations"),
    (("mont_chain", 1 << 20, 8), 0.2291, "operations"),
    (("mont_chain", 1 << 20, 1), 0.0789, "bytes")])
def test_layout_bounds_count_the_karatsuba_work(work, want_ms, by):
    """The bounds of fold2d and mm2d at the layout tool's full sizes, as
    chip_smoke.py computes them: the cooperative add's and the register
    product's Karatsuba multiply-adds (add_mads, MAD_MONT_KARATSUBA; mm2d
    runs mont_chain's function, so mont_chain_work counts it)."""
    from zkfranchise_tpu_torch import tools

    name, *args = work
    nbytes, mads = getattr(tools, f"{name}_work")(*args)
    if name == "fold2d":
        kind, B, m = args
        assert mads == tools.add_mads("padd", kind) * B * m // 2
    else:
        T, chain = args
        assert mads == tools.MAD_MONT_KARATSUBA * chain * T
    ms, got_by = tools.bound_ms(nbytes, mads)
    assert ms == pytest.approx(want_ms, abs=5e-5) and got_by == by


def test_tree_compare_sums_up_a_run():
    """The summary of a run's phase lines; without a card it raises."""
    lines = [
        {"scalar_mul": "g1", "bits": "per_lane", "equal": True, "ms": 4.0},
        {"phase": "timed_prove", "stage_seconds": {"witness": 0.05},
         "total_s": 2.0, "proofs_per_s": 64.0,
         "launches_per_prove_arrays": {"mont_mul": 236, "inv": 0}},
        {"phase": "verify", "accepted": {"voter_0": True},
         "cross_voter_accepted": False, "tampered_accepted": False},
        {"phase": "profile", "device_busy_s": 1.0,
         "device_idle_share": 0.5, "host_prove_arrays": {"ops": 9},
         "host_witness": {"ops": 3}},
        {"phase": "stream", "proofs_per_s": 50.0,
         "rates": [{"seconds": 2.0}, {"seconds": 0.4}]},
        {"reading": "fold2d/g1/63x1048576/m8192/tile512", "device_ms": 0.9,
         "invalid": False, "burst_ms": 0.95},
        {"reading": "mm2d/fq/21x1048576/chain8/tile512", "device_ms": 0.5,
         "invalid": False, "burst_ms": 0.52}]
    assert tree_compare.summary(lines) == {
        "scalar_mul": {"g1/per_lane": {"ms": 4.0, "equal": True}},
        "stage_seconds": {"witness": 0.05}, "step_s": 2.0,
        "proofs_per_s": 64.0, "launches_per_prove_arrays": {"mont_mul": 236},
        "verified": True, "device_busy_s": 1.0, "device_idle_share": 0.5,
        "host_prove_arrays": {"ops": 9}, "host_witness": {"ops": 3},
        "stream_proofs_per_s": 50.0, "stream_slices_s": [2.0, 0.4],
        "readings": {
            "fold2d/g1/63x1048576/m8192/tile512": {"device_ms": 0.9,
                                                   "invalid": False},
            "mm2d/fq/21x1048576/chain8/tile512": {"device_ms": 0.5,
                                                  "invalid": False}}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tree_compare.main("parent")


def test_tree_compare_keeps_what_a_tree_prints_beside_the_stages():
    """Peak memory and mont_mul's launches by shape where the run's
    timed_prove line has them, and the kernel readings."""
    line = {"phase": "timed_prove", "stage_seconds": {"quotient": 0.05},
            "total_s": 2.0, "proofs_per_s": 64.0,
            "launches_per_prove_arrays": {"ntt_level": 84},
            "peak_memory_bytes": 5, "mont_launches_by_shape":
            {"full*col/R16384/T128": 6}}
    reading = {"reading": "inv/fq/21x128", "device_ms": 0.13,
               "invalid": False, "burst_ms": 0.14}
    got = tree_compare.summary([line, reading])
    assert got["readings"] == {"inv/fq/21x128": {"device_ms": 0.13,
                                                 "invalid": False}}
    assert got["peak_memory_bytes"] == 5
    assert got["mont_launches_by_shape"] == {"full*col/R16384/T128": 6}
    assert got["launches_per_prove_arrays"] == {"ntt_level": 84}


def test_mont_chain_bound_counts_the_karatsuba_product():
    """mont_chain runs mm2d's Karatsuba register product: at the tool's
    (21, 131072) x 20, 915 multiply-adds a product, 0.0716 ms of
    operations and a 0.1434 ms integer ceiling at 1,980 MHz."""
    from zkfranchise_tpu_torch import tools

    nbytes, mads = tools.mont_chain_work(131072, 20)
    assert mads == 915 * 20 * 131072 == tools.MAD_MONT_KARATSUBA * 20 * 131072
    ms, by = tools.bound_ms(nbytes, mads)
    assert ms == pytest.approx(0.0716, abs=5e-5) and by == "operations"
    assert tools.int_ceiling_ms(mads, 1980) == pytest.approx(0.1434,
                                                             abs=5e-5)


def test_tree_compare_keeps_the_affine_trees_seconds():
    """Phase affine_tree's seconds per tree (affine and projective, G1
    and G2) and its peak memory; its failure line (no peak) is left out."""
    line = {"phase": "affine_tree", "nvidia_smi": "H100, 700.00 W",
            "g1": {"affine_tree_s": [0.2, 0.15],
                   "projective_tree_s": [0.01, 0.006]},
            "g2": {"affine_tree_s": [0.3, 0.11],
                   "projective_tree_s": [0.008, 0.004]},
            "peak_memory_bytes": 7, "launches": {"fold_mul": 56}}
    got = tree_compare.summary([line])
    assert got["affine_tree"] == {
        "g1": {"affine_s": [0.2, 0.15], "projective_s": [0.01, 0.006]},
        "g2": {"affine_s": [0.3, 0.11], "projective_s": [0.008, 0.004]},
        "peak_memory_bytes": 7}
    failed = {"phase": "affine_tree", "g1": line["g1"]}
    assert "affine_tree" not in tree_compare.summary([failed])

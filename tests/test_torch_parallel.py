"""The port's parallel layer against the JAX package's parallel/: the R1CS
row shards, each rank's proving-key table shards and NTT plan slices,
init_distributed without a world, and the two entry tools
(tools.dryrun_multichip on 4 gloo ranks, tools.scaling_sweep over (1,1)
and (1,2) at a tiny size, writing only into --out).  Exact equality."""
import json
import pathlib

import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu.parallel import mesh as jmesh
from zkfranchise_tpu.parallel import prove as jprove
from zkfranchise_tpu_torch.groth16 import qap
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.parallel import prove as tprove
from zkfranchise_tpu_torch.parallel import runtime
from zkfranchise_tpu_torch.parallel import mesh as pmesh
from zkfranchise_tpu_torch.parallel.mesh import Axis, CollectiveStats, Mesh
from zkfranchise_tpu_torch.tools import dryrun_multichip, scaling_sweep

torch.set_num_threads(1)

NL = 4
ROOT = pathlib.Path(__file__).resolve().parent.parent
ART = ROOT / "artifacts" / "zkCensus" / "dev" / str(NL)


@pytest.fixture(scope="module")
def circuit():
    return CensusCircuit(NL)


@pytest.fixture(scope="module")
def jax_circuit():
    return JaxCircuit(NL)


def _cpu_mesh(n_data, n_model, d, m) -> Mesh:
    """A rank's mesh without a process group: enough to build a prover
    (its constructor runs no collective)."""
    dev = torch.device("cpu")
    st = CollectiveStats()
    return Mesh(Axis("data", n_data, d, None, dev, st),
                Axis("model", n_model, m, None, dev, st), dev, st)


@pytest.mark.parametrize("nm", [2, 4])
def test_shard_rows_matches_jax(circuit, jax_circuit, nm):
    cs = circuit.cs
    n = qap.domain_size(cs.num_constraints, cs.num_public)
    got_arrays = cs.export_arrays(extra_rows=qap.binding_rows(cs.num_public))
    jcs = jax_circuit.cs
    from zkfranchise_tpu.groth16 import qap as jqap
    want_arrays = jcs.export_arrays(
        extra_rows=jqap.binding_rows(jcs.num_public))
    for k in ("a", "b", "c"):
        got = tprove._shard_rows(got_arrays[k], n, nm)
        want = jprove._shard_rows(want_arrays[k], n, nm)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (1, 4)])
def test_rank_shards_match_jax_sharded_prover(circuit, jax_circuit, n_data,
                                              n_model):
    """Each rank keeps exactly the JAX ShardedProver's slice for its model
    index: the four point tables, the A/B/C row shards and the plan."""
    jmesh_ = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    jp = jprove.ShardedProver(jax_circuit,
                              jsetup.ProvingKey.load(ART / "proving_key.pkl"),
                              jmesh_)
    pk = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    jtabs = {"a": jp.a_tab, "b1": jp.b1_tab, "b2": jp.b2_tab, "c": jp.c_tab}
    for m in range(n_model):
        tp = tprove.ShardedProver(circuit, pk, _cpu_mesh(n_data, n_model,
                                                         0, m))
        assert tp._dist_ntt == jp._dist_ntt
        assert np.array_equal(tp.b_nz, jp.b_nz)
        for key, jt in jtabs.items():
            jt = np.asarray(jt)
            s = jt.shape[0] // n_model
            assert tp.padded[key] == jt.shape[0], key
            assert np.array_equal(tp.tabs[key].numpy(),
                                  jt[m * s:(m + 1) * s]), key
        for j, k in enumerate(("a", "b", "c")):
            want = jp._row_shards[3 * j:3 * j + 3]
            for t, w in zip(tp._row_shards[k], want):
                assert np.array_equal(t.numpy(), np.asarray(w)[m]), k
        on = tp._ntt_plan.on("cpu", m)
        assert np.array_equal(on["tw_inv"].numpy(), jp._ntt_plan.tw_inv[m])
        assert np.array_equal(on["tw_fwd"].numpy(), jp._ntt_plan.tw_fwd[m])
        assert np.array_equal(on["shift"].numpy(),
                              jp._ntt_plan.shift_strided[m])
        for name in ("alpha", "beta1", "beta2"):
            assert np.array_equal(getattr(tp, name).numpy(),
                                  np.asarray(getattr(jp, name))), name


def test_local_shard_splits_lanes():
    x = np.arange(2 * 3 * 8).reshape(2, 3, 8).astype(np.int32)
    for d in range(2):
        mesh = _cpu_mesh(2, 2, d, 1)
        got = runtime.local_shard(x, mesh, (None, None, "data"))
        assert np.array_equal(got.numpy(), x[..., 4 * d:4 * d + 4])
    assert np.array_equal(
        runtime.local_shard(x, mesh, pmesh.replicated(mesh)).numpy(), x)
    assert np.array_equal(
        runtime.local_shard(x, mesh, pmesh.data_sharding(mesh)).numpy(),
        x[1:])
    with pytest.raises(ValueError):
        runtime.local_shard(x, _cpu_mesh(3, 1, 0, 0), (None, None, "data"))


def test_init_distributed_without_environment(monkeypatch):
    for name in ("ZKF_COORDINATOR", "ZKF_NUM_PROCESSES", "ZKF_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert runtime.init_distributed() is False
    assert not torch.distributed.is_initialized()
    # a world must name its backend
    with pytest.raises(ValueError):
        runtime.init_distributed("localhost:1", 2, 0)


def test_dryrun_multichip_cpu_four_ranks(capsys):
    assert dryrun_multichip.main(["--device", "cpu", "--ranks", "4",
                                  "--batch", "1", "--timeout", "400"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mesh"] == [1, 4]
    assert all(line["equal_to_single_device"].values())
    assert line["stretches"] == [None] * 4          # eager: no graphs


def tree_state(root: pathlib.Path) -> dict:
    """path -> (size, mtime) of every file under root."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_scaling_sweep_cpu_writes_only_out(tmp_path):
    out = tmp_path / "sweep"
    before = tree_state(ROOT / "artifacts")
    # the JAX script writes scaling.json at the repo root; the tool must not
    root_json = (ROOT / "scaling.json").stat().st_mtime_ns
    assert scaling_sweep.main([
        "--out", str(out), "--device", "cpu", "--meshes", "1x1,1x2",
        "--stage", "quotient", "--nlevels", "1", "--batch", "1",
        "--iters", "1", "--timeout", "300"]) == 0
    assert tree_state(ROOT / "artifacts") == before
    assert (ROOT / "scaling.json").stat().st_mtime_ns == root_json
    assert [p.name for p in out.iterdir()] == ["scaling.json"]
    res = json.loads((out / "scaling.json").read_text())
    rows = res["sweeps"]["quotient"]
    assert [r["mesh"] for r in rows] == ["1x1", "1x2"]
    assert all(r["equal_to_single_device"] for r in rows)
    assert [r["dist_ntt"] for r in rows] == [False, True]
    assert all(r["ranks_per_card"] is None for r in rows)
    # the distributed NTT's 12 exchanges and the quotient's gather
    assert rows[1]["collective_calls"] == 13

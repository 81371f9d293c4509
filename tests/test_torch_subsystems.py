"""The port's small host modules (config, utils/artifacts, utils/metrics,
groth16/prove) on the CPU, mirroring the JAX package's subsystem tests and
holding each against the JAX package's module on the same inputs."""
import copy
import io
import json
import random

import pytest
import torch

from zkfranchise_tpu import config as jconfig
from zkfranchise_tpu.groth16 import prove as jprove
from zkfranchise_tpu.ops import ec as jec
from zkfranchise_tpu.utils import artifacts as jartifacts
from zkfranchise_tpu_torch.config import Config
from zkfranchise_tpu_torch.groth16 import prove
from zkfranchise_tpu_torch.ops import ec
from zkfranchise_tpu_torch.utils import artifacts, metrics
from zkfranchise_tpu_torch.utils.metrics import Metrics


def test_config_defaults_match_reference():
    cfg = Config()
    assert cfg.circuit_name == "zkCensus"
    assert cfg.environment == "dev"
    assert cfg.n_levels == 160
    assert str(cfg.artifact_dir).endswith("artifacts/zkCensus/dev/160")
    want = jconfig.Config()
    for name in ("circuit_name", "environment", "n_levels", "key_size",
                 "batch_size", "mesh_data", "mesh_model"):
        assert getattr(cfg, name) == getattr(want, name), name
    assert cfg.artifact_dir == want.artifact_dir     # the same artifacts/


def test_config_validation():
    with pytest.raises(ValueError):
        Config(n_levels=8).validate()          # upstream bound NLEVELS>=10
    with pytest.raises(ValueError):
        Config(n_levels=32, key_size=20).validate()  # key too large
    Config(n_levels=160).validate()


def test_config_from_env(monkeypatch, tmp_path):
    for k, v in {"CIRCUIT_NAME": "c", "ENVIRONMENT": "prod", "NLEVELS": "16",
                 "KEYSIZE": "2", "BATCH_SIZE": "128",
                 "ZKF_ARTIFACTS": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    cfg, want = Config.from_env(), jconfig.Config.from_env()
    assert (cfg.n_levels, cfg.key_size, cfg.batch_size) == (16, 2, 128)
    assert cfg.artifact_dir == tmp_path / "c" / "prod" / "16"
    assert cfg == Config(**{k: getattr(want, k) for k in (
        "circuit_name", "environment", "n_levels", "key_size", "batch_size",
        "mesh_data", "mesh_model", "artifacts_root")})
    monkeypatch.setenv("NLEVELS", "8")
    with pytest.raises(ValueError):
        Config.from_env()


def test_manifest(tmp_path):
    d = tmp_path / "zkCensus" / "dev" / "4"
    d.mkdir(parents=True)
    (d / "verification_key.json").write_text("{}")
    (d / "signals.json").write_text("[]")
    (d / "unlisted.bin").write_text("x")
    text = artifacts.write_manifest(d.parent).read_text()
    assert "### dev 4" in text
    assert "verification_key.json" in text and "`" in text
    assert "unlisted" not in text
    assert text == jartifacts.write_manifest(d.parent).read_text()
    assert artifacts.sha256_file(d / "signals.json") == \
        jartifacts.sha256_file(d / "signals.json")


def test_proof_artifacts(tmp_path):
    artifacts.save_proof_artifacts(tmp_path / "t", {"pi_a": ["1", "2", "1"]},
                                   [1, 2, 3])
    jartifacts.save_proof_artifacts(tmp_path / "j", {"pi_a": ["1", "2", "1"]},
                                    [1, 2, 3])
    assert json.load(open(tmp_path / "t" / "proof.json"))["pi_a"][0] == "1"
    assert json.load(open(tmp_path / "t" / "signals.json")) == ["1", "2", "3"]
    for name in ("proof.json", "signals.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_metrics_jsonl():
    buf = io.StringIO()
    m = Metrics(sink=buf)
    with m.stage("witness", batch=4):
        pass
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(lines) == 1
    assert lines[0]["kind"] == "stage" and lines[0]["stage"] == "witness"
    assert lines[0]["batch"] == 4
    assert set(lines[0]) == {"kind", "stage", "seconds", "batch", "id", "t0",
                             "t1", "ts"}
    assert lines[0]["t0"] <= lines[0]["t1"]
    assert m.timers["witness"] >= 0
    # the tracing nobody read is gone
    for name in ("count", "counters", "throughput"):
        assert not hasattr(m, name)
    assert not hasattr(metrics, "device_timer")


def test_metrics_stage_is_recorded_when_the_block_raises():
    buf = io.StringIO()
    m = Metrics(sink=buf)
    with pytest.raises(RuntimeError):
        with m.stage("prove_batch", base=0):
            raise RuntimeError("boom")
    assert json.loads(buf.getvalue())["stage"] == "prove_batch"


def _records(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_span_records_nest_and_carry_their_parents_labels():
    buf = io.StringIO()
    m = Metrics(sink=buf)
    with metrics.recording(m):
        with m.stage("prove_batch", base=32, batch=16):
            with metrics.span("step.enqueue", part=1):
                with metrics.span("inner"):
                    pass
            with metrics.span("step.wait"):
                pass
        with metrics.span("stream.files", base=32, batch=16):
            pass
    inner, enqueue, wait, stage, files = _records(buf)
    assert [r["kind"] for r in (inner, enqueue, wait, files)] == ["span"] * 4
    assert [r["name"] for r in (inner, enqueue, wait, files)] == \
        ["inner", "step.enqueue", "step.wait", "stream.files"]
    assert stage["kind"] == "stage" and stage["stage"] == "prove_batch"
    assert enqueue["parent"] == wait["parent"] == stage["id"]
    assert inner["parent"] == enqueue["id"] and files["parent"] is None
    assert len({r["id"] for r in (inner, enqueue, wait, stage, files)}) == 5
    for r in (inner, enqueue, wait, files):
        assert (r["base"], r["batch"]) == (32, 16)
        assert r["t0"] <= r["t1"]
        assert set(r) >= {"kind", "name", "id", "parent", "t0", "t1"}
    assert inner["part"] == 1 and "part" not in wait
    assert stage["t0"] <= enqueue["t0"] <= enqueue["t1"] <= wait["t0"] <= \
        wait["t1"] <= stage["t1"] <= files["t0"]
    assert m.timers["step.enqueue"] == pytest.approx(
        enqueue["t1"] - enqueue["t0"])
    assert set(m.timers) == {"prove_batch", "step.enqueue", "inner",
                             "step.wait", "stream.files"}


def test_span_is_recorded_when_the_block_raises():
    buf = io.StringIO()
    m = Metrics(sink=buf)
    with metrics.recording(m):
        with pytest.raises(RuntimeError):
            with metrics.span("stream.arrays", base=0, batch=2):
                raise RuntimeError("boom")
        with metrics.span("after"):          # the failed span is closed
            pass
    failed, after = _records(buf)
    assert failed["name"] == "stream.arrays" and failed["base"] == 0
    assert after["parent"] is None
    assert m.timers["stream.arrays"] >= 0


def test_spans_outside_a_recording_keep_only_process_totals(monkeypatch):
    def no_record(self, record):
        raise AssertionError(f"a record was written: {record}")

    monkeypatch.setattr(Metrics, "_emit", no_record)
    monkeypatch.setattr(metrics.PROCESS, "timers", {})
    with metrics.span("ingest.read_zkey"):
        pass
    with metrics.span("ingest.read_zkey"):
        pass
    assert list(metrics.PROCESS.timers) == ["ingest.read_zkey"]
    # a recording block's Metrics is active only inside it
    m = Metrics(sink=io.StringIO(), writes=False)
    with metrics.recording(m):
        with metrics.span("stream.files"):
            pass
    assert list(m.timers) == ["stream.files"]
    assert "stream.files" not in metrics.PROCESS.timers


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    m = Metrics(sink=io.StringIO())
    with metrics.recording(m):
        for name in sorted(metrics.PROFILED):
            with metrics.span(name):
                pass
    assert set(m.timers) == metrics.PROFILED


def test_force_and_device_timer_on_the_cpu():
    """force on the CPU returns at once: nothing to wait for."""
    metrics.force("cpu")
    metrics.force(torch.device("cpu"))
    x = torch.ones(4)
    metrics.force(x.device)
    assert x.sum().item() == 4


def test_force_and_device_timer_default_to_the_card():
    """force with no device means the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        metrics.force()
    with pytest.raises(RuntimeError):
        metrics.force("cuda")


def test_trace_writes_a_chrome_trace(tmp_path):
    with metrics.trace(None):                        # off: a plain block
        pass
    with metrics.trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_pippenger_host_picks_the_curve_by_kind(kind):
    """Any G1 group object takes the G1 path: a second instance, a copy,
    and the JAX package's own G1 (which the JAX pippenger_host would send
    down the G2 path unless it is THE ec.G1)."""
    rng = random.Random(7)
    scalars = [rng.randrange(ec.R_ORDER) for _ in range(5)] + [0]
    if kind == "g1":
        groups = [ec.G1, ec._fq_ops(), copy.copy(ec.G1), jec.G1]
        pts = [ec.g1_mul(rng.randrange(1, 1 << 64)) for _ in scalars]
    else:
        groups = [ec.G2, copy.copy(ec.G2), jec.G2]
        pts = [ec.g2_mul(rng.randrange(1, 1 << 64)) for _ in scalars]
    pts[2] = None
    want = ec.msm_host(scalars, pts, groups[0])
    assert want == jprove.pippenger_host(
        scalars, pts, jec.G1 if kind == "g1" else jec.G2)
    for group in groups:
        assert prove.pippenger_host(scalars, pts, group) == want
    if kind == "g1":
        assert prove.pippenger_host(scalars, pts) == want   # the default

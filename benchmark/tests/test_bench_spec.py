"""BENCHMARK.json keeps to its format's rules, and everything it names is a file
of its own that the harness finds by name: a new entry needs no edit."""
import json
import re
import shutil
from pathlib import Path

from benchmark.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = {w["name"] for w in BENCH["workloads"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p.split("/") and not p.startswith("/")
    named = [w for w in BENCH["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"])
               for w in named)


def test_names_units_and_text():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + \
        BENCH["per_layer"]
    for e in entries:
        assert spec.NAME.fullmatch(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(spec.NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics_keep_to_their_rules():
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= CELLS
    for w in CELLS:
        c = spec.cell(BENCH, w, ROOT)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e, (w, m["name"])


def test_every_name_is_a_file_the_harness_finds():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = spec.config(BENCH, c["name"], ROOT)
        assert (ROOT / cfg["key"]["vk"]).exists()
        assert {"nlevels", "batch_size", "pool_voters"} <= set(cfg)
    for w in CELLS:
        spec.cell(BENCH, w, ROOT)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(BENCH, m["name"], ROOT).read)


def test_the_harness_names_no_cell_config_traffic_or_metric():
    names = CELLS | E2E | {m["name"] for m in BENCH["per_layer"]} | \
        {c["name"] for c in BENCH["configs"]} | \
        {w["traffic"] for w in BENCH["workloads"]}
    for path in (ROOT / "benchmark" / "harness").glob("*.py"):
        text = path.read_text()
        for name in names:
            assert not re.search(rf"[\"']{re.escape(name)}[\"']", text), \
                (path.name, name)


def test_a_new_entry_needs_no_edit(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".out",
                                                  "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "benchmark"
    cfg = json.loads((new / "configs" / "census-nl16-b128.json").read_text())
    cfg.update(nlevels=10, batch_size=32)
    (new / "configs" / "census-nl10-b32.json").write_text(json.dumps(cfg))
    (new / "traffic" / "bursts.json").write_text(json.dumps(
        {"loop": "open", "why": "on/off bursts"}))
    (new / "traffic" / "bursts").mkdir()
    (new / "traffic" / "bursts" / "census-nl10-b32.json").write_text(
        json.dumps({"rate_per_s": 40.0}))
    (new / "metrics" / "stream.slices.bursts.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench["configs"].append({"name": "census-nl10-b32", "source": "x",
                             "file": "benchmark/configs/census-nl10-b32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "nl10-bursts",
                               "config": "census-nl10-b32",
                               "traffic": "bursts", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "stream.slices.bursts", "unit": "1",
                               "better": "lower", "source": "program_span",
                               "layer": "stream", "moves": "latency_p95_ms",
                               "workloads": ["nl10-bursts"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append("nl10-bursts")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    got = spec.cell(bench, "nl10-bursts", tmp_path)
    assert got.config["nlevels"] == 10
    assert got.traffic["rate_per_s"] == 40.0 and got.traffic["loop"] == "open"
    assert "stream.slices.bursts" in [m["name"] for m in got.per_layer]
    reader = spec.reader(bench, "stream.slices.bursts", tmp_path)
    assert reader.read(type("R", (), {"records": [1, 2]})) == 2
    for p, data in before.items():
        new_file = tmp_path / p.relative_to(ROOT)
        assert new_file.read_bytes() == data, p

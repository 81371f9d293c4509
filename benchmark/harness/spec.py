"""BENCHMARK.json and the files it names.

Nothing here knows a cell, a configuration, a traffic mix or a metric by
name: each is found by the name BENCHMARK.json gives it, so a new one is a
new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names, loaded."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench_dir(bench: dict, root: Path = ROOT) -> Path:
    """The benchmark's own directory: the first of `paths`."""
    return root / bench["paths"][0]


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of `name`, with its name added."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return {**json.loads((root / entry["file"]).read_text()), "name": name}


def traffic(bench: dict, name: str, config_name: str,
            root: Path = ROOT) -> dict:
    """traffic/<name>.json, updated by traffic/<name>/<config>.json where a
    mix takes a number per configuration (an arrival rate)."""
    base = bench_dir(bench, root) / "traffic"
    params = json.loads((base / f"{name}.json").read_text())
    per_config = base / name / f"{config_name}.json"
    if per_config.exists():
        params.update(json.loads(per_config.read_text()))
    return {**params, "name": name}


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config_name=entry["config"],
        config=config(bench, entry["config"], root),
        traffic_name=entry["traffic"],
        traffic=traffic(bench, entry["traffic"], entry["config"], root),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def reader(bench: dict, name: str, root: Path = ROOT):
    """metrics/<name>.py as a module; its read(run) gives the metric's
    value, or None where the run holds nothing to read."""
    path = bench_dir(bench, root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

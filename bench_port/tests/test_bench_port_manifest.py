"""BENCHMARK.json against the benchmark's contract: names, units, files
found by name, and which metrics each cell reports."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert MANIFEST["paths"] == ["bench_port"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in MANIFEST["configs"]])
def test_names_are_allowed(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "bench_port" / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_of_each_of_its_cells(metric):
    moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", list(CELLS)):
        assert cell in moved.get("workloads", list(CELLS))


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_files_and_metrics(cell):
    entry = CELLS[cell]
    config = next(c for c in MANIFEST["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    assert config["file"].startswith("bench_port/")
    traffic = json.loads((ROOT / "bench_port" / "traffic" / f"{entry['traffic']}.json").read_text())
    assert (ROOT / "bench_port" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert entry["chips"] == 1
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in MANIFEST["per_layer"])


def test_layers_and_configs():
    names = [c["name"] for c in MANIFEST["configs"]]
    assert len(set(names)) == len(names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]

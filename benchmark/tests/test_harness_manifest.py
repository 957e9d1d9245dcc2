"""BENCHMARK.json against the contract's rules that need no run."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51
    assert 2 + 14 * 24 * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", [x["name"] for x in
                                  M["configs"] + M["workloads"] + METRICS])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert "\t" not in metric["layer"] and "\n" not in metric["layer"]


def test_unique_names_and_setup():
    names = [x["name"] for x in M["configs"] + M["workloads"] + METRICS]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    """Every cell of a per-layer metric reports the end-to-end metric it
    moves, and the metric has a reader."""
    moved = next(m for m in M["end_to_end"] if m["name"] == metric["moves"])
    for w in M["workloads"]:
        if reports(metric, w["name"]):
            assert reports(moved, w["name"]), (metric["name"], w["name"])
    assert callable(harness.reader(metric["name"]))


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(w):
    _, wl, config, mix = harness.cell(w["name"], M)
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert (ROOT / "benchmark" / "data" / f"{config['data']}.py").exists()
    assert mix["loop"] in ("open", "closed")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"]
               if reports(m, w["name"]))
    assert sum(reports(m, w["name"]) for m in M["end_to_end"]) >= 2
    assert any(reports(m, w["name"]) for m in M["per_layer"])


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_configs(c):
    path = ROOT / c["file"]
    assert path.exists() and c["file"].startswith("benchmark/")
    config = json.loads(path.read_text())
    assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
    assert "assumed" in config and len(c["source"]) <= 200

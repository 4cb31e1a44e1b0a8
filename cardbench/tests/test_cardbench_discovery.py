"""BENCHMARK.json against the contract's shape, and every cell, configuration
and metric found as a file by its name."""

import json
import re

import pytest

from cardbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["cardbench"]
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_in_its_day_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = (CELLS + [c["name"] for c in BENCH["configs"]]
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = next(w for w in BENCH["workloads"] if w["name"] == cell)
    workload = harness.load_json(harness.BENCH_DIR / "workloads"
                                 / f"{cell}.json")
    assert (workload["config"], workload["traffic"]) == (spec["config"],
                                                         spec["traffic"])
    assert workload["why"] == spec["why"] and len(spec["why"]) <= 200
    entry = harness.BENCH_DIR / "entries" / f"{workload['entry']}.py"
    assert entry.is_file()
    assert spec["chips"] == 1
    assert workload["limits"]
    config = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    data = harness.load_json(harness.ROOT / config["file"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    module = harness.load_module(harness.BENCH_DIR / "metrics"
                                 / f"{metric}.py")
    assert callable(module.read)
    m = next(x for x in METRICS if x["name"] == metric)
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_metrics_for_follows_workloads_lists():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                            {"name": "b"}],
             "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.metrics_for(bench, "x", False)] == [
        "a", "b"]
    assert [m["name"] for m in harness.metrics_for(bench, "y", False)] == ["b"]
    assert harness.metrics_for(bench, "x", True) == []


def test_files_under_paths_are_named_from_name_characters():
    for path in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

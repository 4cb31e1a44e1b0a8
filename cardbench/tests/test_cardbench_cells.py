"""Each cell's code path at a tiny size on the CPU, against the reference:
the whole run but the look for a card, and the result line it prints."""

import json
import math
import subprocess
import sys

import pytest

from cardbench import harness
from cardbench.tests.tiny import SEED, TINY


@pytest.fixture(scope="module")
def results():
    return {}


def run(cell, trace=False, results=None):
    key = (cell, trace)
    if results is not None and key in results:
        return results[key]
    out = harness.run_cell(cell, SEED, 0.2, trace, device="cpu",
                           overrides=TINY[cell], log=lambda msg: None)
    if results is not None:
        results[key] = out
    return out


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cell_is_correct(cell, results):
    out = run(cell, results=results)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(
        harness.load_json(harness.ROOT / "BENCHMARK.json"), cell, False)}
    assert set(out["metrics"]) == e2e - {"peak_device_gib"}   # no card
    assert out["metrics"]["setup_s"]["value"] > 0


def test_result_line_keys_and_order(results):
    out = run("lebel.fit", results=results)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for row in out["checks"].values():
        assert set(row) == {"value", "limit"}
    lines = harness.check_lines(out)
    assert len(lines) == len(out["checks"])
    json.dumps(harness.jsonable(out), allow_nan=False)


def test_traced_run_reads_the_per_layer_metrics(results):
    out = run("lebel.train_lm", trace=True, results=results)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    m = out["metrics"]
    # No device on the CPU: the trace-read metrics stay silent.
    assert "lanczos_fir.roofline.train" not in m
    assert "idle_share.train" not in m
    assert m["lm_real_token_share.train"]["value"] <= 100.0
    assert m["lm_windows_per_s.train"]["value"] > 0


def test_jsonable_turns_non_finite_numbers_into_strings():
    assert harness.jsonable({"a": [math.inf, 1.0]}) == {"a": ["inf", 1.0]}


def test_no_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "lebel.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from cardbench import harness;"
            "from cardbench.tests.tiny import TINY;"
            "harness.run_cell('lebel.fit', 1, 0.1, False, device='cpu',"
            " overrides=TINY['lebel.fit'])")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert "litcoder_core_torch" in proc.stderr

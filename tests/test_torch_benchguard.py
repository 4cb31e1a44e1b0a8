"""The port's benchmark guard (litcoder_core_torch/utils/benchguard.py) held
to the contracts of tests/test_bench_guard.py: a device that cannot be
reached at capture time yields rc 0 and the saved snapshot with explicit
staleness markers; a reachable one yields the live measurement and
refreshes the snapshot. The port commits no snapshot, so every snapshot
here is written to tmp_path.

The outage is LITCODER_BENCH_DEVICE=cuda:63, an ordinal no machine has;
the healthy device is the CPU. Every probe is a fresh subprocess that
imports torch (about 2 s each)."""

import datetime
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from litcoder_core_torch.utils.benchguard import (
    load_snapshot,
    probe_backend,
    run_guarded,
    save_snapshot,
    snapshot_age_hours,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT = {"metric": "m", "value": 3.0, "unit": "u", "vs_baseline": 1.0}
LIVE = [sys.executable, "-c",
        "import json; print('noise line');"
        "print(json.dumps({'metric': 'm', 'value': 1.5, 'unit': 'u',"
        " 'vs_baseline': 2.0}))"]


def _outage_env(monkeypatch):
    monkeypatch.setenv("LITCODER_BENCH_DEVICE", "cuda:63")
    monkeypatch.setenv("LITCODER_BENCH_PROBE_TIMEOUT_S", "60")
    monkeypatch.setenv("LITCODER_BENCH_PROBE_DEADLINE_S", "1")


def _guarded(live_argv, snap_path, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run_guarded(live_argv, str(snap_path), **kw)
    return json.loads(buf.getvalue().strip().splitlines()[-1]), rc


def test_probe_needs_the_named_device(monkeypatch):
    """CPU probes healthy; a CUDA ordinal that is not there fails inside the
    subprocess (no CPU fallback)."""
    monkeypatch.setenv("LITCODER_BENCH_DEVICE", "cpu")
    assert probe_backend(timeout_s=120) == (True, 0)
    monkeypatch.setenv("LITCODER_BENCH_DEVICE", "cuda:63")
    ok, rc = probe_backend(timeout_s=120)
    assert not ok and rc not in (0, None, "timeout")


def test_outage_falls_back_to_stale_snapshot(tmp_path, monkeypatch):
    """In a fresh process, as a benchmark script would call it: rc 0 and the
    snapshot's line with the staleness fields and the schema intact."""
    snap_path = tmp_path / "snap.json"
    save_snapshot(str(snap_path), RESULT)
    _outage_env(monkeypatch)
    code = ("import sys; sys.path.insert(0, %r);"
            "from litcoder_core_torch.utils.benchguard import run_guarded;"
            "sys.exit(run_guarded([sys.executable, '-c', 'pass'], %r))"
            % (REPO, str(snap_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["stale"] is True
    assert result["probe_rc"] not in (0, None)
    assert "snapshot_captured_utc" in result and "stale_reason" in result
    assert "device unavailable" in result["stale_reason"]
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert result[key] == RESULT[key]


def test_outage_without_snapshot_fails_loudly(tmp_path, monkeypatch):
    """No snapshot to fall back on -> rc 1 and an explanatory JSON line."""
    _outage_env(monkeypatch)
    result, rc = _guarded([sys.executable, "-c", "pass"],
                          tmp_path / "missing_snapshot.json")
    assert rc == 1
    assert result["value"] is None and result["metric"] == "bench_failed"
    assert result["probe_rc"] not in (0, None)


def test_healthy_device_runs_live_and_refreshes_snapshot(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("LITCODER_BENCH_DEVICE", "cpu")
    snap_path = tmp_path / "snap.json"
    result, rc = _guarded(LIVE, snap_path, live_timeout_s=120)
    assert rc == 0 and result["value"] == 1.5 and "stale" not in result
    snap = load_snapshot(str(snap_path))
    assert snap["result"]["value"] == 1.5
    assert 0.0 <= snapshot_age_hours(snap) < 1.0


def test_live_failure_falls_back_to_stale(tmp_path, monkeypatch):
    """Probe OK but the live run crashes -> stale fallback, rc 0, and the
    snapshot is left as it was."""
    monkeypatch.setenv("LITCODER_BENCH_DEVICE", "cpu")
    snap_path = tmp_path / "snap.json"
    save_snapshot(str(snap_path), RESULT)
    before = snap_path.read_text()
    result, rc = _guarded([sys.executable, "-c", "raise SystemExit(3)"],
                          snap_path, live_timeout_s=120)
    assert rc == 0
    assert result["stale"] is True and result["value"] == 3.0
    assert "rc=3" in result["stale_reason"] and result["probe_rc"] == 0
    assert snap_path.read_text() == before


def test_stale_line_reports_snapshot_age(tmp_path, monkeypatch):
    snap_path = tmp_path / "snap.json"
    save_snapshot(str(snap_path), RESULT)
    _outage_env(monkeypatch)
    result, rc = _guarded([sys.executable, "-c", "pass"], snap_path)
    assert rc == 0 and result["stale"] is True
    assert 0.0 <= result["snapshot_age_h"] < 1.0
    assert "stale_expired" not in result


def test_stale_snapshot_past_max_age_is_expired(tmp_path, monkeypatch):
    snap_path = tmp_path / "snap.json"
    old = (datetime.datetime.now(datetime.timezone.utc)
           - datetime.timedelta(hours=100)).isoformat(timespec="seconds")
    snap_path.write_text(json.dumps({"captured_utc": old,
                                     "result": RESULT}))
    _outage_env(monkeypatch)
    result, rc = _guarded([sys.executable, "-c", "pass"], snap_path)
    assert rc == 0 and result["stale"] is True
    assert result["stale_expired"] is True
    assert 99.0 < result["snapshot_age_h"] < 101.0
    assert "EXPIRED" in result["stale_reason"]
    # A looser policy accepts the same snapshot.
    monkeypatch.setenv("LITCODER_BENCH_SNAPSHOT_MAX_AGE_H", "200")
    result, _ = _guarded([sys.executable, "-c", "pass"], snap_path)
    assert "stale_expired" not in result


def test_stale_snapshot_with_unparseable_capture_time_is_expired(
        tmp_path, monkeypatch):
    snap_path = tmp_path / "snap.json"
    snap_path.write_text(json.dumps({"captured_utc": "who knows",
                                     "result": RESULT}))
    _outage_env(monkeypatch)
    result, rc = _guarded([sys.executable, "-c", "pass"], snap_path)
    assert rc == 0
    assert result["stale_expired"] is True
    assert result["snapshot_age_h"] is None


@pytest.mark.parametrize("text, metric", [
    (json.dumps({"metric": "m", "value": 1}), "m"),
    ("{not json", None),
    ("[1, 2]", None),
    (json.dumps({"captured_utc": "x", "result": 5}), None),
])
def test_snapshot_loader_tolerates_bare_and_broken_files(tmp_path, text,
                                                         metric):
    path = tmp_path / "snap.json"
    path.write_text(text)
    snap = load_snapshot(str(path))
    assert (snap is None) if metric is None else (
        snap["result"]["metric"] == metric)
    assert load_snapshot(str(tmp_path / "absent.json")) is None

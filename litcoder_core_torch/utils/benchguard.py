"""Outage-proof benchmark capture (twin of litcoder_core_tpu's benchguard).

A device that cannot be reached at capture time must not turn a benchmark
run into a traceback: the run degrades to the last saved measurement with
explicit staleness markers. A failed CUDA initialisation can stick inside
one process, so only FRESH subprocesses probe the device.

Flow (`run_guarded`):
  1. probe the device in a fresh subprocess (a 256 x 256 matmul whose sum
     is fetched to the host), with a bounded per-probe timeout and an
     overall retry deadline;
  2. on success, run the live benchmark command as a subprocess with its
     own timeout, parse its final stdout line as the JSON result, and
     refresh the snapshot file;
  3. on persistent unavailability (or a live-run failure), emit the
     snapshot's result as a valid JSON line with `"stale": true`,
     `"stale_reason"`, `"probe_rc"`, `"snapshot_captured_utc"` and
     `"snapshot_age_h"` added: exit code 0 either way, so a caller records
     a parseable line.

Environment (all seconds but the device): LITCODER_BENCH_DEVICE (the
probed torch device, default "cuda"), LITCODER_BENCH_PROBE_TIMEOUT_S (per
probe, default 180), LITCODER_BENCH_PROBE_DEADLINE_S (total probing budget,
default 480), LITCODER_BENCH_LIVE_TIMEOUT_S (live run, default 3600),
LITCODER_BENCH_SNAPSHOT_MAX_AGE_H (hours after which a stale line is marked
expired, default 72).
"""

import json
import os
import subprocess
import sys
import time
from datetime import datetime, timezone
from typing import List, Optional, Tuple

# Fresh-subprocess probe: initialise the device that LITCODER_BENCH_DEVICE
# names and force one real launch by fetching a scalar. A request for CUDA
# where there is none raises inside the subprocess: nothing falls back to
# the CPU.
_PROBE_CODE = (
    "import os, torch;"
    "d = torch.device(os.environ.get('LITCODER_BENCH_DEVICE', 'cuda'));"
    "x = torch.ones((256, 256), device=d);"
    "s = float(torch.sum(x @ x));"
    "assert s == 256.0 * 256 * 256, s;"
    "print(d.type)"
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def probe_backend(timeout_s: Optional[float] = None) -> Tuple[bool, object]:
    """One fresh-subprocess device probe.

    Returns (ok, rc) where rc is the subprocess return code, or the string
    'timeout' when the probe hung past `timeout_s`.
    """
    if timeout_s is None:
        timeout_s = _env_float("LITCODER_BENCH_PROBE_TIMEOUT_S", 180.0)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return False, "timeout"
    return proc.returncode == 0, proc.returncode


def wait_for_backend(deadline_s: Optional[float] = None,
                     probe_timeout_s: Optional[float] = None,
                     sleep_s: float = 30.0) -> Tuple[bool, object]:
    """Probe until success or until `deadline_s` of total budget is spent.

    Returns (ok, last_rc). Always runs at least one probe.
    """
    if deadline_s is None:
        deadline_s = _env_float("LITCODER_BENCH_PROBE_DEADLINE_S", 480.0)
    t0 = time.monotonic()
    ok, rc = probe_backend(probe_timeout_s)
    while not ok:
        remaining = deadline_s - (time.monotonic() - t0)
        if remaining <= 0:
            break
        time.sleep(min(sleep_s, remaining))
        ok, rc = probe_backend(probe_timeout_s)
    return ok, rc


def load_snapshot(path: str) -> Optional[dict]:
    """Read a snapshot file: {'captured_utc': ..., 'result': {...}} (also
    tolerates a bare result dict); None when absent or unreadable."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            snap = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    if not isinstance(snap, dict):
        return None
    if "result" not in snap and "metric" in snap:
        snap = {"captured_utc": snap.get("note", "unknown"), "result": snap}
    return snap if isinstance(snap.get("result"), dict) else None


def save_snapshot(path: str, result: dict, note: str = "") -> None:
    snap = {
        "captured_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "result": result,
    }
    if note:
        snap["note"] = note
    with open(path, "w") as f:
        json.dump(snap, f, indent=1)


def snapshot_age_hours(snapshot: dict) -> Optional[float]:
    """Hours since the snapshot was captured; None when unparseable."""
    try:
        captured = datetime.fromisoformat(snapshot.get("captured_utc", ""))
    except (ValueError, TypeError):
        return None
    if captured.tzinfo is None:
        captured = captured.replace(tzinfo=timezone.utc)
    return (datetime.now(timezone.utc) - captured).total_seconds() / 3600.0


def _emit_stale(snapshot: dict, reason: str, probe_rc) -> int:
    result = dict(snapshot["result"])
    result["stale"] = True
    result["stale_reason"] = reason
    result["probe_rc"] = probe_rc
    result["snapshot_captured_utc"] = snapshot.get("captured_utc", "unknown")
    # A stale line must never silently stand in for old code: past the max
    # age, or with an unparseable capture time, it is marked expired. rc
    # stays 0 so the line is still parseable, but the marker disqualifies
    # it as a performance claim.
    age_h = snapshot_age_hours(snapshot)
    max_age_h = _env_float("LITCODER_BENCH_SNAPSHOT_MAX_AGE_H", 72.0)
    result["snapshot_age_h"] = None if age_h is None else round(age_h, 2)
    if age_h is None or age_h > max_age_h:
        result["stale_expired"] = True
        result["stale_reason"] = (
            f"{reason}; snapshot EXPIRED "
            f"(age {'unknown' if age_h is None else f'{age_h:.1f} h'} "
            f"> max {max_age_h:.0f} h)")
    print(json.dumps(result))
    return 0


def run_guarded(live_argv: List[str], snapshot_path: str,
                live_timeout_s: Optional[float] = None) -> int:
    """Probe -> live run -> snapshot refresh, with stale fallback.

    Returns the process exit code to use (0 on success OR stale fallback;
    nonzero only when the live path failed AND no snapshot exists).
    """
    if live_timeout_s is None:
        live_timeout_s = _env_float("LITCODER_BENCH_LIVE_TIMEOUT_S", 3600.0)
    snapshot = load_snapshot(snapshot_path)

    ok, rc = wait_for_backend()
    if not ok:
        if snapshot is not None:
            return _emit_stale(
                snapshot,
                "device unavailable at capture time (fresh-subprocess "
                "probe failed within the deadline)", rc)
        print(json.dumps({"metric": "bench_failed", "value": None,
                          "unit": "device unavailable and no snapshot",
                          "vs_baseline": None, "probe_rc": rc}))
        return 1

    try:
        proc = subprocess.run(live_argv, capture_output=True, text=True,
                              timeout=live_timeout_s)
        lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
            else None
        if isinstance(result, dict) and result.get("value") is not None:
            save_snapshot(snapshot_path, result)
            print(json.dumps(result))
            return 0
        reason = (f"live bench rc={proc.returncode}; stderr tail: "
                  f"{proc.stderr.strip()[-300:]}")
    except subprocess.TimeoutExpired:
        reason = f"live bench timed out after {live_timeout_s:.0f}s"
    except json.JSONDecodeError as e:
        reason = f"live bench produced unparseable output ({e})"

    if snapshot is not None:
        return _emit_stale(snapshot, reason, rc)
    print(json.dumps({"metric": "bench_failed", "value": None,
                      "unit": reason, "vs_baseline": None}))
    return 1

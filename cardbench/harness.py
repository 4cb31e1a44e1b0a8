"""One run of one cell: set up, measure for a fixed window, check, report.

Everything that belongs to one cell, configuration or metric is a file found
by its name: workloads/<cell>.json names its configuration
(configs/<config>.json), its entry (entries/<entry>.py, which builds the
inputs and drives the program) and its parameters; metrics/<metric>.py
reads one metric. BENCHMARK.json, at the root of the checkout, says which
metrics a cell reports.

The window runs whole jobs back to back and finishes the one it started
before its end: a job's time is the window's length over the jobs it
completed, so a stall anywhere in it shows. With --trace 1 the same window
runs under torch.profiler and the cell's per-layer metrics are read from
the trace, the jobs' records and the program's counters.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from cardbench import tracing
from cardbench.compare import verdict

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "litcoder_core_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the file at `path` as a module of its own (names may hold
    dots, so not through the package import system)."""
    name = "cardbench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one the runs may not load."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in BANNED_MODULES})


def merged(base: Dict, override: Optional[Dict]) -> Dict:
    out = dict(base)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = value
    return out


@dataclass
class Cell:
    """What a run knows of its cell."""

    name: str
    workload: Dict
    config: Dict
    seed: int
    device: str
    spec: Dict          # BENCHMARK.json's entry for the cell

    @property
    def params(self) -> Dict:
        return self.workload["params"]


@dataclass
class Reading:
    """What the metric readers read: the window, its jobs, the trace."""

    cell: Cell
    job: Any
    records: List[Dict]
    window_s: float
    setup_s: float
    peak_window_bytes: int
    trace: Any = None
    traced_jobs: int = 0
    peaks: Dict = field(default_factory=dict)

    @property
    def jobs(self) -> int:
        return len(self.records)


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: end-to-end without a trace, per-layer
    with one (a metric without a `workloads` list belongs to every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_cell(bench: Dict, name: str, seed: int, device: str,
              overrides: Optional[Dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its workload and configuration
    files (`overrides` merged into both: the CPU tests' tiny sizes)."""
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    if (workload["config"], workload["traffic"]) != (spec["config"],
                                                     spec["traffic"]):
        raise ValueError(f"workloads/{name}.json disagrees with "
                         f"BENCHMARK.json on its config or traffic")
    overrides = overrides or {}
    config = merged(config, overrides.get("config"))
    workload = merged(workload, {"params": overrides.get("params", {})})
    return Cell(name, workload, config, seed, device, spec)


def new_job(cell: Cell):
    """The cell's entry (entries/<entry>.py) set up for its seed."""
    entry = load_module(BENCH_DIR / "entries" / f"{cell.workload['entry']}.py")
    return entry.Job(cell)


def card_record() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return f"{query}: {out.stdout.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


# A traced run profiles the window's first jobs, up to the one running at
# TRACE_SECONDS: whole jobs, and a trace whose reading fits in the run. The
# trace-read metrics describe those jobs; the rest of the window runs
# untraced, and the trace is read after it.
TRACE_SECONDS = 10.0


def trace_summary(prof):
    """The TraceSummary of a stopped profiler, through a Chrome trace in
    the temporary directory (removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.summarize(tracing.read_chrome_trace(path))
    finally:
        os.unlink(path)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[Dict] = None,
             t_start: Optional[float] = None, log=None) -> Dict:
    """One run of cell `name`; returns the result line as a dict.

    `device` 'cpu' and `overrides` (merged into the configuration and the
    cell's parameters) exist for the CPU tests, which drive tiny cells."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, name, seed, device, overrides)
    spec, workload = cell.spec, cell.workload
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < spec["chips"]:
            raise NoCard(f"cell {name} needs {spec['chips']} CUDA device(s); "
                         f"torch finds {torch.cuda.device_count()}")
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    job = new_job(cell)
    sync()
    t_inputs = time.perf_counter()
    job.run_once()                      # the warm-up: every shape, built
    sync()
    setup_s = time.perf_counter() - t_start
    warm_s = t_inputs - t_start, time.perf_counter() - t_inputs
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    prof = stopped = summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        window_span = record_function(tracing.WINDOW)
        window_span.__enter__()
    records, traced = [], 0
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < seconds:
        if prof is None:
            records.append(job.run_once())
            continue
        with record_function(tracing.JOB):
            records.append(job.run_once())
        traced += 1
        if time.perf_counter() - t0 >= TRACE_SECONDS or \
                time.perf_counter() - t0 >= seconds:
            window_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            stopped, prof = prof, None
    sync()
    window_s = time.perf_counter() - t0
    if stopped is not None:
        summary = trace_summary(stopped)
        del stopped
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    memory_peak = max(setup_peak, peak_window)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    job.release()                       # the program's state goes first
    t_check = time.perf_counter()
    numbers = [job.check(r) for r in records]
    check_s = time.perf_counter() - t_check
    limits = workload["limits"]
    verdicts = [verdict(n, limits) for n in numbers]
    failed = sum(1 for ok, _ in verdicts if not ok)
    worst = {}
    for _, table in verdicts:
        for key, row in table.items():
            if key not in worst or not row["value"] <= worst[key]["value"]:
                worst[key] = row

    reading = Reading(cell, job, records, window_s, setup_s, peak_window,
                      summary, traced, load_json(BENCH_DIR / "peaks.json"))
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(
            reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if on_card:
        log(f"cardbench: {card_record()}")
    log(f"cardbench: {name} seed {seed}: setup_s {setup_s:.4f} (to the "
        f"inputs {warm_s[0]:.2f} s, the warm-up job {warm_s[1]:.2f} s, the "
        f"kernel's build {job.build_seconds():.2f} s of it), {len(records)} "
        f"jobs in {window_s:.4f} s, the check {check_s:.2f} s")
    result = {
        "correct": failed == 0 and bool(records),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": spec["chips"], "memory_peak_bytes": memory_peak},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = worst
    return result


def check_lines(result: Dict) -> List[str]:
    """The compared numbers beside their limits, one line each."""
    return [f"check {key}: {row['value']!r} (limit {row['limit']!r})"
            for key, row in result["checks"].items()]


def jsonable(x):
    """The result with every non-finite number as a string (JSON has none)."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x

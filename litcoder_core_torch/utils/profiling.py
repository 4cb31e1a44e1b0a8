"""Tracing and profiling (twin of litcoder_core_tpu/utils/profiling.py).

- StageTimer: per-stage wall-clock accounting with a report.
- trace(): a torch.profiler context (host, and the card when there is one)
  that writes a Chrome/Perfetto trace under `log_dir`.
- annotate(): a named region (torch.profiler.record_function) that shows
  in such traces.
"""

import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named stage.

    `sync_fn` runs at the end of each stage before the clock is read; on a
    card pass torch.cuda.synchronize, or asynchronous launches would count
    in whichever later stage waits for them."""

    def __init__(self, sync_fn=None):
        self._sync_fn = sync_fn
        self._stages: List[Tuple[str, float]] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync_fn is not None:
                self._sync_fn()
            self._stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self._stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> Dict[str, float]:
        totals = self.totals()
        total = sum(totals.values()) or 1.0
        for name, dt in sorted(totals.items(), key=lambda kv: -kv[1]):
            logger.info("stage %-24s %8.3fs  (%4.1f%%)", name, dt,
                        100.0 * dt / total)
        logger.info("stage %-24s %8.3fs", "TOTAL", total)
        return totals


@contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile the block with torch.profiler (CPU activity, and CUDA when a
    card is present) and write its trace to
    `log_dir`/trace_<pid>_<ns>.json (Chrome trace format; open it in
    ui.perfetto.dev or chrome://tracing). Yields the profiler. There is no
    trace server to link to: with `create_perfetto_link` the path of the
    written file is logged instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        logger.info("trace written to %s; open it in ui.perfetto.dev", path)


def annotate(name: str):
    """Named region annotation visible in profiler traces."""
    from torch.profiler import record_function

    return record_function(name)

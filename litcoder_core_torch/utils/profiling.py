"""Tracing and profiling (twin of litcoder_core_tpu/utils/profiling.py).

- annotate(name, **counts): the port's span. Spans are off unless a torch
  profiler is running (torch.autograd.profiler._is_profiler_enabled: the
  benchmark's traced runs, trace() below). Off, a span reads the host
  clock at its ends (its `seconds`) and nothing else: no
  record_function, no record. On, it also enters
  torch.profiler.record_function(name), so it sits in the profiler's
  trace on the device activity's clock; appends an entry to the module's
  record (name, its parent's index, host start and end from
  time.perf_counter_ns, its counts); and, once the process has
  initialised CUDA, records a pair of timing events on the current
  stream at its ends. It never synchronizes: spans() resolves the pair
  to device-stream seconds when the record is read, and a count held as
  a device tensor (set while `recording`) to an int. The program's spans
  are named litcoder.<layer>.<stage>.
- spans() / clear_spans(): the record.
- StageTimer: per-stage wall-clock accounting with a report; each stage
  is also the span <span_prefix>.<stage>.
- trace(): a torch.profiler context (host, and the card when there is one)
  that writes a Chrome/Perfetto trace under `log_dir`; it clears the
  record when it starts.
"""

import contextlib
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

_record: List[Dict[str, Any]] = []
_lock = threading.Lock()
_open = threading.local()       # .stack: indices of this thread's open spans


class annotate(contextlib.ContextDecorator):
    """A named span of the port's work, with integer `counts` (more may be
    set on `span.counts` inside the block); `seconds` is its host time once
    the block has left. Also a decorator: each call is a span of its own.
    See the module docstring for what a span records and when."""

    def __init__(self, name: str, **counts: int):
        self.name = name
        self.counts = counts
        self.start_ns = self.end_ns = 0
        self._entry: Optional[Dict[str, Any]] = None

    def _recreate_cm(self):
        return annotate(self.name, **self.counts)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def recording(self) -> bool:
        """Whether the open span goes into the record (a profiler runs):
        counts that cost device work are worth computing only then."""
        return self._entry is not None

    def __enter__(self) -> "annotate":
        if _autograd_profiler._is_profiler_enabled:
            self._begin()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._entry is not None:
            self._end(exc)
        return False

    def _begin(self) -> None:
        import torch
        from torch.profiler import record_function

        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._function = record_function(self.name)
        self._function.__enter__()
        entry = {"name": self.name, "parent": stack[-1] if stack else None,
                 "start_ns": 0, "end_ns": None, "counts": self.counts,
                 "device_s": None}
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            entry["_events"] = [start, None]
        with _lock:
            self._index = len(_record)
            _record.append(entry)
        stack.append(self._index)
        self._entry = entry

    def _end(self, exc) -> None:
        import torch

        entry, self._entry = self._entry, None
        entry["start_ns"], entry["end_ns"] = self.start_ns, self.end_ns
        if "_events" in entry:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            entry["_events"][1] = end
        stack = _open.stack
        if stack and stack[-1] == self._index:   # not cleared meanwhile
            stack.pop()
        self._function.__exit__(*exc)


def spans() -> List[Dict[str, Any]]:
    """The record, oldest span first (not cleared). Each entry: `name`;
    `parent`, the index in the record of the span it opened in, None for
    a root span (whose index identifies its call); `start_ns`, `end_ns`
    (time.perf_counter_ns; `end_ns` None while open); `counts` (a count
    set as a tensor is read as an int); `device_s`, the current CUDA
    stream's seconds from its start to its end, None where no CUDA events
    were recorded. Reading waits for the device to reach each span's end
    event."""
    import torch

    with _lock:
        entries = list(_record)
    for entry in entries:
        counts = entry["counts"]
        for key, value in counts.items():
            if isinstance(value, torch.Tensor):
                counts[key] = int(value)
        events = entry.get("_events")
        if events is not None and events[1] is not None:
            events[1].synchronize()
            entry["device_s"] = events[0].elapsed_time(events[1]) / 1e3
            del entry["_events"]
    return entries


def clear_spans() -> None:
    """Empty the record (spans open now are left out of it)."""
    with _lock:
        _record.clear()
    if getattr(_open, "stack", None):
        _open.stack.clear()


class StageTimer:
    """Accumulates wall-clock per named stage; each stage is also the span
    `<span_prefix>.<name>`.

    `sync_fn` runs at the end of each stage before the clock is read; on a
    card pass torch.cuda.synchronize, or asynchronous launches would count
    in whichever later stage waits for them."""

    def __init__(self, sync_fn=None, span_prefix: str = "litcoder.train"):
        self._sync_fn = sync_fn
        self._span_prefix = span_prefix
        self._stages: List[Tuple[str, float]] = []

    @contextmanager
    def stage(self, name: str):
        with annotate(f"{self._span_prefix}.{name}"):
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
    ui.perfetto.dev or chrome://tracing). The port's litcoder.* spans show
    in it, and spans() holds the block's spans (the record is cleared
    first). Yields the profiler. There is no trace server to link to: with
    `create_perfetto_link` the path of the written file is logged
    instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        logger.info("trace written to %s; open it in ui.perfetto.dev", path)

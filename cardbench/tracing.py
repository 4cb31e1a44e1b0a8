"""The traced run's reading of a torch.profiler Chrome trace.

The window is the span of the user annotation WINDOW. Device activity is
every kernel, copy and memset event inside it; busy time is the length of
their union, and idle time the rest of the window. Each idle gap is named
by what the host was doing at its middle: the innermost traced host event
(an aten op, a CUDA runtime call or an annotation) that covers it, or
HOST_PYTHON when only the harness's own spans do.
"""

import heapq
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

WINDOW = "cardbench.window"
JOB = "cardbench.job"
HOST_PYTHON = "host Python between traced ops"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s_by_name: Dict[str, float] = field(default_factory=dict)
    launches_by_name: Dict[str, int] = field(default_factory=dict)
    idle_s_by_host: Dict[str, float] = field(default_factory=dict)

    def device_s(self, needles: Iterable[str]) -> float:
        """Device seconds of the events whose lower-cased name holds any of
        `needles`."""
        needles = [n.lower() for n in needles]
        return sum(s for name, s in self.device_s_by_name.items()
                   if any(n in name.lower() for n in needles))

    def launches(self, needles: Iterable[str]) -> int:
        needles = [n.lower() for n in needles]
        return sum(c for name, c in self.launches_by_name.items()
                   if any(n in name.lower() for n in needles))

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_s_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def _merged(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """TraceSummary of Chrome-trace events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])

    device: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        if t <= s:
            continue
        device.append((s, t))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) / 1e6
        count[e["name"]] = count.get(e["name"], 0) + 1
    busy = _merged(device)

    gaps, cursor = [], lo
    for s, t in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if hi > cursor:
        gaps.append((cursor, hi))

    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in spans
        if e.get("cat") in HOST_CATS and e.get("name") not in (WINDOW, JOB))
    idle: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    i = 0
    for s, t in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + t) / 2
        while i < len(host) and host[i][0] <= mid:
            h0, h1, name = host[i]
            heapq.heappush(active, (h1 - h0, h1, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else HOST_PYTHON
        idle[label] = idle.get(label, 0.0) + (t - s) / 1e6
    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(t - s for s, t in busy) / 1e6,
        device_s_by_name=by_name, launches_by_name=count,
        idle_s_by_host=idle)


def read_chrome_trace(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data

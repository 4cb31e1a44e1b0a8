"""Readers of the program's spans: litcoder_core_torch.utils.profiling.
spans(), read after the window. The profiler ran over the traced jobs
only, and spans record only under a profiler, so the record holds exactly
those jobs. A reader sums the spans of one name and divides by the traced
jobs; None where the record has no such span (or the program keeps no
record).

device: the span's device-stream seconds (a CUDA event pair on the
current stream); where the span recorded no events (a CPU run, whose
work runs on the host) its host seconds. host: time.perf_counter_ns at
its ends. Self time takes the host seconds of its direct child spans out.
"""

from typing import Dict, List, Optional


def record() -> List[Dict]:
    """The program's closed spans ([] where it keeps no record)."""
    try:
        from litcoder_core_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    return [s for s in read() if s.get("end_ns") is not None]


def host_s(span: Dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def device_s(span: Dict) -> float:
    return span["device_s"] if span["device_s"] is not None else host_s(span)


def seconds_per_job(reading, name: str, clock: str = "device",
                    self_time: bool = False,
                    spans: Optional[List[Dict]] = None) -> Optional[float]:
    """Seconds per traced job in the spans named `name`, on `clock`
    ('device' or 'host'); `self_time` (host clock) takes each span's direct
    children out. `spans`: the record to read (default: the program's)."""
    if not reading.traced_jobs:
        return None
    spans = record() if spans is None else spans
    picked = [i for i, s in enumerate(spans) if s["name"] == name]
    if not picked:
        return None
    if clock == "device":
        total = sum(device_s(spans[i]) for i in picked)
    else:
        total = sum(host_s(spans[i]) for i in picked)
    if self_time:
        mine = set(picked)
        total -= sum(host_s(s) for s in spans if s["parent"] in mine)
    return total / reading.traced_jobs

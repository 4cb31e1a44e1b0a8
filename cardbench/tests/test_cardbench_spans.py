"""The span readers (metrics/_spans.py) on a synthetic record: seconds per
traced job, device against host seconds, self time, and None where a span
is absent or the program keeps no record."""

from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.metrics import _spans


def span(name, parent, t0, t1, device_s=None):
    """A closed span from t0 to t1 host seconds."""
    return {"name": name, "parent": parent, "start_ns": int(t0 * 1e9),
            "end_ns": int(t1 * 1e9), "counts": {}, "device_s": device_s}


RECORD = [
    span("litcoder.fit", None, 0.0, 10.0, 10.0),              # 0
    span("litcoder.fit.search", 0, 0.0, 2.0, 6.0),             # 1
    span("litcoder.fit.gram", 1, 0.5, 0.6, 1.5),               # 2
    span("litcoder.fit.host_stats", 0, 9.0, 9.5, 0.25),        # 3
    span("litcoder.fit", None, 10.0, 20.0, 10.0),             # 4
    span("litcoder.fit.search", 4, 10.0, 12.0, 5.0),           # 5
    span("litcoder.fit.host_stats", 4, 19.0, 19.25, 0.5),      # 6
    span("litcoder.lm.dispatch", None, 30.0, 31.0),           # 7
    span("litcoder.lm.fetch_wait", 7, 30.5, 30.75),            # 8
    span("litcoder.lm.dispatch", None, 31.0, 33.0),           # 9
    span("litcoder.lm.fetch_wait", None, 33.0, 33.5),         # 10
]


def reading(jobs=2):
    return SimpleNamespace(traced_jobs=jobs)


def test_sums_by_name_over_traced_jobs():
    got = _spans.seconds_per_job(reading(), "litcoder.fit.search",
                                 spans=RECORD)
    assert got == pytest.approx((6.0 + 5.0) / 2)
    got = _spans.seconds_per_job(reading(4), "litcoder.fit.search",
                                 spans=RECORD)
    assert got == pytest.approx((6.0 + 5.0) / 4)


def test_device_against_host_seconds():
    assert _spans.seconds_per_job(reading(), "litcoder.fit.host_stats",
                                  "host", spans=RECORD) == pytest.approx(
        (0.5 + 0.25) / 2)
    assert _spans.seconds_per_job(reading(), "litcoder.fit.host_stats",
                                  "device", spans=RECORD) == pytest.approx(
        (0.25 + 0.5) / 2)
    # no CUDA events (a CPU run): device seconds are the host seconds
    assert _spans.seconds_per_job(reading(1), "litcoder.lm.fetch_wait",
                                  "device", spans=RECORD) == pytest.approx(
        0.75)


def test_self_time_takes_direct_children_out():
    got = _spans.seconds_per_job(reading(1), "litcoder.lm.dispatch", "host",
                                 self_time=True, spans=RECORD)
    assert got == pytest.approx((1.0 - 0.25) + 2.0)
    # gram is search's child, not host_stats': nothing to take out
    got = _spans.seconds_per_job(reading(1), "litcoder.fit.host_stats",
                                 "host", self_time=True, spans=RECORD)
    assert got == pytest.approx(0.75)


def test_absent_spans_and_untraced_runs_read_none():
    assert _spans.seconds_per_job(reading(), "litcoder.fit.lmax",
                                  spans=RECORD) is None
    assert _spans.seconds_per_job(reading(0), "litcoder.fit.search",
                                  spans=RECORD) is None
    assert _spans.seconds_per_job(reading(), "litcoder.fit.search",
                                  spans=[]) is None


def test_open_spans_are_left_out(monkeypatch):
    from litcoder_core_torch.utils import profiling

    opened = dict(span("litcoder.fit.lmax", None, 0.0, 1.0), end_ns=None)
    monkeypatch.setattr(profiling, "spans", lambda: RECORD + [opened])
    assert len(_spans.record()) == len(RECORD)
    assert _spans.seconds_per_job(reading(), "litcoder.fit.lmax") is None


def test_a_program_without_a_record_reads_none(monkeypatch):
    from litcoder_core_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _spans.record() == []
    module = harness.load_module(harness.BENCH_DIR / "metrics"
                                 / "search_s.fit.py")
    assert module.read(reading()) is None


@pytest.mark.parametrize("metric, want", [
    ("search_s.fit", (6.0 + 5.0) / 2),
    ("gram_s.fit", 1.5 / 2),
    ("host_stats_s.fit", (0.5 + 0.25) / 2),
    ("lm_host_prep_s.train", (0.75 + 2.0) / 2),
    ("lm_fetch_wait_s.train", (0.25 + 0.5) / 2),
    ("lmax_s.full_cv", None),
])
def test_metric_files_read_the_record(monkeypatch, metric, want):
    from litcoder_core_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: RECORD)
    module = harness.load_module(harness.BENCH_DIR / "metrics"
                                 / f"{metric}.py")
    got = module.read(reading())
    assert got == (None if want is None else pytest.approx(want))

"""The traced run's busy time, idle share and gap labels from a synthetic
Chrome trace."""

import json

import pytest

from cardbench import tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(tracing.WINDOW, "user_annotation", 0.0, 100.0),
    ev(tracing.JOB, "user_annotation", 0.0, 100.0),
    ev("k1", "kernel", 10.0, 20.0),
    ev("k2", "kernel", 20.0, 20.0),
    ev("Memcpy DtoH", "gpu_memcpy", 60.0, 10.0),
    ev("k1", "kernel", 95.0, 10.0),             # runs past the window
    ev("aten::item", "cpu_op", 38.0, 24.0),
    ev("cudaStreamSynchronize", "cuda_runtime", 45.0, 13.0),
    ev("aten::mm", "cpu_op", 200.0, 5.0),       # outside the window
]


def test_busy_and_window():
    s = tracing.summarize(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    # [10, 40] + [60, 70] + [95, 100]
    assert s.busy_s == pytest.approx(45e-6)
    assert s.device_s_by_name["k1"] == pytest.approx(25e-6)
    assert s.launches(["k"]) == 3


def test_gaps_named_by_innermost_host_event():
    s = tracing.summarize(EVENTS)
    # [0, 10] and [70, 95]: only the harness's spans; [40, 60]: the sync
    # inside aten::item.
    assert s.idle_s_by_host == {
        tracing.HOST_PYTHON: pytest.approx(35e-6),
        "cudaStreamSynchronize": pytest.approx(20e-6)}
    b = s.breakdown(top=1)
    assert b["device_ops"] == [["k1", pytest.approx(25e-6)]]
    assert b["idle_gaps"][0][0] == tracing.HOST_PYTHON


def test_family_sums():
    s = tracing.summarize(EVENTS + [ev("sm90_xmma_gemm_f32", "kernel", 70.0,
                                       5.0)])
    assert s.device_s(["gemm"]) == pytest.approx(5e-6)


def test_no_window_is_an_error(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS[2:]}))
    with pytest.raises(ValueError):
        tracing.summarize(tracing.read_chrome_trace(str(path)))

"""weights_to_host_s.train, the host seconds of the refit's weights on
their way to the host (`litcoder.fit.weights_to_host` spans): read from a
synthetic record, silent on a program without the span, and read in the
tiny traced lebel.train_lm cell on the CPU inside its fit."""

from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.tests.test_cardbench_moe_combine import span
from cardbench.tests.tiny import SEED, TINY

METRIC = "weights_to_host_s.train"


def host_span(name, parent, seconds):
    s = span(name, parent, None)
    s["end_ns"] = int(seconds * 1e9)
    return s


def reader():
    return harness.load_module(harness.BENCH_DIR / "metrics"
                               / f"{METRIC}.py")


@pytest.mark.parametrize("record, want", [
    ([host_span("litcoder.fit.refit", None, 4.0),
      host_span("litcoder.fit.weights_to_host", 0, 0.5),
      host_span("litcoder.fit.refit", None, 4.0),
      host_span("litcoder.fit.weights_to_host", 2, 0.25),
      host_span("litcoder.fit.weights_to_host", 2, 0.25)], (0.5 + 0.5) / 2),
    ([host_span("litcoder.fit.refit", None, 4.0)], None),
], ids=["with_copies", "without_copies"])
def test_reads_the_weights_spans(monkeypatch, record, want):
    from litcoder_core_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: record)
    got = reader().read(SimpleNamespace(traced_jobs=2))
    assert got == (None if want is None else pytest.approx(want))


def test_tiny_traced_lm_cell_reads_the_copy_inside_the_fit():
    cell = "lebel.train_lm"
    out = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                           overrides=TINY[cell], log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"][METRIC]["value"]
    assert out["metrics"][METRIC]["unit"] == "s"
    from litcoder_core_torch.utils import profiling

    record = profiling.spans()
    copies = [s for s in record if s["name"] == "litcoder.fit.weights_to_host"]
    assert copies
    for s in copies:
        assert record[s["parent"]]["name"] == "litcoder.fit.refit"
        assert s["counts"]["staged"] == 0 and s["counts"]["blocks"] == 1

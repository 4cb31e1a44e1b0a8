"""moe_combine_s.train_dsv2, the device seconds of DeepSeek-V2's MoE combine
(`litcoder.lm.moe.combine` spans): read from a synthetic record, silent on
a program without the span, and read in the tiny traced
lebel.train_dsv2lite cell on the CPU as a part of moe_s.train_dsv2."""

from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.tests.test_cardbench_new_cells import TINY_NEW
from cardbench.tests.tiny import SEED

METRIC = "moe_combine_s.train_dsv2"


def span(name, parent, device_s):
    return {"name": name, "parent": parent, "start_ns": 0, "end_ns": 1,
            "counts": {}, "device_s": device_s}


def reader():
    return harness.load_module(harness.BENCH_DIR / "metrics"
                               / f"{METRIC}.py")


@pytest.mark.parametrize("record, want", [
    ([span("litcoder.lm.moe", None, 3.0),
      span("litcoder.lm.moe.experts", 0, 1.0),
      span("litcoder.lm.moe.combine", 0, 0.25),
      span("litcoder.lm.moe", None, 3.0),
      span("litcoder.lm.moe.combine", 3, 0.5)], (0.25 + 0.5) / 2),
    ([span("litcoder.lm.moe", None, 3.0),
      span("litcoder.lm.moe.experts", 0, 1.0)], None),
], ids=["with_combine", "without_combine"])
def test_reads_the_combine_spans(monkeypatch, record, want):
    from litcoder_core_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: record)
    got = reader().read(SimpleNamespace(traced_jobs=2))
    assert got == (None if want is None else pytest.approx(want))


def test_tiny_traced_dsv2_cell_reads_the_combine_inside_the_moe():
    cell = "lebel.train_dsv2lite"
    out = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                           overrides=TINY_NEW[cell], log=lambda msg: None)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert 0 < m[METRIC]["value"] < m["moe_s.train_dsv2"]["value"]
    assert m[METRIC]["unit"] == "s"

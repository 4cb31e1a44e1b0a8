"""lebel.banded_fit and lebel.train_dsv2lite at tiny sizes on the CPU:
each cell's whole path against its reference, the traced DeepSeek-V2 cell's
new per-layer metrics, the counts behind them, and the controls against
the program. Their tiny overrides live here (tests/tiny.py holds the
other cells')."""

import math

import numpy as np
import pytest
import torch

from cardbench import calibrate, harness
from cardbench.compare import verdict
from cardbench.metrics import _counts_moe
from cardbench.tests.tiny import SEED

TINY_NEW = {
    "lebel.banded_fit": {
        "config": {"n_train_trs": 400, "n_test_trs": 100, "n_voxels": 40},
        "params": {"widths": [12, 8, 4], "ranks": [4, 4, 2], "n_null": 4,
                   "block": 16, "n_voxels": 40}},
    "lebel.train_dsv2lite": {
        "config": {"vocab_size": 600, "hidden_size": 64,
                   "intermediate_size": 96, "moe_intermediate_size": 32,
                   "num_hidden_layers": 3, "num_attention_heads": 4,
                   "num_key_value_heads": 4, "n_routed_experts": 8,
                   "n_shared_experts": 1, "num_experts_per_tok": 2,
                   "kv_lora_rank": 16, "qk_nope_head_dim": 16,
                   "qk_rope_head_dim": 8, "v_head_dim": 16,
                   "n_voxels": 30, "trs_per_story": 120, "lookback": 16,
                   "n_features": 256, "layer_idx": 2},
        "params": {"words_per_story": 300, "block": 16, "signal_rank": 4}},
}
NEW_METRICS = {"mla_s.train_dsv2", "moe_s.train_dsv2",
               "moe_load_max.train_dsv2"}
TRACE_ONLY = {"moe_experts.roofline.train_dsv2", "mfu.train_dsv2",
              "idle_share.train"}


@pytest.fixture(scope="module")
def results():
    return {}


def run(cell, trace, results):
    key = (cell, trace)
    if key not in results:
        results[key] = harness.run_cell(cell, SEED, 0.2, trace,
                                        device="cpu",
                                        overrides=TINY_NEW[cell],
                                        log=lambda msg: None)
    return results[key]


@pytest.mark.parametrize("cell", sorted(TINY_NEW))
def test_tiny_new_cell_is_correct(cell, results):
    out = run(cell, False, results)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(
        harness.load_json(harness.ROOT / "BENCHMARK.json"), cell, False)}
    assert set(out["metrics"]) == e2e - {"peak_device_gib"}   # no card
    assert out["metrics"]["setup_s"]["value"] > 0


def test_traced_dsv2_cell_reads_every_new_metric(results):
    out = run("lebel.train_dsv2lite", True, results)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    per_layer = {x["name"] for x in harness.metrics_for(
        harness.load_json(harness.ROOT / "BENCHMARK.json"),
        "lebel.train_dsv2lite", True)}
    # No device on the CPU: the trace-read metrics stay silent.
    assert set(m) == per_layer - TRACE_ONLY
    assert NEW_METRICS <= set(m)
    assert m["moe_s.train_dsv2"]["value"] > 0
    assert m["mla_s.train_dsv2"]["value"] > 0
    assert m["moe_load_max.train_dsv2"]["value"] >= 1.0


def test_dsv2_job_runs_the_port_module_in_bf16():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, "lebel.train_dsv2lite", SEED, "cpu",
                             TINY_NEW["lebel.train_dsv2lite"])
    job = harness.new_job(cell)
    from litcoder_core_torch.features.deepseek_v2 import DeepseekV2Model

    model = job.extractor._compute_model
    assert isinstance(model, DeepseekV2Model)
    assert model is job.extractor._model            # no bf16 copy
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    gate_up = model.layers[1].mlp.experts.gate_up_proj  # stacked on load
    assert gate_up.dtype == torch.bfloat16
    assert gate_up.data_ptr() == job.weights[   # the reference reads them
        "layers.1.mlp.experts.0.gate_proj.weight"].data_ptr()
    assert len(model.layers) == cell.config["num_hidden_layers"]


@pytest.mark.parametrize("cell", sorted(TINY_NEW))
def test_the_program_passes_and_the_control_reads_higher(cell):
    """The program within the cell's limits; the DeepSeek-V2 control
    (float8 matmuls in the LM) further from the reference on the design
    than the program, by several times. On the card the control fails
    the limits (PERF.md section 2); at 3 layers of width 64 its deficit
    is smaller. On the CPU TF32 changes nothing, so the banded control is
    the reference itself."""
    row = calibrate.readings(cell, SEED, True, device="cpu",
                             overrides=TINY_NEW[cell])
    limits = harness.load_json(harness.BENCH_DIR / "workloads"
                               / f"{cell}.json")["limits"]
    assert verdict(row["program"], limits)[0], row["program"]
    if cell == "lebel.train_dsv2lite":
        assert row["control"]["design_gap"] > 4 * row["program"][
            "design_gap"]
        assert row["control"]["r_gap"] > 2 * row["program"]["r_gap"]


def test_fit_numbers_catch_a_fit_below_float32():
    """The DeepSeek-V2 cell's LM-level limits leave room for a fit in a
    lower precision; its fit_* numbers, which judge the fit on the design
    it was given, do not. A fit whose r is the refit on its design rounded
    to bfloat16 passes every LM-level limit and fails fit_r_gap."""
    from cardbench.reference import ridge, stats

    cell_name = "lebel.train_dsv2lite"
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, cell_name, SEED, "cpu",
                             TINY_NEW[cell_name])
    job = harness.new_job(cell)
    out = dict(job.run_once()["outputs"])
    job.release()
    ref = job._reference()
    _, Y, _, Yte = ref["inputs"]
    X, Xte = (torch.as_tensor(d).bfloat16().float() for d in out["design"])
    out["r"] = ridge.refit_r(X, Y, Xte, Yte, out["alphas"],
                             cell.params["block"]).numpy()
    out["p"] = stats.pearson_pvalues(out["r"], Xte.shape[0])
    out["q"] = stats.bh_adjust(out["p"])
    nums = job.numbers(out, ref)
    limits = harness.load_json(harness.BENCH_DIR / "workloads"
                               / f"{cell_name}.json")["limits"]
    lm_level = {k: v for k, v in limits.items() if not k.startswith("fit_")}
    assert verdict(nums, lm_level)[0], nums
    assert nums["fit_r_gap"] > limits["fit_r_gap"], nums


def test_moe_counts_of_deepseek_v2_lite():
    c = harness.load_json(harness.BENCH_DIR / "configs"
                          / "lebel_uts03_deepseek_v2_lite.json")
    params, layers = _counts_moe.active_params(c)
    assert layers == 27
    assert 2.2e9 < params < 2.3e9       # about 2.24 B active, embeddings out
    assert _counts_moe.lm_flops([[1, 2, 3]], c) == pytest.approx(
        2 * params * 3 + 27 * 2 * 16 * (192 + 128) * 6)
    n_bytes, ops = _counts_moe.expert_gemm_counts(100, 64, c)
    assert ops == 6.0 * 600 * 2048 * 1408
    assert n_bytes == 2.0 * (600 * (2 * 2048 + 3 * 1408)
                             + 64 * 3 * 2048 * 1408)


def test_banded_reference_gammas_are_the_programs():
    from litcoder_core_torch.models.banded import sample_gammas
    from cardbench.reference import banded

    for seed in (0, SEED):
        assert np.array_equal(banded.sample_gammas(3, 5, seed),
                              sample_gammas(3, 5, seed=seed))


def test_fp8_matmul_is_coarser_than_bf16():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 256, generator=gen)
    b = torch.randn(256, 32, generator=gen)
    exact = a @ b
    from cardbench.reference.deepseek_v2 import fp8_matmul

    bf16 = (a.bfloat16().float() @ b.bfloat16().float())
    gap8 = float((fp8_matmul(a, b) - exact).abs().max())
    gap16 = float((bf16 - exact).abs().max())
    assert gap8 > 4 * gap16 and math.isfinite(gap8)

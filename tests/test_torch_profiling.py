"""The port's spans (litcoder_core_torch/utils/profiling.py) on the CPU:
off without a profiler, the record under one, the spans of every fit route,
of the LM extractor and of the trainer's stages, and results that do not
depend on whether a profiler runs."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litcoder_core_torch import fit_nested_cv
from litcoder_core_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def profiler():
    """A CPU torch.profiler over the block, with the record emptied first;
    yields the profiler."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof
    profiling.clear_spans()


def _problem(T=300, D=12, V=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    Y = (X @ rng.normal(size=(D, V))
         + 2.0 * rng.normal(size=(T, V))).astype(np.float32)
    return X, Y


def _under_profiler(call):
    """(call's result, the record of its spans) under a CPU profiler."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = call()
    record = profiling.spans()
    profiling.clear_spans()
    return out, record


def test_off_records_nothing_and_never_calls_record_function(monkeypatch):
    calls = []

    def record_function(name):
        calls.append(name)
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    profiling.clear_spans()
    with profiling.annotate("litcoder.test.off", n=3) as span:
        span.counts["more"] = 1
    assert span.seconds >= 0.0
    X, Y = _problem()
    fit_nested_cv(X[:240], Y[:240], X[240:], Y[240:], device="cpu")
    assert calls == []
    assert profiling.spans() == []


def test_nested_spans_parents_counts_and_host_clock(profiler):
    with profiling.annotate("litcoder.test.a", n=2) as a:
        with profiling.annotate("litcoder.test.b"):
            with profiling.annotate("litcoder.test.c", k=1):
                pass
        with profiling.annotate("litcoder.test.b") as b2:
            b2.counts["late"] = 5
        a.counts["m"] = 7
    with profiling.annotate("litcoder.test.a"):
        pass
    record = profiling.spans()
    assert [s["name"] for s in record] == [
        "litcoder.test.a", "litcoder.test.b", "litcoder.test.c",
        "litcoder.test.b", "litcoder.test.a"]
    assert [s["parent"] for s in record] == [None, 0, 1, 0, None]
    assert record[0]["counts"] == {"n": 2, "m": 7}
    assert record[2]["counts"] == {"k": 1}
    assert record[3]["counts"] == {"late": 5}
    for s in record:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_s"] is None          # no CUDA events on the CPU
    assert record[0]["start_ns"] <= record[1]["start_ns"]
    assert record[1]["end_ns"] <= record[0]["end_ns"]
    assert profiling.spans() == record        # reading does not clear
    assert (record[0]["end_ns"] - record[0]["start_ns"]) / 1e9 == a.seconds


def test_decorator_makes_each_call_a_span(profiler):
    @profiling.annotate("litcoder.test.call", tag=1)
    def call(x):
        with profiling.annotate("litcoder.test.inner"):
            return x + 1

    assert call(1) == 2 and call(2) == 3
    record = profiling.spans()
    assert [(s["name"], s["parent"]) for s in record] == [
        ("litcoder.test.call", None), ("litcoder.test.inner", 0),
        ("litcoder.test.call", None), ("litcoder.test.inner", 2)]


def test_trace_clears_the_record_and_shows_the_spans(tmp_path):
    profiling.clear_spans()
    for i in range(2):
        with profiling.trace(str(tmp_path / f"t{i}")):
            with profiling.annotate("litcoder.test.outer"):
                with profiling.annotate("litcoder.test.inner"):
                    (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        assert [s["name"] for s in profiling.spans()] == [
            "litcoder.test.outer", "litcoder.test.inner"]
        (path,) = list((tmp_path / f"t{i}").glob("trace_*.json"))
        events = json.loads(path.read_text())["traceEvents"]
        names = {e.get("name") for e in events
                 if e.get("cat") == "user_annotation"}
        assert {"litcoder.test.outer", "litcoder.test.inner"} <= names
    profiling.clear_spans()
    assert profiling.spans() == []


def _direct_children(record, i):
    return [s["name"] for s in record if s["parent"] == i]


ROUTES = {
    # name: (train/test?, fit kwargs, solver_paths' alpha_search or mode)
    "train_test": (True, {}, "chol"),
    "chunked": (True, {"voxel_chunk_size": 16}, "chol"),
    "permutation": (True, {"significance": "permutation",
                           "n_permutations": 40}, "chol"),
    "dual": (True, {"method": "dual"}, "dual"),
    "sharded": (True, {"n_devices": 2}, "chol"),
    "full_cv_per_fold": (False, {"folding_type": "kfold_trimmed"},
                         "full_cv_per_fold"),
    "full_cv_fused": (False, {}, "full_cv_fused"),
}


def _fit(route, return_weights=True):
    tt, kw, _ = ROUTES[route]
    X, Y = _problem(D=400 if route == "dual" else 12)
    args = (X[:240], Y[:240], X[240:], Y[240:]) if tt else (X, Y)
    return fit_nested_cv(*args, device="cpu", return_weights=return_weights,
                         **kw)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_routes_give_their_spans(route):
    tt, kw, expect = ROUTES[route]
    (metrics, _, _), record = _under_profiler(lambda: _fit(route))
    paths = metrics["solver_paths"]
    assert expect in (paths["alpha_search"], paths["mode"])
    names = Counter(s["name"] for s in record)
    assert names["litcoder.fit"] == 1
    assert record[0]["name"] == "litcoder.fit"
    assert record[0]["parent"] is None
    assert all(s["parent"] is not None for s in record[1:])
    assert set(names) <= {"litcoder.fit", "litcoder.fit.gram",
                          "litcoder.fit.search", "litcoder.fit.lmax",
                          "litcoder.fit.refit", "litcoder.fit.host_stats",
                          "litcoder.fit.weights_to_host"}
    for name in ("litcoder.fit.gram", "litcoder.fit.search",
                 "litcoder.fit.lmax", "litcoder.fit.refit"):
        assert names[name] >= 1, name
    outer = 1 if tt else 5
    assert names["litcoder.fit.search"] == outer
    n_shards = 2 if route == "sharded" else 1
    assert names["litcoder.fit.refit"] == outer * n_shards
    # the stages are the root's children; gram and lmax nest in them
    top = set(_direct_children(record, 0))
    assert {"litcoder.fit.search", "litcoder.fit.refit"} <= top
    assert top <= {"litcoder.fit.search", "litcoder.fit.refit",
                   "litcoder.fit.host_stats", "litcoder.fit.gram"}
    for s in record:
        if s["name"] == "litcoder.fit.lmax":
            assert record[s["parent"]]["name"] == "litcoder.fit.search"
            assert set(s["counts"]) == {"steps", "fallback", "fused"}
            assert 1 <= s["counts"]["steps"] <= 64
            assert s["counts"]["fused"] == 0       # the CPU's plain step
        if s["name"] == "litcoder.fit.search":
            assert s["counts"]["folds"] == 5
            assert s["counts"]["alphas"] == 10
            chunks = {"chunked": 3, "sharded": 2}.get(route, 1)
            assert s["counts"]["voxel_chunks"] == chunks
        if s["name"] == "litcoder.fit.weights_to_host":
            assert record[s["parent"]]["name"] == "litcoder.fit.refit"
            assert s["counts"]["staged"] == 0      # one copy on the CPU
            assert s["counts"]["blocks"] == 1
    # each refit's voxel chunks (3 when chunked) reach the host
    assert names["litcoder.fit.weights_to_host"] == names[
        "litcoder.fit.refit"] * (3 if route == "chunked" else 1)
    assert names["litcoder.fit.host_stats"] >= 1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_is_bit_equal_with_the_profiler_on(route):
    off = _fit(route)
    on, record = _under_profiler(lambda: _fit(route))
    assert record
    assert off[0] == on[0]
    np.testing.assert_array_equal(off[1], on[1])
    np.testing.assert_array_equal(off[2], on[2])


def test_lmax_fallback_is_counted():
    """The kernel of tests/test_torch_ridge's missed Krylov breakdown: the
    whole tridiagonal's Ritz value is not usable, so the leading blocks are
    searched (fallback 1); a well-conditioned Gram needs no search."""
    from litcoder_core_torch.models import nested_cv as tcv
    from litcoder_core_torch.models.ridge import lmax_dense
    from tests.test_torch_ridge import _roadmap_c_problem

    X = torch.as_tensor(_roadmap_c_problem()[0])
    tr_idx, _ = tcv.create_folds(400, "chunked", 5, 20, seed=0)[0]
    Xtr = X[torch.as_tensor(tr_idx)]
    G = torch.as_tensor(_problem(T=200, D=10)[0])
    _, record = _under_profiler(lambda: (lmax_dense(Xtr @ Xtr.T),
                                         lmax_dense(G.T @ G)))
    assert [s["counts"] for s in record] == [
        {"steps": 64, "fallback": 1, "fused": 0},
        {"steps": 10, "fallback": 0, "fused": 0}]


def test_lm_extractor_spans_and_counts():
    from transformers import GPT2Config, GPT2Model

    from litcoder_core_torch.features.language_model import (
        LanguageModelFeatureExtractor,
    )
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    torch.manual_seed(0)
    model = GPT2Model(GPT2Config(vocab_size=600, n_positions=64, n_embd=16,
                                 n_layer=2, n_head=2))
    ex = LanguageModelFeatureExtractor({
        "model_name": "tiny", "model": model,
        "tokenizer": HashStubTokenizer(), "device": "cpu",
        "batch_size": 4, "pipeline_depth": 2})
    words = [f"w{i % 17}" for i in range(30)]
    windows = [" ".join(words[max(0, i - 5):i + 1]) for i in range(30)]
    # fullcontext growth (chains) and shuffled singles, and an empty text
    stimuli = windows + ["", "lonely", "w3 w1 w4", "w1 w5 w9 w2"]
    off = ex.extract_all_layers(stimuli)
    before = dict(ex.counts)
    on, record = _under_profiler(lambda: ex.extract_all_layers(stimuli))
    for layer in off:
        np.testing.assert_array_equal(off[layer], on[layer])
    delta = {k: ex.counts[k] - before[k] for k in before}
    by_name = {}
    for s in record:
        by_name.setdefault(s["name"], []).append(s)
    assert set(by_name) == {"litcoder.lm.tokenize", "litcoder.lm.dispatch",
                            "litcoder.lm.fetch_wait", "litcoder.lm.collect"}
    assert [s["parent"] for s in by_name["litcoder.lm.collect"]] == [None]
    (tok,) = by_name["litcoder.lm.tokenize"]
    assert tok["counts"] == {"windows": len(stimuli) - 1}
    dispatch = by_name["litcoder.lm.dispatch"]
    assert len(dispatch) == delta["chain_forwards"] + delta["single_forwards"]
    for key in ("windows", "real_tokens", "padded_tokens"):
        assert sum(s["counts"][key] for s in dispatch) == delta[key], key
    # one wait per batch, in a dispatch once the queue is full, else in
    # the final flush
    waits = by_name["litcoder.lm.fetch_wait"]
    assert len(waits) == len(dispatch)
    in_dispatch = [s for s in waits if s["parent"] is not None
                   and record[s["parent"]]["name"] == "litcoder.lm.dispatch"]
    assert 0 < len(in_dispatch) < len(waits)
    assert all(s["parent"] is None for s in waits if s not in in_dispatch)
    stages = ex.last_stage_seconds
    assert stages["tokenize_s"] == round(
        (tok["end_ns"] - tok["start_ns"]) / 1e9, 4)
    assert stages["fetch_wait_s"] == pytest.approx(
        sum((s["end_ns"] - s["start_ns"]) / 1e9 for s in waits), abs=2e-4)


def test_stage_timer_stages_are_spans(profiler):
    timer = profiling.StageTimer()
    with timer.stage("extract"):
        with profiling.annotate("litcoder.test.inside"):
            pass
    with timer.stage("fit_predict"):
        pass
    other = profiling.StageTimer(span_prefix="litcoder.banded")
    with other.stage("scan"):
        pass
    record = profiling.spans()
    assert [(s["name"], s["parent"]) for s in record] == [
        ("litcoder.train.extract", None), ("litcoder.test.inside", 0),
        ("litcoder.train.fit_predict", None), ("litcoder.banded.scan", None)]
    assert set(timer.totals()) == {"extract", "fit_predict"}


def test_trainer_stages_appear_as_train_spans(tmp_path):
    import litcoder_core_torch as T

    rng = np.random.default_rng(5)
    stories = []
    for i in range(3):
        n_trs, n_words = 80, 240
        tr_times = np.arange(n_trs) * 2.0 + 1.0
        data_times = np.sort(rng.uniform(0, n_trs * 2.0, n_words))
        split = np.clip((data_times // 2.0).astype(int), 0, n_trs - 1)
        rates = np.bincount(split, minlength=n_trs).astype(np.float32)
        stories.append(T.StoryData(
            name=f"s{i}", brain_data=rng.normal(size=(n_trs, 6))
            .astype(np.float32), stimuli=[""] * n_words,
            split_indices=split.tolist(), tr_times=tr_times,
            data_times=data_times, word_rates=rates,
            words=[f"w{j}" for j in range(n_words)]))
    trainer = T.AbstractTrainer(
        assembly=T.SimpleNeuroidAssembly(stories, validation_method="outer"),
        feature_extractors=[T.FeatureExtractorFactory.create_extractor(
            "wordrate", "wordrate", {})],
        downsampler=T.Downsampler(),
        model=T.NestedCVModel(seed=0, device="cpu"), fir_delays=[1, 2],
        trimming_config={"train_features_start": 0,
                         "train_features_end": None,
                         "train_targets_start": 0, "train_targets_end": None,
                         "test_features_start": 0, "test_features_end": None,
                         "test_targets_start": 0, "test_targets_end": None},
        use_train_test_split=True, dataset_type="lebel",
        logger_backend="none", results_dir=str(tmp_path), device="cpu")
    metrics, record = _under_profiler(
        lambda: trainer.train(chunk_length=10, n_inner_folds=3))
    roots = [s["name"] for s in record if s["parent"] is None]
    assert roots == ["litcoder.train." + name
                     for name in metrics["trainer_stage_seconds"]]
    fit_root = next(i for i, s in enumerate(record)
                    if s["name"] == "litcoder.fit")
    assert record[record[fit_root]["parent"]]["name"] == \
        "litcoder.train.fit_predict"
    saved = [s["name"] for s in record
             if s["parent"] is not None
             and record[s["parent"]]["name"] == "litcoder.train.log_and_save"]
    assert saved == ["litcoder.log.metrics", "litcoder.log.save"]

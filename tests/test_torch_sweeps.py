"""Port parity for the sweeps (litcoder_core_torch.sweeps against
litcoder_core_tpu.sweeps) on the CPU: the grid expansion, the summary
table with its JSON and CSV twin, a resumable grid of CLI runs on one
JAX-saved pickle (rows within the solver's bar: median r within 1e-3,
the same n_significant; a second call runs nothing) and a layer sweep of
a tiny GPT-2 over the all-layer activation cache."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import litcoder_core_torch as T
import litcoder_core_tpu as J
import litcoder_core_tpu.cli as jcli
from litcoder_core_torch import sweeps as tsw
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.utils.testing import HashStubTokenizer
from litcoder_core_tpu import sweeps as jsw
from litcoder_core_tpu.assembly.assembly_loader import save_assembly
from tests.test_torch_language_model import (  # noqa: F401 (a fixture)
    _fullcontext,
    gpt2_pair,
)
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

LEBEL_TRIM = dict(jcli.DATASET_CONFIGS["lebel"]["trimming"])


def _lebel_stories(prefix, n, **kw):
    return [dataclasses.replace(sd, brain_data=sd.brain_data[10:-5], **kw)
            for sd in (_make_story(f"{prefix}{i}", n_trs=120)
                       for i in range(n))]


@pytest.fixture(scope="module")
def asm_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sweep_data") / "asm.pkl")
    save_assembly(J.SimpleNeuroidAssembly(_lebel_stories("sw", 4), "outer"),
                  path)
    return path


def _base(asm_path, root):
    config = vars(jcli.parse_args([
        "--dataset_type", "lebel", "--assembly_path", asm_path,
        "--modality", "wordrate", "--model_name", "wordrate",
        "--ndelays", "4", "--lookback", "256", "--cache_dir",
        str(root / "cache"), "--results_dir", str(root / "results"),
        "--logger_backend", "none", "--chunk_length", "10",
        "--n_inner_folds", "3", "--subject", "S1"]))
    config.update(modalities=["wordrate"], model_names=["wordrate"])
    return config


@pytest.mark.parametrize("axes", [
    dict(subject=["A", "B"], layer_idx=[1, 2, 3]),
    dict(modalities=[["wordrate"], ["wordrate", "embeddings"]], seed=[0]),
    dict(layer_idx=[9]),
], ids=["subject_layer", "modalities", "one_axis"])
def test_expand_grid_matches_jax(axes):
    base = {"dataset_type": "lebel", "seed": 0}
    got = tsw.expand_grid(base, **axes)
    assert got == jsw.expand_grid(base, **axes)
    assert base == {"dataset_type": "lebel", "seed": 0}
    for pkg in (tsw, jsw):
        with pytest.raises(ValueError, match="expand_grid: no axes given"):
            pkg.expand_grid(base)


ROWS = [
    {"config": "layer_idx-3_subject-A", "median_score": 0.123456,
     "n_significant": 7, "error": None, "subject": "A", "layer_idx": 3,
     "run_name": "sweep_layer_idx-3_subject-A"},
    {"config": "lebel/B", "median_score": float("nan"), "n_significant": 0,
     "error": "boom: a long error message"},
]


@pytest.mark.parametrize("rows", [ROWS, ROWS[1:], []],
                         ids=["two", "error_only", "empty"])
def test_summarize_sweep_matches_jax(rows, tmp_path):
    got = tsw.summarize_sweep(rows, path=str(tmp_path / "t.json"))
    want = jsw.summarize_sweep(rows, path=str(tmp_path / "j.json"))
    assert got == want
    if rows:
        assert (tmp_path / "t.json").read_text() == \
            (tmp_path / "j.json").read_text()
        assert (tmp_path / "t.csv").read_text() == \
            (tmp_path / "j.csv").read_text()


def test_grid_sweep_matches_jax_and_resumes(asm_path, tmp_path):
    rows = {}
    for name, pkg, extra in (("jax", jsw, {}),
                             ("torch", tsw, {"device": "cpu"})):
        root = tmp_path / name
        base = dict(_base(asm_path, root), **extra)
        kw = dict(checkpoint_dir=str(root / "ckpt"),
                  summary_path=str(root / "summary.json"),
                  subject=["S1", "S2"], seed=[0, 1])
        rows[name] = pkg.run_grid_sweep(base, **kw)
        runs = sorted((root / "results").glob("run_*"))
        assert len(runs) == 4
        # A second call hits every checkpoint: no new run, the same rows.
        assert pkg.run_grid_sweep(base, **kw) == rows[name]
        assert sorted((root / "results").glob("run_*")) == runs
        assert len(list((root / "ckpt").glob("*.json"))) == 4
        recs = json.loads((root / "summary.json").read_text())
        assert recs == rows[name]
        assert len((root / "summary.csv").read_text().splitlines()) == 5
    for got, want in zip(rows["torch"], rows["jax"]):
        assert got["error"] is None and want["error"] is None
        assert abs(got["median_score"] - want["median_score"]) <= 1e-3
        assert got["n_significant"] == want["n_significant"]
        assert {k: v for k, v in got.items() if k != "median_score"} == \
            {k: v for k, v in want.items() if k != "median_score"}


def test_subject_sweep_records_failures(asm_path, tmp_path):
    """A bad config becomes a row with its error; the sweep goes on."""
    bad = dict(_base(asm_path, tmp_path), sweep_label="bad",
               model_names=["a", "b"])
    good = dict(_base(asm_path, tmp_path), device="cpu")
    rows = tsw.run_subject_sweep([dict(bad, device="cpu"), good],
                                 checkpoint_dir=str(tmp_path / "ckpt"))
    want = jsw.run_subject_sweep([bad], checkpoint_dir=None)
    assert rows[0] == dict(want[0], median_score=rows[0]["median_score"])
    assert np.isnan(rows[0]["median_score"]) and "must match" in \
        rows[0]["error"]
    assert rows[1]["error"] is None
    assert len(list((tmp_path / "ckpt").glob("*.json"))) == 1


def test_layer_sweep_matches_jax(gpt2_pair, tmp_path):  # noqa: F811
    """A tiny GPT-2 over fullcontext windows: the first layer fills the
    all-layer activation cache, the others run no forward."""
    fm, tm = gpt2_pair
    stories = [dataclasses.replace(sd, stimuli=_fullcontext(sd.words, 8))
               for sd in _lebel_stories("swlm", 3)]
    jasm = J.SimpleNeuroidAssembly(stories, validation_method="outer")
    extractors = {
        J: J.FeatureExtractorFactory.create_extractor(
            "language_model", "tiny-gpt2",
            {"model": fm, "tokenizer": HashStubTokenizer(),
             "backend": "flax", "batch_size": 64},
            cache_dir=str(tmp_path / "jax_cache")),
        T: T.FeatureExtractorFactory.create_extractor(
            "language_model", "tiny-gpt2",
            {"model": tm, "tokenizer": HashStubTokenizer(), "device": "cpu",
             "batch_size": 64},
            cache_dir=str(tmp_path / "torch_cache")),
    }
    asms = {J: jasm, T: assembly_from_reference(jasm)}
    forwards = []

    def make_trainer(pkg):
        def make(layer):
            ex = extractors[pkg]
            if pkg is T:
                forwards.append(ex.counts["chain_forwards"]
                                + ex.counts["single_forwards"])
            kw = dict(device="cpu") if pkg is T else {}
            return pkg.AbstractTrainer(
                assembly=asms[pkg], feature_extractors=[ex],
                downsampler=pkg.Downsampler(),
                model=pkg.NestedCVModel(seed=0, **kw),
                fir_delays=[1, 2, 3, 4], trimming_config=dict(LEBEL_TRIM),
                use_train_test_split=True, layer_idx=layer, lookback=8,
                dataset_type="lebel", logger_backend="none",
                results_dir=str(tmp_path / f"results_{pkg.__name__}"), **kw)
        return make

    fit = dict(chunk_length=10, n_inner_folds=3)
    got = tsw.run_layer_sweep(make_trainer(T), [0, 1, 2], fit)
    want = jsw.run_layer_sweep(make_trainer(J), [0, 1, 2], fit)
    assert forwards[0] == 0 and forwards[1] > 0
    assert forwards[1] == forwards[2]   # layers 1 and 2 hit the cache
    assert [r["layer"] for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["median_score"] - w["median_score"]) <= 1e-3
        assert abs(g["mean_score"] - w["mean_score"]) <= 1e-3
        assert g["n_significant"] == w["n_significant"]
    for pkg in (tsw, jsw):
        with pytest.raises(ValueError, match="`layers` is empty"):
            pkg.run_layer_sweep(make_trainer(T), [])

"""Port parity for the trainer's per-space mode (concat_features=False) and
its response prefetch: litcoder_core_torch.AbstractTrainer on the CPU
against the JAX AbstractTrainer, on the synthetic LeBel-layout stories of
tests/test_torch_trainer.py (4 stories of 120 TRs, word rate and 6-wide
static embeddings, FIR delays 1-4, V=12).

Per space, the fused path's and the two-stage path's delayed features and
the structured train/test spaces must match JAX's (within 1e-4, the
kernel's bar); train() with BandedRidgeModel (fused path) and
StackedRidgeModel (two-stage path) must select JAX's alphas (and gammas)
with correlations within 2e-4 and the same solver_paths. Full-CV
structuring refuses per-space features, as JAX's does; with the prefetch
on and off the results are bit-equal."""

import dataclasses

import numpy as np
import pytest
import torch

import litcoder_core_tpu as J
import litcoder_core_torch as T
from litcoder_core_tpu.models.banded import BandedRidgeModel as JaxBanded
from litcoder_core_tpu.models.stacking import StackedRidgeModel as JaxStacked
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.models import BandedRidgeModel, StackedRidgeModel
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

LEBEL_TRIM = {
    "train_features_start": 10, "train_features_end": -5,
    "train_targets_start": 0, "train_targets_end": None,
    "test_features_start": 50, "test_features_end": -5,
    "test_targets_start": 40, "test_targets_end": None,
}
LANCZOS = {"method": "lanczos", "window": 3, "cutoff_mult": 1.0}
FIT = dict(chunk_length=10, n_inner_folds=3,
           alphas=np.logspace(-1, 4, 6))


@pytest.fixture(scope="module")
def jax_assembly():
    stories = []
    for i in range(4):
        sd = _make_story(f"lebel{i}", n_trs=120)
        stories.append(dataclasses.replace(sd,
                                           brain_data=sd.brain_data[10:-5]))
    return J.SimpleNeuroidAssembly(stories, validation_method="outer")


@pytest.fixture(scope="module")
def kv_path(jax_assembly, tmp_path_factory):
    from litcoder_core_tpu.features.embeddings import (
        SimpleKeyedVectors as JaxKV,
    )

    n = max(len(sd.words) for sd in jax_assembly.story_data.values())
    vecs = np.random.default_rng(11).normal(size=(n, 6)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("kv") / "vecs.kv")
    JaxKV([f"w{i}" for i in range(n)], vecs).save_kv(path)
    return path


def _trainer(pkg, assembly, kv_path, results_dir, model, **overrides):
    """The same per-space configuration for either package."""
    cfg = {"vector_path": kv_path, "lowercase": False}
    kwargs = dict(
        assembly=assembly,
        feature_extractors=[
            pkg.FeatureExtractorFactory.create_extractor(
                "wordrate", "wordrate", {}),
            pkg.FeatureExtractorFactory.create_extractor(
                "embeddings", "vecs", dict(cfg)),
        ],
        downsampler=pkg.Downsampler(), model=model, fir_delays=[1, 2, 3, 4],
        trimming_config=dict(LEBEL_TRIM), use_train_test_split=True,
        dataset_type="lebel", logger_backend="none",
        results_dir=str(results_dir), downsample_config=dict(LANCZOS),
        concat_features=False,
    )
    if pkg is T:
        kwargs["device"] = "cpu"
    kwargs.update(overrides)
    return pkg.AbstractTrainer(**kwargs)


@pytest.fixture(scope="module")
def trainers(jax_assembly, kv_path, tmp_path_factory):
    """{path: (jax trainer, port trainer)} for the fused and two-stage
    paths (banded and stacked models)."""
    out = tmp_path_factory.mktemp("spaces")
    asm = assembly_from_reference(jax_assembly)
    models = {"fused": (JaxBanded(seed=0, n_gammas=4),
                        BandedRidgeModel(seed=0, n_gammas=4, device="cpu")),
              "two_stage": (JaxStacked(seed=0),
                            StackedRidgeModel(seed=0, device="cpu"))}
    return {
        path: (_trainer(J, jax_assembly, kv_path, out / f"j{path}", jm,
                        fused_downsample_fir=path == "fused"),
               _trainer(T, asm, kv_path, out / f"t{path}", tm,
                        fused_downsample_fir=path == "fused"))
        for path, (jm, tm) in models.items()
    }


def _delayed(trainer, path):
    if path == "fused":
        return trainer.extract_and_delay_features_fused()
    return trainer.apply_fir_delays(trainer.extract_and_downsample_features())


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_per_space_features_match_jax(trainers, path):
    jt, tt = trainers[path]
    want, got = _delayed(jt, path), _delayed(tt, path)
    assert set(got) == set(want)
    for story in want:
        assert isinstance(got[story], list) and len(got[story]) == 2
        for g, w in zip(got[story], want[story]):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    # Word rate: 1 x 4 delays; embeddings: 6 x 4, not interleaved.
    assert [tuple(f.shape) for f in got[next(iter(want))]] == [(120, 4),
                                                                (120, 24)]


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_per_space_structuring_matches_jax(trainers, path):
    jt, tt = trainers[path]
    want = jt.structure_data(_delayed(jt, path))
    got = tt.structure_data(_delayed(tt, path))
    for key in ("Rstim", "Pstim"):
        assert len(got[key]) == len(want[key]) == 2
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    for key in ("Rresp", "Presp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def runs(trainers):
    return {path: (jt.train(**FIT), tt.train(**FIT))
            for path, (jt, tt) in trainers.items()}


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_train_matches_jax(runs, path):
    mj, mt = runs[path]
    assert mt["solver_paths"] == mj["solver_paths"]
    assert mt["best_alphas"] == mj["best_alphas"]
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-4)
    assert set(mt) == set(mj)
    if path == "fused":
        assert mt["best_gammas"] == mj["best_gammas"]
        assert mt["solver_paths"] == {"banded_scan": "chol",
                                      "banded_refit": "grouped_chol"}
    else:
        np.testing.assert_allclose(mt["stack_weights_mean"],
                                   mj["stack_weights_mean"], atol=1e-4)
        assert mt["solver_paths"]["oof_refit"] == "grouped_chol"
    assert mt["median_score"] > 0.25   # the word-rate signal is recovered


def test_full_cv_refuses_per_space_features(trainers):
    jt, tt = trainers["fused"]
    for trainer in (jt, tt):
        trainer.use_train_test_split = False
        try:
            with pytest.raises(ValueError, match="requires "
                               "use_train_test_split=True"):
                trainer.structure_data(_delayed(trainer, "fused"))
        finally:
            trainer.use_train_test_split = True


def test_prefetch_on_and_off_are_bit_equal(jax_assembly, kv_path, tmp_path,
                                           monkeypatch, caplog):
    asm = assembly_from_reference(jax_assembly)

    def fit():
        trainer = _trainer(T, asm, kv_path, tmp_path,
                           BandedRidgeModel(seed=0, n_gammas=2,
                                            device="cpu"))
        return trainer.train(**FIT)

    with_prefetch = fit()
    orig = T.AbstractTrainer._prefetch_brain_data
    monkeypatch.setattr(T.AbstractTrainer, "_prefetch_brain_data",
                        lambda self: orig(self, budget_bytes=0))
    with caplog.at_level("INFO", logger="litcoder_core_torch.trainer"):
        without = fit()
    assert "brain-data prefetch skipped" in caplog.text
    for key in ("correlations", "best_alphas", "best_gammas", "p_values"):
        assert with_prefetch[key] == without[key]


def test_prefetched_responses_equal_the_assembly(jax_assembly, kv_path,
                                                 tmp_path):
    asm = assembly_from_reference(jax_assembly)
    trainer = _trainer(T, asm, kv_path, tmp_path, None)
    copies, event = trainer._prefetch_brain_data()
    assert event is None   # no side stream on the CPU
    for story, arr in zip(asm.stories, asm.get_brain_data()):
        assert copies[story].dtype == torch.float32
        np.testing.assert_array_equal(copies[story].numpy(), arr)

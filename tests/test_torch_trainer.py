"""Port parity for the trainer slice: litcoder_core_torch.AbstractTrainer on
the CPU against the JAX AbstractTrainer, on the synthetic stories of
tests/test_trainer_e2e.py cut to the LeBel layout (brain data of n_TR - 15
rows, the trimming of examples/train_simple.py), with wordrate, static
embeddings and a tiny GPT-2 as features (the JAX extractor on its Flax
model, the port's on the torch twin with the same weights). Also the state
carried between the packages: assemblies, .kv bundles and saved runs;
the loggers: both trainers record the same names, by default in a
TensorBoard run under results_dir/runs/."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import litcoder_core_tpu as J
import litcoder_core_torch as T
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.features.embeddings import SimpleKeyedVectors
from litcoder_core_torch.utils.saver import ModelSaver
from litcoder_core_torch.utils.testing import HashStubTokenizer
from tests.test_torch_language_model import (  # noqa: F401 (a fixture)
    _fullcontext,
    gpt2_pair,
)
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

LEBEL_TRIM = {
    "train_features_start": 10, "train_features_end": -5,
    "train_targets_start": 0, "train_targets_end": None,
    "test_features_start": 50, "test_features_end": -5,
    "test_targets_start": 40, "test_targets_end": None,
}
LANCZOS = {"method": "lanczos", "window": 3, "cutoff_mult": 1.0}
FIT = dict(chunk_length=10, n_inner_folds=3)


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


def _trainer(pkg, assembly, kv_path, results_dir, **overrides):
    """The same configuration for either package (`pkg` is J or T)."""
    cfg = {"vector_path": kv_path, "lowercase": False}
    extractors = None if kv_path is None else [
        pkg.FeatureExtractorFactory.create_extractor("wordrate", "wordrate",
                                                     {}),
        pkg.FeatureExtractorFactory.create_extractor("embeddings", "vecs",
                                                     dict(cfg)),
    ]
    kwargs = dict(
        assembly=assembly, feature_extractors=extractors,
        downsampler=pkg.Downsampler(),
        model=(pkg.NestedCVModel(seed=0, device="cpu") if pkg is T
               else pkg.NestedCVModel(seed=0)),
        fir_delays=[1, 2, 3, 4], trimming_config=dict(LEBEL_TRIM),
        use_train_test_split=True, dataset_type="lebel",
        logger_backend="none", results_dir=str(results_dir),
        downsample_config=dict(LANCZOS),
    )
    if pkg is T:
        kwargs["device"] = "cpu"
    kwargs.update(overrides)
    if kwargs["logger_backend"] is None:  # the trainer's default
        del kwargs["logger_backend"]
    return pkg.AbstractTrainer(**kwargs)


@pytest.fixture(scope="module")
def runs(jax_assembly, kv_path, tmp_path_factory):
    """(jax trainer, jax metrics, port trainer, port metrics)."""
    out = tmp_path_factory.mktemp("runs")
    jt = _trainer(J, jax_assembly, kv_path, out / "jax")
    tt = _trainer(T, assembly_from_reference(jax_assembly), kv_path,
                  out / "torch")
    return jt, jt.train(**FIT), tt, tt.train(**FIT)


def test_assembly_from_reference(jax_assembly):
    asm = assembly_from_reference(jax_assembly)
    assert isinstance(asm, T.SimpleNeuroidAssembly)
    assert asm.stories == jax_assembly.stories
    assert asm.get_validation_method() == "outer"
    np.testing.assert_array_equal(asm.data, jax_assembly.data)
    for got, want in zip(asm.get_data_times(), jax_assembly.get_data_times()):
        np.testing.assert_array_equal(got, want)
    assert asm.get_words() == jax_assembly.get_words()


def test_fused_features_match_jax(runs):
    jt, _, tt, _ = runs
    want = jt.extract_and_delay_features_fused()
    got = tt.extract_and_delay_features_fused()
    assert set(got) == set(want)
    for story in want:
        assert tuple(got[story].shape) == want[story].shape == (120, 28)
        np.testing.assert_allclose(got[story].numpy(),
                                   np.asarray(want[story]), atol=1e-4)


def test_train_test_split_matches_jax(runs):
    _, mj, _, mt = runs
    assert mt["best_alphas"] == mj["best_alphas"]
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert set(mt) == set(mj)
    assert mt["solver_paths"] == mj["solver_paths"] == {
        "mode": "train_test", "alpha_search": "chol", "fast_scan": "off"}
    assert set(mt["trainer_stage_seconds"]) == {
        "extract_downsample_fir_fused", "structure_data", "fit_predict",
        "log_and_save"}
    assert mt["median_score"] > 0.25  # the word-rate signal is recovered


def test_fused_matches_two_stage_in_the_port(jax_assembly, kv_path,
                                             tmp_path):
    asm = assembly_from_reference(jax_assembly)
    fused = _trainer(T, asm, kv_path, tmp_path, fused_downsample_fir=True)
    two = _trainer(T, asm, kv_path, tmp_path, fused_downsample_fir=False)
    assert fused._fused_eligible() and not two._fused_eligible()
    want = two.apply_fir_delays(two.extract_and_downsample_features())
    got = fused.extract_and_delay_features_fused()
    for story in want:
        np.testing.assert_allclose(got[story].numpy(), want[story].numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("config,delays", [
    ({"method": "lanczos", "window": 3, "cutoff_mult": 1.0,
      "rectify": True}, [1, 2]),
    ({"method": "lanczos", "window": 3}, [1, 2]),
    (dict(LANCZOS), [0, 1]),
])
def test_fused_eligibility(jax_assembly, kv_path, tmp_path, config, delays):
    asm = assembly_from_reference(jax_assembly)
    auto = _trainer(T, asm, kv_path, tmp_path, downsample_config=config,
                    fir_delays=delays)
    assert not auto._fused_eligible()
    forced = _trainer(T, asm, kv_path, tmp_path, downsample_config=config,
                      fir_delays=delays, fused_downsample_fir=True)
    with pytest.raises(ValueError, match="fused_downsample_fir"):
        forced._fused_eligible()


def test_concatenated_structuring_matches_jax(jax_assembly, kv_path,
                                              tmp_path):
    trim = {"features_start": 3, "features_end": -2, "targets_start": 3,
            "targets_end": -2}
    jt = _trainer(J, jax_assembly, kv_path, tmp_path / "j",
                  use_train_test_split=False, trimming_config=trim,
                  device_resident=False)
    tt = _trainer(T, assembly_from_reference(jax_assembly), kv_path,
                  tmp_path / "t", use_train_test_split=False,
                  trimming_config=trim)
    want = jt.structure_data(jt.extract_and_delay_features_fused())
    got = tt.structure_data(tt.extract_and_delay_features_fused())
    for key in ("X", "Y"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4)


def test_kv_bundles_cross_packages(kv_path, tmp_path):
    from litcoder_core_tpu.features.embeddings import (
        SimpleKeyedVectors as JaxKV,
    )

    kv = SimpleKeyedVectors.load_kv(kv_path)  # written by the JAX package
    jkv = JaxKV.load_kv(kv_path)
    assert kv.index_to_key == jkv.index_to_key
    np.testing.assert_array_equal(kv.vectors, jkv.vectors)
    path = str(tmp_path / "port.kv")
    kv.save_kv(path)
    back = JaxKV.load_kv(path)
    assert back.index_to_key == kv.index_to_key
    np.testing.assert_array_equal(back.vectors, kv.vectors)


def test_saved_runs_cross_packages(runs, tmp_path):
    from litcoder_core_tpu.utils.saver import ModelSaver as JaxSaver

    _, _, tt, mt = runs
    (run_dir,) = list(tt.model_saver.base_dir.glob("run_*"))
    w, alphas, hyper, metrics = JaxSaver(str(tmp_path)).load_encoding_model(
        run_dir)
    assert w is None and hyper["dataset_type"] == "lebel"
    np.testing.assert_array_equal(alphas, mt["best_alphas"])
    assert metrics["correlations"] == mt["correlations"]

    weights = np.arange(12, dtype=np.float32).reshape(3, 4)
    jdir = JaxSaver(str(tmp_path / "j")).save_encoding_model(
        weights, np.ones(4), {"a": 1}, {"median_score": 0.5},
        save_weights=True)
    w, alphas, hyper, metrics = ModelSaver(str(tmp_path)).load_encoding_model(
        jdir)
    np.testing.assert_array_equal(w, weights)
    assert hyper == {"a": 1} and metrics == {"median_score": 0.5}
    tdir = ModelSaver(str(tmp_path / "t")).save_encoding_model(
        torch.as_tensor(weights), torch.ones(4), {"a": 1}, {"m": 1},
        save_weights=True)
    w, _, _, _ = JaxSaver(str(tmp_path)).load_encoding_model(tdir)
    np.testing.assert_array_equal(w, weights)


def test_unported_trainer_options_raise(jax_assembly, kv_path, tmp_path):
    asm = assembly_from_reference(jax_assembly)
    with pytest.raises(ValueError, match="Unsupported logger_backend"):
        _trainer(T, asm, kv_path, tmp_path, logger_backend="mlflow")
    out = T.Downsampler().downsample(np.zeros((3, 1)), np.arange(3.0),
                                     np.arange(2.0), method="average",
                                     split_indices=[0, 0, 1], device="cpu")
    assert tuple(out.shape) == (2, 1)
    # A speech mesh is ported: the factory passes it on, and the
    # extractor refuses anything but a Mesh before it loads a model.
    with pytest.raises(TypeError, match="Mesh"):
        T.FeatureExtractorFactory.create_extractor(
            "speech", "m", {"chunk_size": 0.1, "context_size": 16.0,
                            "mesh": object(), "device": "cpu"})
    assert (T.FeatureExtractorFactory.get_supported_modalities()
            == J.FeatureExtractorFactory.get_supported_modalities()
            == ["language_model", "speech", "wordrate", "embeddings"])


# ---- loggers -----------------------------------------------------------


def test_null_logger_names_match_jax(runs):
    """The 'none' backend still records the brain plots' names: two images
    and two histograms, besides the same scalars."""
    jt, _, tt, _ = runs
    port, ref = tt.experiment_logger, jt.experiment_logger
    assert port.images == ref.images == [
        "correlation_histogram_all", "correlation_histogram_significant"]
    assert port.histograms == ref.histograms == [
        "correlation_histogram_data_all",
        "correlation_histogram_data_significant"]
    assert set(port.scalars) == set(ref.scalars)
    assert {"median_correlation", "n_significant_voxels",
            "stage_seconds/fit_predict"} <= set(port.scalars)


def _event_tags(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tags = EventAccumulator(str(run_dir)).Reload().Tags()
    return {kind: sorted(tags[kind])
            for kind in ("scalars", "images", "histograms")}


def test_default_backend_writes_tensorboard_runs(jax_assembly, kv_path,
                                                 tmp_path):
    """Without logger_backend both trainers log to TensorBoard in
    results_dir/runs/<run_name>, with the same tags."""
    from litcoder_core_torch.plotting import TensorBoardLogger
    from litcoder_core_tpu.plotting import TensorBoardLogger as JaxTB

    tags = {}
    for pkg, cls in ((J, JaxTB), (T, TensorBoardLogger)):
        results = tmp_path / pkg.__name__
        asm = (jax_assembly if pkg is J
               else assembly_from_reference(jax_assembly))
        trainer = _trainer(pkg, asm, kv_path, results, logger_backend=None)
        assert isinstance(trainer.experiment_logger, cls)
        trainer.train(**FIT)
        trainer.experiment_logger.close()
        (run_dir,) = list((results / "runs").iterdir())
        assert run_dir.name.startswith("abstract-trainer-")
        tags[pkg] = _event_tags(run_dir)
    assert tags[T] == tags[J]
    assert tags[T]["images"] == ["correlation_histogram_all",
                                 "correlation_histogram_significant"]
    assert tags[T]["histograms"] == ["correlation_histogram_data_all",
                                     "correlation_histogram_data_significant"]
    assert "median_correlation" in tags[T]["scalars"]
    named = _trainer(T, assembly_from_reference(jax_assembly), kv_path,
                     tmp_path / "named", logger_backend="tensorboard",
                     run_name="mine")
    named.experiment_logger.close()
    assert (tmp_path / "named" / "runs" / "mine").is_dir()


def test_wandb_backend_with_a_stub(jax_assembly, kv_path, tmp_path,
                                   monkeypatch):
    import sys
    import types

    from litcoder_core_torch.plotting import WandBLogger

    wandb = types.ModuleType("wandb")
    wandb.inits, wandb.logged = [], []
    wandb.init = lambda **kw: wandb.inits.append(kw)
    wandb.log = wandb.logged.append
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    trainer = _trainer(T, assembly_from_reference(jax_assembly), kv_path,
                       tmp_path, logger_backend="wandb",
                       wandb_project_name="proj", run_name="r1")
    assert wandb.inits == [{"project": "proj", "name": "r1"}]
    assert isinstance(trainer.experiment_logger, WandBLogger)
    assert trainer.brain_plotter.logger is trainer.experiment_logger


# ---- the language-model extractor through both trainers -----------------

LM_STORIES = 3


@pytest.fixture(scope="module")
def lm_runs(gpt2_pair, tmp_path_factory):
    """({mode: (JAX metrics, port metrics)}, the port's extractor) for a
    tiny GPT-2 on three stories whose stimuli are fullcontext windows of 8
    words, in both structuring modes; the second mode is served from each
    package's activation cache."""
    fm, tm = gpt2_pair
    stories = []
    for i in range(LM_STORIES):
        sd = _make_story(f"lm{i}", n_trs=120)
        stories.append(dataclasses.replace(sd,
                                           stimuli=_fullcontext(sd.words, 8)))
    lebel = [dataclasses.replace(sd, brain_data=sd.brain_data[10:-5])
             for sd in stories]
    out = tmp_path_factory.mktemp("lm")
    config = {"tokenizer": HashStubTokenizer(), "batch_size": 64}
    extractors = {
        J: J.FeatureExtractorFactory.create_extractor(
            "language_model", "tiny-gpt2",
            dict(config, model=fm, backend="flax"),
            cache_dir=str(out / "jax_cache")),
        T: T.FeatureExtractorFactory.create_extractor(
            "language_model", "tiny-gpt2",
            dict(config, model=tm, device="cpu"),
            cache_dir=str(out / "torch_cache")),
    }
    modes = {
        "train_test": (lebel, dict(LEBEL_TRIM), True, FIT),
        "full_cv": (stories, {"features_start": 3, "features_end": -2,
                              "targets_start": 3, "targets_end": -2}, False,
                    dict(chunk_length=10, n_outer_folds=3, n_inner_folds=3)),
    }
    results = {}
    for mode, (story_data, trim, split, fit) in modes.items():
        jasm = J.SimpleNeuroidAssembly(story_data, validation_method="outer")
        got = {}
        for pkg, asm in ((J, jasm), (T, assembly_from_reference(jasm))):
            trainer = _trainer(pkg, asm, None, out / f"{mode}_{pkg.__name__}",
                               feature_extractors=[extractors[pkg]],
                               trimming_config=trim,
                               use_train_test_split=split, layer_idx=1,
                               lookback=8)
            got[pkg] = trainer.train(**fit)
        results[mode] = got[J], got[T]
    return results, extractors[T], stories


@pytest.mark.parametrize("mode", ["train_test", "full_cv"])
def test_lm_trainer_matches_jax(lm_runs, mode):
    mj, mt = lm_runs[0][mode]
    np.testing.assert_array_equal(np.asarray(mt["best_alphas"]),
                                  np.asarray(mj["best_alphas"]))
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert mt["solver_paths"] == mj["solver_paths"]
    assert set(mt) == set(mj)
    assert set(mt["trainer_stage_seconds"]) == {
        "extract_downsample_fir_fused", "structure_data", "fit_predict",
        "log_and_save"}


def test_lm_trainer_extracts_once_and_caches(lm_runs):
    """Each story's windows are extracted once (chains included) and cached;
    the second mode is served from the cache."""
    _, ex, stories = lm_runs
    assert ex.counts["windows"] == sum(
        sum(1 for s in sd.stimuli if s) for sd in stories)
    assert ex.counts["chain_forwards"] > 0
    assert ex.counts["single_forwards"] > 0
    assert len(list(Path(ex.cache_dir).glob("*.npz"))) == LM_STORIES


@pytest.mark.parametrize("oov", ["copy_prev", "zero", "skip", "error"])
def test_embedding_oov_policies_match_jax(kv_path, oov):
    from litcoder_core_tpu.features.embeddings import (
        StaticEmbeddingFeatureExtractor as JaxEmb,
    )
    from litcoder_core_torch.features.embeddings import (
        StaticEmbeddingFeatureExtractor,
    )

    cfg = {"vector_path": kv_path, "oov_handling": oov,
           "l2_normalize_tokens": True}
    tokens = ["nope", "W3", "w1", "zzz", "w2", 7]
    port, ref = StaticEmbeddingFeatureExtractor(dict(cfg)), JaxEmb(dict(cfg))
    if oov == "error":
        with pytest.raises(KeyError):
            port.extract_features(tokens)
        return
    np.testing.assert_array_equal(port.extract_features(tokens),
                                  ref.extract_features(tokens))
    np.testing.assert_array_equal(port.extract_features("W1 w2, x w3"),
                                  ref.extract_features("W1 w2, x w3"))


# ---- speech (features, times) tuples through both trainers ---------------

SPEECH_TRS, SPEECH_SR = 120, 4000
SPEECH_CONFIG = dict(chunk_size=1.0, context_size=1.0,
                     target_sample_rate=SPEECH_SR, layer=1, pool="last",
                     batch_size=32)


@pytest.fixture(scope="module")
def speech_runs(tmp_path_factory):
    """({mode: (JAX metrics, port metrics)}, port extractor, stories) for a
    tiny Wav2Vec2 of width 16 (group norm, random init under
    torch.manual_seed(0)): the JAX extractor's backend='torch' path and the
    port's extractor on the same module, over three stories of 240 s of
    seeded 4 kHz audio, windows of 1 s every 1 s. The responses (12
    voxels) carry a signal of the JAX extractor's layer-1 features,
    Lanczos-downsampled and delayed. 'fused' is the train/test split
    through the fused Lanczos+FIR stage, 'two_stage' the full-CV
    concatenation through the Downsampler, served from each package's
    speech cache. The shapes are those of lm_runs, whose JAX programs are
    then already compiled."""
    from scipy.io import wavfile
    from transformers import (
        Wav2Vec2Config,
        Wav2Vec2FeatureExtractor,
        Wav2Vec2Model,
    )

    from litcoder_core_torch.ops.lanczos_fir import lanczos_fir_reference
    from tests.test_torch_speech import SMALL, OneStory

    torch.manual_seed(0)
    model = Wav2Vec2Model(Wav2Vec2Config(
        **dict(SMALL, hidden_size=16), num_conv_pos_embeddings=12,
        do_stable_layer_norm=False, feat_extract_norm="group")).eval()
    config = dict(SPEECH_CONFIG, model=model,
                  feature_extractor=Wav2Vec2FeatureExtractor(
                      sampling_rate=SPEECH_SR))
    out = tmp_path_factory.mktemp("speech")
    extractors = {
        J: J.FeatureExtractorFactory.create_extractor(
            "speech", "tiny-w2v2", dict(config, backend="torch"),
            cache_dir=str(out / "jax_cache")),
        T: T.FeatureExtractorFactory.create_extractor(
            "speech", "tiny-w2v2", dict(config, device="cpu"),
            cache_dir=str(out / "torch_cache")),
    }
    rng = np.random.default_rng(17)
    mix = rng.standard_normal((4 * 16, 12)).astype(np.float32) / 8
    stories = []
    for i in range(LM_STORIES):
        sd = _make_story(f"speech{i}", n_trs=SPEECH_TRS)
        path = str(out / f"{sd.name}.wav")
        n = int(SPEECH_TRS * 2.0 * SPEECH_SR)
        wavfile.write(path, SPEECH_SR,
                      (0.1 * rng.standard_normal(n)).astype(np.float32))
        feats, times = J.FeatureExtractorFactory._extract_speech_features(
            extractors[J], OneStory(path), sd.name, 0, 1, "lebel")
        low = lanczos_fir_reference(
            torch.as_tensor(feats), torch.as_tensor(times, dtype=torch.float32),
            torch.as_tensor(sd.tr_times, dtype=torch.float32)).numpy()
        signal = (low - low.mean(0)) / low.std(0).clip(1e-6) @ mix
        brain = signal + rng.standard_normal(signal.shape).astype(np.float32)
        stories.append(dataclasses.replace(
            sd, brain_data=brain.astype(np.float32), audio_path=path))
    lebel = [dataclasses.replace(sd, brain_data=sd.brain_data[10:-5])
             for sd in stories]
    modes = {
        "fused": (lebel, dict(LEBEL_TRIM), True, True, FIT),
        "two_stage": (stories, {"features_start": 3, "features_end": -2,
                                "targets_start": 3, "targets_end": -2},
                      False, False,
                      dict(chunk_length=10, n_outer_folds=3,
                           n_inner_folds=3)),
    }
    results = {}
    for mode, (story_data, trim, split, fused, fit) in modes.items():
        jasm = J.SimpleNeuroidAssembly(story_data, validation_method="outer")
        got = {}
        for pkg, asm in ((J, jasm), (T, assembly_from_reference(jasm))):
            trainer = _trainer(pkg, asm, None, out / f"{mode}_{pkg.__name__}",
                               feature_extractors=[extractors[pkg]],
                               trimming_config=trim,
                               use_train_test_split=split,
                               fused_downsample_fir=fused, layer_idx=1)
            assert trainer._fused_eligible() == fused
            got[pkg] = trainer.train(**fit)
        results[mode] = got[J], got[T]
    return results, extractors[T], stories


@pytest.mark.parametrize("mode", ["fused", "two_stage"])
def test_speech_trainer_matches_jax(speech_runs, mode):
    mj, mt = speech_runs[0][mode]
    np.testing.assert_array_equal(np.asarray(mt["best_alphas"]),
                                  np.asarray(mj["best_alphas"]))
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert mt["solver_paths"] == mj["solver_paths"]
    assert set(mt) == set(mj)
    stage = ("extract_downsample_fir_fused" if mode == "fused"
             else "extract_and_downsample")
    assert stage in mt["trainer_stage_seconds"]
    assert mt["median_score"] > 0.3  # the planted speech signal is found


def test_speech_trainer_extracts_once_and_caches(speech_runs):
    """Each story's windows run once through the port's encoder; the
    two-stage mode is served from its speech cache."""
    _, ex, stories = speech_runs
    n_windows = int(SPEECH_TRS * 2.0 - 1.0) + 1
    assert ex.counts["windows"] == LM_STORIES * n_windows
    assert len(list(Path(ex.cache_dir).glob("*.npz"))) == LM_STORIES


def test_speech_fused_matches_two_stage_in_the_port(speech_runs, tmp_path):
    """The fused kernel's input is the tuple's window times: the same
    delayed features as Downsampler('lanczos') then FIR."""
    _, ex, stories = speech_runs
    jasm = J.SimpleNeuroidAssembly(stories, validation_method="outer")
    asm = assembly_from_reference(jasm)
    fused = _trainer(T, asm, None, tmp_path, feature_extractors=[ex],
                     fused_downsample_fir=True, layer_idx=1)
    two = _trainer(T, asm, None, tmp_path, feature_extractors=[ex],
                   fused_downsample_fir=False, layer_idx=1)
    want = two.apply_fir_delays(two.extract_and_downsample_features())
    got = fused.extract_and_delay_features_fused()
    for story in want:
        assert tuple(got[story].shape) == (SPEECH_TRS, 4 * 16)
        np.testing.assert_allclose(got[story].numpy(), want[story].numpy(),
                                   atol=1e-5)

"""Import hygiene and device rules of litcoder_core_torch.

The port imports torch and never jax, flax, pandas or litcoder_core_tpu
(importing any submodule of the JAX package runs its __init__, which pulls
in jax; the card's machine has no pandas), and its entry points run on the
card unless the caller asks for the CPU: with no card they raise instead
of falling back."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import litcoder_core_torch
from litcoder_core_torch import cli
from litcoder_core_torch import (
    AbstractTrainer,
    Downsampler,
    NestedCVModel,
    SimpleNeuroidAssembly,
    StoryData,
    fit_nested_cv,
)
from litcoder_core_torch.features.language_model import (
    LanguageModelFeatureExtractor,
)
from litcoder_core_torch.features.speech_model import SpeechFeatureExtractor
from litcoder_core_torch.models import (
    BandedRidgeModel,
    LinearPredictivityModel,
    SklearnPredictivityModel,
    StackedRidgeModel,
    fit_banded_ridge,
    fit_stacked_ridge,
    variance_partitioning,
)
from litcoder_core_torch.ops.lanczos_fir import lanczos_fir
from litcoder_core_torch.parallel import (
    make_mesh,
    make_nested_cv_step,
    nested_cv_step,
)
from litcoder_core_torch.utils.testing import HashStubTokenizer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "litcoder_core_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _modules():
    names = ["litcoder_core_torch"]
    for info in pkgutil.walk_packages(litcoder_core_torch.__path__,
                                      "litcoder_core_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _modules()
    assert "litcoder_core_torch.trainer" in names
    assert "litcoder_core_torch.ops.lanczos_fir" in names
    assert "litcoder_core_torch.models.normalizer" in names
    for name in ("parallel.step", "parallel.mesh", "parallel.tp",
                 "ops.segment",
                 "assembly.assembly_loader", "features.language_model",
                 "features.convert", "features.custom", "utils.caches",
                 "utils.testing", "utils.core", "plotting.plotting_utils",
                 "features.speech_model", "assembly.base_processor",
                 "assembly.lebel_processor", "assembly.narratives_processor",
                 "assembly.lpp_processor", "assembly.assembly_generator",
                 "brain_projection.project", "brain_projection.simple_cache",
                 "models.banded", "models.stacking",
                 "models.variance_partition", "models.linear",
                 "models.sklearn_model", "cli", "sweeps"):
        assert f"litcoder_core_torch.{name}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pandas', 'litcoder_core_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_optional_packages_stay_unimported():
    """The card's machine may lack transformers, tensorboard, matplotlib,
    wandb, pandas, nibabel, nilearn, soundfile or scikit-learn: importing
    the package, the extractors, the processors, brain projection, the
    models, the CLI and the sweeps must not import them."""
    code = (
        "import sys\n"
        "import litcoder_core_torch\n"
        "import litcoder_core_torch.features.language_model\n"
        "import litcoder_core_torch.features.speech_model\n"
        "import litcoder_core_torch.assembly\n"
        "import litcoder_core_torch.brain_projection\n"
        "import litcoder_core_torch.utils\n"
        "import litcoder_core_torch.plotting\n"
        "import litcoder_core_torch.models\n"
        "import litcoder_core_torch.cli\n"
        "import litcoder_core_torch.sweeps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('transformers', 'tensorboard', 'matplotlib', 'wandb', "
        "'seaborn', 'nilearn', 'nibabel', 'pandas', 'soundfile', "
        "'sklearn'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "pandas",
                                "litcoder_core_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


def _tiny_assembly():
    rng = np.random.default_rng(0)
    stories = []
    for i in range(2):
        dt = np.sort(rng.uniform(0, 40, 50))
        stories.append(StoryData(
            name=f"s{i}", brain_data=rng.normal(size=(20, 3)),
            stimuli=["a"] * 50, split_indices=(dt // 2).astype(int).tolist(),
            tr_times=np.arange(20) * 2.0 + 1.0, data_times=dt,
            word_rates=np.ones(20), words=["a"] * 50))
    return SimpleNeuroidAssembly(stories, validation_method="outer")


def _entry_points(tmp_path):
    X = np.zeros((40, 2), np.float32)
    Y = np.zeros((40, 2), np.float32)
    return {
        "AbstractTrainer": lambda: AbstractTrainer(
            _tiny_assembly(), [], Downsampler(), None, [1], {},
            results_dir=str(tmp_path)),
        "NestedCVModel.fit_predict": lambda: NestedCVModel().fit_predict(
            X, Y, X_test=X, y_test=Y, chunk_length=4, n_inner_folds=2),
        "fit_nested_cv": lambda: fit_nested_cv(X, Y, X, Y, chunk_length=4,
                                               n_inner_folds=2),
        "NestedCVModel.fit_predict (full CV)": lambda: NestedCVModel(
        ).fit_predict(X, Y, chunk_length=4, n_inner_folds=2),
        "fit_nested_cv (full CV)": lambda: fit_nested_cv(
            X, Y, chunk_length=4, n_outer_folds=2, n_inner_folds=2),
        "lanczos_fir": lambda: lanczos_fir(np.zeros((5, 2)), np.arange(5.0),
                                           np.arange(3.0)),
        "Downsampler.downsample": lambda: Downsampler().downsample(
            np.zeros((5, 2)), np.arange(5.0), np.arange(3.0),
            method="lanczos", window=3, cutoff_mult=1.0),
        "Downsampler.downsample (default method)": lambda: Downsampler(
        ).downsample(np.zeros((5, 2)), np.arange(5.0), np.arange(3.0)),
        "LanguageModelFeatureExtractor": lambda: (
            LanguageModelFeatureExtractor({
                "model_name": "m", "model": torch.nn.Linear(2, 2),
                "tokenizer": HashStubTokenizer()})),
        "SpeechFeatureExtractor": lambda: SpeechFeatureExtractor(
            model_name="m", chunk_size=0.1, context_size=1.0,
            model=torch.nn.Linear(2, 2), feature_extractor=object()),
        "FeatureExtractorFactory speech": lambda: (
            litcoder_core_torch.FeatureExtractorFactory.create_extractor(
                "speech", "m", {"chunk_size": 0.1, "context_size": 1.0,
                                "model": torch.nn.Linear(2, 2),
                                "feature_extractor": object()},
                cache_dir=str(tmp_path))),
        "fit_banded_ridge": lambda: fit_banded_ridge(
            [X, X], Y, [X, X], Y, chunk_length=4, n_inner_folds=2),
        "BandedRidgeModel.fit_predict": lambda: BandedRidgeModel(
        ).fit_predict([X, X], Y, chunk_length=4, n_inner_folds=2),
        "fit_stacked_ridge": lambda: fit_stacked_ridge(
            [X, X], Y, [X, X], Y, chunk_length=4, n_inner_folds=2),
        "StackedRidgeModel.fit_predict": lambda: StackedRidgeModel(
        ).fit_predict([X, X], Y, chunk_length=4, n_inner_folds=2),
        "variance_partitioning": lambda: variance_partitioning(
            [X, X], Y, [X, X], Y, chunk_length=4, n_inner_folds=2),
        "cli.run": lambda: cli.run({"dataset_type": "lebel"}),
        "cli.main": lambda: cli.main([
            "--dataset_type", "lebel", "--assembly_path", "a.pkl",
            "--modality", "wordrate", "--model_name", "wordrate",
            "--ndelays", "1", "--lookback", "8", "--cache_dir",
            str(tmp_path)]),
        "LinearPredictivityModel.fit": lambda: LinearPredictivityModel(
            {}).fit(X, Y),
        "SklearnPredictivityModel.fit": lambda: SklearnPredictivityModel(
            {"use_groups": False, "n_folds": 2}).fit(X, Y),
        "nested_cv_step": lambda: nested_cv_step(
            np.zeros((40, 2)), Y, np.zeros((8, 2)), np.zeros((8, 2)),
            [1.0], np.arange(20).reshape(2, 10), np.arange(20, 40).reshape(
                2, 10)),
        "fit_nested_cv (n_devices)": lambda: fit_nested_cv(
            X, Y, X, Y, chunk_length=4, n_inner_folds=2, n_devices=2),
        "make_mesh": lambda: make_mesh(),
        "make_nested_cv_step (mesh)": lambda: make_nested_cv_step(
            make_mesh(devices=["cpu"] * 2))(
            np.zeros((40, 2)), Y, np.zeros((8, 2)), np.zeros((8, 2)),
            [1.0], np.arange(20).reshape(2, 10), np.arange(20, 40).reshape(
                2, 10)),
    }


@pytest.mark.parametrize("name", ["AbstractTrainer",
                                  "NestedCVModel.fit_predict",
                                  "fit_nested_cv",
                                  "NestedCVModel.fit_predict (full CV)",
                                  "fit_nested_cv (full CV)", "lanczos_fir",
                                  "Downsampler.downsample",
                                  "Downsampler.downsample (default method)",
                                  "LanguageModelFeatureExtractor",
                                  "SpeechFeatureExtractor",
                                  "FeatureExtractorFactory speech",
                                  "fit_banded_ridge",
                                  "BandedRidgeModel.fit_predict",
                                  "fit_stacked_ridge",
                                  "StackedRidgeModel.fit_predict",
                                  "variance_partitioning",
                                  "cli.run", "cli.main",
                                  "LinearPredictivityModel.fit",
                                  "SklearnPredictivityModel.fit",
                                  "nested_cv_step",
                                  "fit_nested_cv (n_devices)", "make_mesh",
                                  "make_nested_cv_step (mesh)"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """With no card, the default device raises; nothing runs on the CPU.
    (torch.cuda.is_available is forced False so the test means the same
    on a machine that has one.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[name]()


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out

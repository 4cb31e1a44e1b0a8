"""Import hygiene and device rules of litcoder_core_torch.

The port imports torch and never jax, flax, pandas or litcoder_core_tpu
(importing any submodule of the JAX package runs its __init__, which pulls
in jax; the card's machine has no pandas), and its entry points run on the
card unless the caller asks for the CPU: with no card they raise instead
of falling back."""

import ast
import importlib
import json
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
    REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))
NOTEBOOK = REPO / "examples" / "torch_quickstart.ipynb"


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
    examples = [str(p) for p in PORT_FILES if p.parent.name == "examples"]
    assert len(examples) == 6
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"for path in {examples!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def _notebook_code(path):
    cells = json.loads(path.read_text())["cells"]
    return "\n\n".join("".join(c["source"]) for c in cells
                        if c["cell_type"] == "code")


@pytest.mark.parametrize("path", PORT_FILES + [NOTEBOOK],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    text = (_notebook_code(path) if path.suffix == ".ipynb"
            else path.read_text())
    tree = ast.parse(text)
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


def test_every_example_and_jax_module_has_a_twin():
    """Each JAX module has a namesake in the port but the Pallas kernel's
    (its twin is ops/lanczos_fir.py with csrc/lanczos_fir.cu), and each
    example script and the notebook have an examples/torch_* twin."""
    def modules(pkg):
        root = REPO / pkg
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}

    missing = modules("litcoder_core_tpu") - modules("litcoder_core_torch")
    assert missing == {"ops/pallas_kernels.py"}
    assert (REPO / "litcoder_core_torch/ops/lanczos_fir.py").exists()
    examples = REPO / "examples"
    for path in examples.iterdir():
        if path.suffix in (".py", ".ipynb") and not path.name.startswith(
                "torch_"):
            assert (examples / f"torch_{path.name}").exists(), path.name


def _packages(root):
    pkg = importlib.import_module(root)
    names = [root] + [info.name for info in pkgutil.walk_packages(
        pkg.__path__, root + ".") if info.ispkg]
    return [n[len(root):] for n in names]


@pytest.mark.parametrize("sub", _packages("litcoder_core_torch"),
                         ids=lambda s: s or "litcoder_core_torch")
def test_all_is_a_superset_of_jax(sub):
    """Every name a JAX package exports through __all__ its twin exports
    too (the twins may export more)."""
    jax_all = getattr(importlib.import_module("litcoder_core_tpu" + sub),
                      "__all__", [])
    torch_pkg = importlib.import_module("litcoder_core_torch" + sub)
    assert set(jax_all) <= set(getattr(torch_pkg, "__all__", []))
    for name in jax_all:
        assert hasattr(torch_pkg, name), name


def test_ops_exports_the_jax_p_value_helpers():
    from litcoder_core_torch.ops import (  # noqa: F401
        bh_fdrcorrection,
        fisher_combine_pvalues,
        pearson_pvalues,
    )


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


def test_chip_smoke_takes_the_benchmark_traffic():
    """chip_smoke.py draws its problems and windows with the benchmark's own
    generators and rates its kernels against the benchmark's peaks, so no
    second copy can drift. The script's former window function mapped an
    empty word to an empty window, which the benchmark's does not; the
    script's vocabulary (w0 to w9999, one stub token each) has no empty
    word, so the swap changes no window."""
    import chip_smoke
    from cardbench.traffic import signal as bench_signal
    from cardbench.traffic import stories as bench_stories

    assert chip_smoke.signal_problem is bench_signal.signal_problem
    assert chip_smoke.fullcontext_windows is bench_stories.fullcontext_windows
    peaks = json.loads((REPO / "cardbench" / "peaks.json").read_text())
    assert chip_smoke.PEAK_BYTES_PER_S == peaks["bytes_per_s"]
    assert chip_smoke.PEAK_F32_FLOP_PER_S == peaks["f32_flop_per_s"]


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out

"""The examples' torch twins (examples/torch_*.py and
examples/torch_quickstart.ipynb) held against the JAX examples on the CPU.

Each JAX side runs its example's own code: the script's main() (its
NestedCVModel.fit_predict, fit_nested_cv, AbstractTrainer.train or
run_grid_sweep wrapped to keep what they return), or the notebook's code
cells in order. The twin gets the same numpy-seeded inputs, and where the
JAX example builds a Flax GPT-2 the twin gets its weights through
features.convert.torch_state_dict_from_flax. The solver's bars: the same
alpha on at least 99.9% of the voxels, correlations within 2e-3, median r
within 1e-3 and the same solver_paths.

The three pickle twins (train_simple, example, sweep_grid) read a small
LeBel-shaped pickle written with save_assembly, and each side runs with its
own working directory under tmp_path."""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import litcoder_core_tpu
from litcoder_core_torch.features.convert import torch_state_dict_from_flax
from litcoder_core_torch.parallel import make_mesh
from litcoder_core_torch.parallel.tp import make_lm_mesh
from litcoder_core_torch.utils.testing import HashStubTokenizer
from litcoder_core_tpu.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_tpu.assembly.assembly_loader import save_assembly
from litcoder_core_tpu.features.factory import (
    FeatureExtractorFactory as JaxFactory,
)
from litcoder_core_tpu.models.nested_cv import NestedCVModel as JaxNestedCV
from litcoder_core_tpu.trainer import AbstractTrainer as JaxTrainer
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
SAME_ALPHA_SHARE, CORR_ATOL, MEDIAN_ATOL = 0.999, 2e-3, 1e-3


def _example(name):
    """examples/<name>.py as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _keep_returns(monkeypatch, owner, name):
    """owner.<name> wrapped to append each return value to the list it
    returns."""
    kept = []
    original = getattr(owner, name)

    def keep(*args, **kwargs):
        kept.append(original(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(owner, name, keep)
    return kept


def _same_fit(got, want, got_alphas=None, want_alphas=None):
    got_alphas = got["best_alphas"] if got_alphas is None else got_alphas
    want_alphas = want["best_alphas"] if want_alphas is None else want_alphas
    same = np.mean(np.asarray(got_alphas, np.float32)
                   == np.asarray(want_alphas, np.float32))
    assert same >= SAME_ALPHA_SHARE, same
    np.testing.assert_allclose(np.asarray(got["correlations"]),
                               np.asarray(want["correlations"]),
                               atol=CORR_ATOL)
    assert abs(got["median_score"] - want["median_score"]) <= MEDIAN_ATOL
    assert got["solver_paths"] == want["solver_paths"]


def _gpt2_pair(**shape):
    """(Flax GPT-2 built as the JAX examples build it, torch twin)."""
    from transformers import FlaxGPT2Model, GPT2Config, GPT2Model

    cfg = GPT2Config(**shape)
    flax_model = FlaxGPT2Model(cfg, seed=0)
    model = GPT2Model(cfg).eval()
    model.load_state_dict(torch_state_dict_from_flax(flax_model.params))
    return flax_model, model


@pytest.fixture(scope="module")
def lebel_pickle(tmp_path_factory):
    """A small LeBel-shaped assembly pickle (brain data of n_TR - 15 rows,
    row i answering TR i + 10; stimuli 8-word fullcontext windows)."""
    stories = []
    for i in range(3):
        sd = _make_story(f"ex{i}", n_trs=120)
        stimuli = [" ".join(sd.words[max(0, j - 8):j + 1])
                   for j in range(len(sd.words))]
        stories.append(dataclasses.replace(
            sd, brain_data=sd.brain_data[10:-5], stimuli=stimuli))
    path = tmp_path_factory.mktemp("examples") / "lebel.pkl"
    save_assembly(SimpleNeuroidAssembly(stories, "outer"), str(path))
    return str(path)


def _workdirs(tmp_path):
    dirs = {side: tmp_path / side for side in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    return dirs


def test_multichip_fit(monkeypatch):
    fits = _keep_returns(monkeypatch, JaxNestedCV, "fit_predict")
    _example("multichip_fit").main()
    (want, _, want_alphas), (want_cv, _, want_alphas_cv) = fits

    got = _example("torch_multichip_fit").main(
        [], device="cpu", mesh=make_mesh(devices=["cpu"] * 8))
    assert got["n_devices"] == 8 and got["weights_shape"] == (24, 1001)
    _same_fit(got["metrics"], want, got["best_alphas"], want_alphas)
    _same_fit(got["metrics_cv"], want_cv, got["best_alphas_cv"],
              want_alphas_cv)


def test_wide_all_layer_fit(monkeypatch):
    twin = _example("torch_wide_all_layer_fit")
    fits = _keep_returns(monkeypatch, litcoder_core_tpu, "fit_nested_cv")
    _example("wide_all_layer_fit").main()
    [(want, _, want_alphas)] = fits

    _, model = _gpt2_pair(**twin.TINY_GPT2)
    got = twin.main([], device="cpu", model=model)
    assert got["n_layers"] == 8 and got["wide"]
    assert got["design"][1] == 8 * 64 * 4
    assert got["metrics"]["solver_paths"]["alpha_search"] == "dual"
    _same_fit(got["metrics"], want, got["best_alphas"], want_alphas)


def test_tp_extraction(monkeypatch, tmp_path):
    twin = _example("torch_tp_extraction")
    dirs = _workdirs(tmp_path)
    runs = _keep_returns(monkeypatch, JaxTrainer, "train")
    monkeypatch.chdir(dirs["jax"])
    _example("tp_extraction").main()
    [want] = runs

    _, model = _gpt2_pair(**twin.TINY_GPT2)
    monkeypatch.chdir(dirs["torch"])
    got = twin.main([], device="cpu", model=model,
                    mesh=make_lm_mesh(2, 4, devices=["cpu"] * 8))
    assert got["mesh_shape"] == {"data": 2, "model": 4}
    _same_fit(got["metrics"], want)
    assert got["metrics"]["n_significant"] == want["n_significant"]


def test_train_simple(monkeypatch, tmp_path, lebel_pickle):
    dirs = _workdirs(tmp_path)
    runs = _keep_returns(monkeypatch, JaxTrainer, "train")
    monkeypatch.chdir(dirs["jax"])
    monkeypatch.setattr(sys, "argv", ["train_simple.py", lebel_pickle])
    _example("train_simple").main()
    [want] = runs

    monkeypatch.chdir(dirs["torch"])
    got = _example("torch_train_simple").main([lebel_pickle], device="cpu")
    _same_fit(got, want)
    assert list((dirs["torch"] / "results" / "runs").iterdir())


def test_example_language_model(monkeypatch, tmp_path, lebel_pickle):
    """--modality language_model on a tiny GPT-2 (the JAX side gets the
    Flax model through its factory's config, where --model_name gpt2 would
    download one)."""
    flax_model, model = _gpt2_pair(vocab_size=600, n_positions=64,
                                   n_embd=16, n_layer=2, n_head=2)
    create = JaxFactory.create_extractor.__func__

    def with_flax_model(cls, modality, model_name, config, cache_dir="cache"):
        config = dict(config, model=flax_model,
                      tokenizer=HashStubTokenizer(), backend="flax")
        return create(cls, modality, model_name, config, cache_dir)

    dirs = _workdirs(tmp_path)
    argv = ["--assembly_path", lebel_pickle, "--model_name", "tiny-gpt2",
            "--layer_idx", "1", "--lookback", "8", "--last_token",
            "--logger_backend", "none", "--n_inner_folds", "3",
            "--chunk_length", "10"]
    runs = _keep_returns(monkeypatch, JaxTrainer, "train")
    monkeypatch.setattr(JaxFactory, "create_extractor",
                        classmethod(with_flax_model))
    monkeypatch.chdir(dirs["jax"])
    monkeypatch.setattr(sys, "argv", ["example.py", *argv])
    _example("example").main()
    [want] = runs

    monkeypatch.chdir(dirs["torch"])
    got = _example("torch_example").main(
        argv + ["--device", "cpu"], model=model,
        tokenizer=HashStubTokenizer())
    _same_fit(got, want)
    assert list((dirs["torch"] / "cache").iterdir())


def test_sweep_grid(monkeypatch, tmp_path, lebel_pickle):
    jax_example = _example("sweep_grid")
    dirs = _workdirs(tmp_path)
    sweeps = _keep_returns(monkeypatch, jax_example, "run_grid_sweep")
    args = [lebel_pickle, "--layers", "3", "9", "--out"]
    monkeypatch.setattr(sys, "argv", ["sweep_grid.py", *args,
                                      str(dirs["jax"])])
    jax_example.main()
    [want] = sweeps

    twin = _example("torch_sweep_grid")
    argv = args + [str(dirs["torch"]), "--device", "cpu"]
    got, table = twin.main(argv)
    assert [r["layer_idx"] for r in got] == [3, 9]
    assert len(table.splitlines()) == 2 + len(got)
    for g, w in zip(got, want):
        assert g["error"] is None and w["error"] is None
        assert g["config"] == w["config"]
        assert abs(g["median_score"] - w["median_score"]) <= MEDIAN_ATOL
        assert g["n_significant"] == w["n_significant"]
    summary = json.loads((dirs["torch"] / "summary.json").read_text())
    assert [r["config"] for r in summary] == [r["config"] for r in got]
    again, _ = twin.main(argv)
    assert again == got


@pytest.mark.parametrize("name", ["torch_multichip_fit",
                                  "torch_wide_all_layer_fit",
                                  "torch_tp_extraction", "torch_train_simple",
                                  "torch_example", "torch_sweep_grid"])
def test_twins_raise_without_a_card(name, monkeypatch, tmp_path,
                                    lebel_pickle):
    """With no card the default device raises before any work; nothing
    falls back to the CPU. (torch.cuda.is_available is forced False so the
    test means the same on a machine that has one.)"""
    argv = {"torch_train_simple": [lebel_pickle],
            "torch_example": ["--assembly_path", lebel_pickle,
                              "--modality", "wordrate"],
            "torch_sweep_grid": [lebel_pickle, "--out", str(tmp_path)]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv.get(name, []))
    assert not (tmp_path / "summary.json").exists()


def _notebook_namespace(path, replace=()):
    """The notebook's code cells executed in order in one namespace."""
    cells = json.loads(Path(path).read_text())["cells"]
    ns = {}
    for cell in cells:
        if cell["cell_type"] != "code":
            continue
        source = "".join(cell["source"])
        for old, new in replace:
            source = source.replace(old, new)
        exec(compile(source, str(path), "exec"), ns)
    return ns


def test_quickstart_notebook():
    want = _notebook_namespace(EXAMPLES / "quickstart.ipynb")
    first = json.loads((EXAMPLES / "torch_quickstart.ipynb").read_text())[
        "cells"][1]
    assert 'device = "cuda"\n' in first["source"]
    got = _notebook_namespace(EXAMPLES / "torch_quickstart.ipynb",
                              [('device = "cuda"', 'device = "cpu"')])
    assert got["mesh"].size == 8
    np.testing.assert_allclose(got["X"].numpy(), np.asarray(want["X"]),
                               atol=1e-5)
    assert float((got["fused"] - got["X"]).abs().max()) <= 1e-5
    _same_fit(got["metrics"], want["metrics"], got["best_alphas"],
              want["best_alphas"])
    np.testing.assert_allclose(
        got["correlations"],
        np.asarray(want["result"].correlations)[:want["n_orig"]],
        atol=CORR_ATOL)
    np.testing.assert_array_equal(
        got["result"].best_alphas.gather("cpu").numpy()[:got["n_orig"]],
        np.asarray(want["result"].best_alphas)[:want["n_orig"]])

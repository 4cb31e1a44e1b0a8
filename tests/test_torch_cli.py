"""Port parity for the command line (litcoder_core_torch.cli against
litcoder_core_tpu.cli) on the CPU: parse_args, the presets and the
extractor configs; run(config) on one assembly pickle saved by the JAX
package, in every mode the CLI wires (the LeBel split, the narratives
preset's full CV, --banded, --stacking, permutation significance,
--fast_scan, a trimming override, --story_order, a tiny GPT-2), with the
solver's bar (the same alphas and gammas, correlations within 2e-3,
median r within 1e-3, the same n_significant and solver_paths); the
same errors with the same texts; main(argv) end to end; and the
NestedCVModel mesh/n_devices arguments the CLI passes."""

import dataclasses

import numpy as np
import pytest
import torch

import litcoder_core_tpu.cli as jcli
import litcoder_core_torch.cli as tcli
from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.utils.testing import HashStubTokenizer
from litcoder_core_tpu.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_tpu.assembly.assembly_loader import save_assembly
from litcoder_core_tpu.features.embeddings import SimpleKeyedVectors
from tests.test_torch_language_model import (  # noqa: F401 (a fixture)
    _fullcontext,
    gpt2_pair,
)
from tests.test_torch_significance import _jax_offsets
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

N_TR = 120


def _lebel_stories(prefix, n, **kw):
    """LeBel layout: brain data of n_TR - 15 rows, row i answering TR
    i + 10 (the lebel preset's trims)."""
    return [dataclasses.replace(sd, brain_data=sd.brain_data[10:-5], **kw)
            for sd in (_make_story(f"{prefix}{i}", n_trs=N_TR)
                       for i in range(n))]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Paths of the JAX-saved pickles (lebel, narratives, lm) and the
    .kv bundle."""
    root = tmp_path_factory.mktemp("cli_data")
    paths = {}
    lebel = _lebel_stories("cli", 4)
    narr = [_make_story(f"narr{i}", n_trs=N_TR) for i in range(2)]
    lm = [dataclasses.replace(sd, stimuli=_fullcontext(sd.words, 8))
          for sd in _lebel_stories("clilm", 3)]
    for name, stories in (("lebel", lebel), ("narratives", narr),
                          ("lm", lm)):
        paths[name] = str(root / f"{name}.pkl")
        save_assembly(SimpleNeuroidAssembly(stories, "outer"), paths[name])
    n = max(len(sd.words) for sd in lebel + narr)
    vecs = np.random.default_rng(11).normal(size=(n, 6)).astype(np.float32)
    paths["kv"] = str(root / "vecs.kv")
    SimpleKeyedVectors([f"w{i}" for i in range(n)], vecs).save_kv(
        paths["kv"])
    return paths


def _argv(data, tmp_path, dataset="lebel", *extra, pickle=None):
    return ["--dataset_type", dataset,
            "--assembly_path", data[pickle or dataset],
            "--ndelays", "4", "--lookback", "256",
            "--cache_dir", str(tmp_path / "cache"),
            "--results_dir", str(tmp_path / "results"),
            "--logger_backend", "none", "--chunk_length", "10",
            "--n_inner_folds", "3", *extra]


def _config(data, tmp_path, dataset="lebel", pickle=None, **overrides):
    """The parsed-args dict of the JAX CLI for a wordrate + embeddings
    run on data[pickle or dataset], with `overrides`."""
    config = vars(jcli.parse_args(_argv(data, tmp_path, dataset,
                                        pickle=pickle)))
    config.update(modalities=["wordrate", "embeddings"],
                  model_names=["wordrate", "vecs"], vector_path=data["kv"])
    config.update(overrides)
    return config


def _both(config, tmp_path):
    """(JAX metrics, port metrics) of one config; each package gets its own
    cache and results directories, and the port runs on the CPU."""
    out = {}
    for name, cli, extra in (("jax", jcli, {}),
                             ("torch", tcli, {"device": "cpu"})):
        cfg = dict(config, cache_dir=str(tmp_path / f"{name}_cache"),
                   results_dir=str(tmp_path / f"{name}_results"), **extra)
        out[name] = cli.run(cfg)
    return out["jax"], out["torch"]


def _assert_parity(want, got, full_cv=False):
    np.testing.assert_array_equal(np.asarray(got["best_alphas"]),
                                  np.asarray(want["best_alphas"]))
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=2e-3)
    assert abs(got["median_score"] - want["median_score"]) <= 1e-3
    assert got["n_significant"] == want["n_significant"]
    assert got["solver_paths"] == want["solver_paths"]
    if not full_cv:
        assert set(got) == set(want)


RUN_CASES = {
    "lebel": ("lebel", {}),
    "narratives": ("narratives", dict(n_outer_folds=3)),
    "banded": ("lebel", dict(banded=True, n_gammas=3)),
    "stacking": ("lebel", dict(stacking=True)),
    "permutation": ("lebel", dict(significance="permutation",
                                  n_permutations=200)),
    "fast_scan": ("lebel", dict(fast_scan=True)),
    "trimming_override": ("lebel", dict(train_features_start=12,
                                        train_targets_start=2,
                                        test_features_start=52,
                                        test_targets_start=42)),
    "story_order": ("lebel", dict(story_order=["cli2", "cli0", "cli3",
                                               "cli1"])),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_matches_jax(case, data, tmp_path, monkeypatch):
    dataset, overrides = RUN_CASES[case]
    if case == "permutation":
        monkeypatch.setattr(tcv, "_permutation_offsets", _jax_offsets)
    want, got = _both(_config(data, tmp_path, dataset, **overrides),
                      tmp_path)
    _assert_parity(want, got, full_cv=dataset == "narratives")
    if dataset == "narratives":
        assert got["solver_paths"]["mode"].startswith("full_cv")
        assert got["n_majority_significant"] == want["n_majority_significant"]
    if case == "banded":
        np.testing.assert_array_equal(got["best_gammas"],
                                      want["best_gammas"])
        assert np.asarray(got["best_gammas"]).shape == (12, 2)
    if case == "stacking":
        np.testing.assert_allclose(got["stack_weights_mean"],
                                   want["stack_weights_mean"], atol=1e-4)
    if case == "permutation":
        assert got["significance_method"] == "permutation"
        np.testing.assert_array_equal(got["p_values"], want["p_values"])
    if case == "fast_scan":
        assert got["solver_paths"]["fast_scan"] == "bf16"
    if case == "lebel":
        assert got["median_score"] > 0.25  # the word-rate signal is found


def test_trimming_override_leaves_the_preset(data, tmp_path):
    preset = {k: dict(v["trimming"]) for k, v in
              tcli.DATASET_CONFIGS.items()}
    tcli.run(_config(data, tmp_path, train_features_start=12,
                     train_targets_start=2, device="cpu"))
    assert {k: v["trimming"] for k, v in
            tcli.DATASET_CONFIGS.items()} == preset
    assert tcli.DATASET_CONFIGS == jcli.DATASET_CONFIGS


@pytest.mark.parametrize("banded", [False, True], ids=["alone", "banded"])
def test_language_model_run_matches_jax(banded, gpt2_pair, data,  # noqa: F811
                                        tmp_path):
    """A tiny GPT-2 (the Flax model in JAX, its torch twin in the port)
    over fullcontext windows, the same HashStubTokenizer on both sides;
    alone, and beside the word rate with --banded."""
    fm, tm = gpt2_pair
    spaces = (dict(modalities=["wordrate", "language_model"],
                   model_names=["wordrate", "tiny-gpt2"], banded=True,
                   n_gammas=3) if banded else
              dict(modalities=["language_model"], model_names=["tiny-gpt2"]))
    config = _config(data, tmp_path, pickle="lm", layer_idx=1, lookback=8,
                     last_token=True, **spaces)
    out = {}
    for name, cli, extra, model in (
            ("jax", jcli, {"backend": "flax"}, fm),
            ("torch", tcli, {}, tm)):
        cfg = dict(config, cache_dir=str(tmp_path / f"{name}_cache"),
                   results_dir=str(tmp_path / f"{name}_results"),
                   extractor_config_overrides={"language_model": dict(
                       model=model, tokenizer=HashStubTokenizer(),
                       batch_size=64, **extra)})
        if name == "torch":
            cfg["device"] = "cpu"
        out[name] = cli.run(cfg)
    _assert_parity(out["jax"], out["torch"])
    if banded:
        np.testing.assert_array_equal(out["torch"]["best_gammas"],
                                      out["jax"]["best_gammas"])


def test_main_matches_jax(data, tmp_path):
    argv = _argv(data, tmp_path, "lebel", "--modalities", "wordrate",
                 "embeddings", "--model_names", "wordrate", "vecs",
                 "--vector_path", data["kv"])
    want = jcli.main(argv + ["--results_dir", str(tmp_path / "j")])
    got = tcli.main(argv + ["--results_dir", str(tmp_path / "t"),
                            "--device", "cpu"])
    _assert_parity(want, got)


PARSE_ARGVS = {
    "defaults": [],
    "banded": ["--banded", "--n_gammas", "4", "--modalities", "wordrate",
               "embeddings", "--model_names", "wordrate", "v"],
    "stacking": ["--stacking", "--no_single_alpha", "--seed", "3"],
    "trimming": [arg for i, p in enumerate(jcli.TRIMMING_PARAMS)
                 for arg in (f"--{p}", str(i - 5))],
    "fast_scan_bare": ["--fast_scan"],
    "fast_scan_true": ["--fast_scan", "true"],
    "fast_scan_auto": ["--fast_scan", "AUTO", "--significance",
                       "permutation", "--n_permutations", "50"],
    "tp": ["--tp_data", "2", "--tp_model", "4", "--feature_dtype",
           "bfloat16", "--use_gpu"],
    "n_devices": ["--n_devices", "8", "--story_order", "a", "b",
                  "--last_token", "--binary", "--lowercase"],
}


@pytest.mark.parametrize("case", sorted(PARSE_ARGVS))
def test_parse_args_matches_jax(case):
    argv = ["--dataset_type", "narratives", "--ndelays", "3", "--lookback",
            "64", "--cache_dir", "c", *PARSE_ARGVS[case]]
    got = vars(tcli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jcli.parse_args(argv))
    assert vars(tcli.parse_args(argv + ["--device", "cpu"]))["device"] \
        == "cpu"


@pytest.mark.parametrize("argv", [["--fast_scan", "maybe"],
                                  ["--device", "tpu"]])
def test_bad_flags_exit(argv, capsys):
    full = ["--dataset_type", "lebel", "--ndelays", "3", "--lookback", "8",
            "--cache_dir", "c", *argv]
    with pytest.raises(SystemExit):
        tcli.parse_args(full)
    if argv[0] == "--fast_scan":
        with pytest.raises(SystemExit):
            jcli.parse_args(full)
    assert f"error: argument {argv[0]}" in capsys.readouterr().err


def test_presets_match_jax():
    assert tcli.DATASET_CONFIGS == jcli.DATASET_CONFIGS
    assert tcli.TRIMMING_PARAMS == jcli.TRIMMING_PARAMS


@pytest.mark.parametrize("modality", ["language_model", "speech",
                                      "embeddings", "wordrate"])
def test_build_feature_config_matches_jax(modality):
    config = vars(jcli.parse_args(["--dataset_type", "lebel", "--ndelays",
                                   "2", "--lookback", "32", "--cache_dir",
                                   "c", "--vector_path", "v.kv",
                                   "--layer_idx", "3", "--last_token"]))
    config["extractor_config_overrides"] = {modality: {"batch_size": 7}}
    got = tcli.build_feature_config(modality, "m", dict(config,
                                                        device="cpu"))
    want = jcli.build_feature_config(modality, "m", dict(config))
    if modality in ("language_model", "speech"):
        assert got.pop("device") == "cpu"
    assert got == want
    assert got["batch_size"] == 7


def _raises_both(config, tmp_path, exc=ValueError):
    texts = []
    for cli, extra in ((jcli, {}), (tcli, {"device": "cpu"})):
        with pytest.raises(exc) as info:
            cli.run(dict(config, **extra))
        texts.append(str(info.value))
    assert texts[0] == texts[1]
    return texts[0]


ERROR_CASES = {
    "banded_and_stacking": ("lebel", dict(banded=True, stacking=True),
                            "mutually exclusive"),
    "banded_on_narratives": ("narratives", dict(banded=True),
                             "requires a train/test-split"),
    "stacking_on_narratives": ("narratives", dict(stacking=True),
                               "requires a train/test-split"),
    "banded_normalize": ("lebel", dict(banded=True,
                                       normalize_features=True),
                         "not supported with --banded"),
    "stacking_normalize": ("lebel", dict(stacking=True,
                                         normalize_targets=True),
                           "not supported with --stacking"),
    "stacking_fast_scan": ("lebel", dict(stacking=True, fast_scan="auto"),
                           "--fast_scan/--significance"),
    "stacking_significance": ("lebel", dict(stacking=True,
                                            significance="permutation"),
                              "--fast_scan/--significance"),
    "stacking_n_permutations": ("lebel", dict(stacking=True,
                                              n_permutations=50),
                                "--n_permutations/--n_gammas"),
    "stacking_n_gammas": ("lebel", dict(stacking=True, n_gammas=4),
                          "--n_permutations/--n_gammas"),
    "model_names_mismatch": ("lebel", dict(model_names=["a", "b", "c"]),
                             "must match"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_run_errors_match_jax(case, data, tmp_path):
    dataset, overrides, text = ERROR_CASES[case]
    config = _config(data, tmp_path, dataset, **overrides)
    if case == "banded_and_stacking":
        config["assembly_path"] = str(tmp_path / "never_read.pkl")
    assert text in _raises_both(config, tmp_path)


@pytest.mark.parametrize("drop,text", [
    (("--modalities", "--modality"), "--modality or --modalities"),
    (("--model_names", "--model_name"), "--model_name or --model_names"),
    (("--assembly_path", "--data_dir"), "--data_dir or --assembly_path"),
])
def test_main_errors_match_jax(drop, text, tmp_path):
    argv = ["--dataset_type", "lebel", "--ndelays", "2", "--lookback", "8",
            "--cache_dir", str(tmp_path), "--modality", "wordrate",
            "--model_name", "wordrate", "--assembly_path", "a.pkl"]
    keep = [a for i, a in enumerate(argv)
            if a not in drop and (i == 0 or argv[i - 1] not in drop)]
    texts = []
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(ValueError) as info:
            cli.main(keep + extra)
        texts.append(str(info.value))
    assert texts[0] == texts[1] and text in texts[0]


@pytest.mark.parametrize("overrides", [
    dict(modalities=["language_model"], model_names=["gpt2"], tp_model=2),
    dict(modalities=["speech"], model_names=["w2v"], tp_data=2),
    dict(n_devices=2),
    dict(banded=True, n_devices=2),
    dict(stacking=True, n_devices=2),
], ids=["tp_model_lm", "tp_data_speech", "n_devices", "banded_n_devices",
        "stacking_n_devices"])
def test_not_ported_raise(overrides, data, tmp_path,
                          gpt2_pair):  # noqa: F811
    """The mesh flags are ported: each run gives the JAX CLI's metrics
    with the same flags (the JAX side on its 8 virtual CPU devices, the
    port on entries of the CPU); the speech mesh is held at the extractor
    config the CLI builds (its forward: tests/test_torch_tp.py)."""
    config = _config(data, tmp_path, **overrides)
    if "speech" in config["modalities"]:
        want = jcli.build_feature_config("speech", "w2v", dict(config))
        got = tcli.build_feature_config("speech", "w2v",
                                        dict(config, device="cpu"))
        assert got["mesh"].shape == dict(want["mesh"].shape) == {
            "data": 2, "model": 1}
        assert {d.type for d in got["mesh"].devices.flat} == {"cpu"}
        return
    if "language_model" in config["modalities"]:
        fm, tm = gpt2_pair
        config = _config(data, tmp_path, pickle="lm", layer_idx=1,
                         lookback=8, last_token=True,
                         **dict(overrides, model_names=["tiny-gpt2"]))
        out = {}
        for name, cli, extra, model in (
                ("jax", jcli, {"backend": "flax"}, fm),
                ("torch", tcli, {}, tm)):
            cfg = dict(config, cache_dir=str(tmp_path / f"{name}_cache"),
                       results_dir=str(tmp_path / f"{name}_results"),
                       extractor_config_overrides={"language_model": dict(
                           model=model, tokenizer=HashStubTokenizer(),
                           batch_size=64, **extra)})
            if name == "torch":
                cfg["device"] = "cpu"
            out[name] = cli.run(cfg)
        _assert_parity(out["jax"], out["torch"])
        return
    want, got = _both(config, tmp_path)
    _assert_parity(want, got)
    if config.get("stacking"):
        np.testing.assert_allclose(got["stack_weights_mean"],
                                   want["stack_weights_mean"], atol=1e-4)


def test_tp_flags_are_ignored_without_a_sharded_model(data, tmp_path):
    """As in JAX, --tp_* only matter to the LM and speech extractors."""
    metrics = tcli.run(_config(data, tmp_path, tp_model=2, device="cpu"))
    assert np.isfinite(metrics["median_score"])


@pytest.mark.parametrize("full_cv", [False, True])
def test_nested_cv_model_mesh_arguments(full_cv):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    Y = (X @ rng.normal(size=(6, 10)) + rng.normal(size=(200, 10))).astype(
        np.float32)
    kw = dict(chunk_length=10, n_inner_folds=3)
    if full_cv:
        kw["n_outer_folds"] = 3
    else:
        kw.update(X_test=X[:40], y_test=Y[:40])
    plain = tcv.NestedCVModel(device="cpu").fit_predict(X, Y, **kw)
    unset = tcv.NestedCVModel(mesh=None, n_devices=None,
                              device="cpu").fit_predict(X, Y, **kw)
    assert unset[0]["best_alphas"] == plain[0]["best_alphas"]
    assert unset[0]["correlations"] == plain[0]["correlations"]
    positional = tcv.NestedCVModel("ridge_regression", 0, None, None, None,
                                   "cpu")
    assert (positional.mesh, positional.n_devices, positional.device) == (
        None, None, "cpu")
    sharded = tcv.NestedCVModel(n_devices=2, device="cpu").fit_predict(
        X, Y, **kw)
    assert sharded[0]["best_alphas"] == plain[0]["best_alphas"]
    np.testing.assert_allclose(sharded[0]["correlations"],
                               plain[0]["correlations"], atol=1e-5)
    with pytest.raises(TypeError, match="Mesh"):
        tcv.NestedCVModel(mesh=object(), device="cpu").fit_predict(X, Y,
                                                                   **kw)

"""Port parity for the least-squares and scikit-learn models
(litcoder_core_torch.models.linear and .sklearn_model) against the JAX
package's, on seeded numpy problems on the CPU: the GroupKFold folds,
each fold's coefficients, intercept and scores within 1e-4 on full-rank
and rank-deficient designs (the minimum-norm solution), the files each
package saves, 1-D features and the single in-sample split; the
scikit-learn wrapper's metrics with a tuning grid."""

import sys

import numpy as np
import pytest
import torch

from litcoder_core_torch.models import linear as tlin
from litcoder_core_torch.models import sklearn_model as tsk
from litcoder_core_torch.models.folding import group_kfold_splits
from litcoder_core_tpu.models import linear as jlin
from litcoder_core_tpu.models import sklearn_model as jsk

torch.set_num_threads(2)

ATOL = 1e-4


def _problem(T=240, D=6, V=9, noise=0.3, seed=5, design="full_rank"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    if design == "duplicated_column":
        X[:, 3] = X[:, 1]
    elif design == "constant_column":
        X[:, 2] = 1.5
    wt = rng.normal(size=(D, V)).astype(np.float32)
    Y = (X @ wt + 2.0 + noise * rng.normal(size=(T, V))).astype(np.float32)
    return X, Y


def _pair(**config):
    return (tlin.LinearPredictivityModel(dict(config, device="cpu")),
            jlin.LinearPredictivityModel(dict(config)))


@pytest.mark.parametrize("groups", [
    np.repeat(np.arange(4), 60),
    np.repeat([3, 0, 2, 1, 4], [30, 70, 50, 40, 50]),
    np.random.default_rng(0).integers(0, 9, 240),
], ids=["equal", "unequal", "random"])
@pytest.mark.parametrize("n_folds", [2, 4])
def test_group_kfold_matches_sklearn(groups, n_folds):
    from sklearn.model_selection import GroupKFold

    want = list(GroupKFold(n_splits=n_folds).split(groups, groups=groups))
    got = group_kfold_splits(groups, n_folds)
    assert len(got) == len(want)
    for (gtr, gte), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(gtr, wtr)
        np.testing.assert_array_equal(gte, wte)


@pytest.mark.parametrize("design", ["full_rank", "duplicated_column",
                                    "constant_column"])
def test_fit_matches_jax(design):
    X, Y = _problem(design=design)
    groups = np.repeat(np.arange(4), 60)
    tm, jm = _pair(n_folds=4)
    got = tm.fit(X, Y, groups=groups)
    want = jm.fit(X, Y, groups=groups)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=ATOL)
    for key in ("median_score", "mean_score", "std_score"):
        assert abs(got[key] - want[key]) <= ATOL
    np.testing.assert_allclose(tm.scores, jm.scores, atol=ATOL)
    assert len(tm.models) == len(jm.models) == 4
    for (gc, gi), (wc, wi) in zip(tm.models, jm.models):
        assert gc.shape == wc.shape == (6, 9)
        np.testing.assert_allclose(gc, wc, atol=ATOL)
        np.testing.assert_allclose(gi, wi, atol=ATOL)
    assert tm.best_score == pytest.approx(jm.best_score, abs=ATOL)
    np.testing.assert_allclose(tm.predict(X[:7]), jm.predict(X[:7]),
                               atol=1e-3)


@pytest.mark.parametrize("design", ["duplicated_column", "constant_column"])
def test_rank_deficient_gives_the_minimum_norm_solution(design):
    """A duplicated column shares its weight equally with its twin, a
    constant one gets none: the pseudo-inverse solution, not QR's."""
    X, Y = _problem(design=design)
    tm, _ = _pair()
    tm.fit(X, Y)
    coef, intercept = tm.best_model
    Xc = X.astype(np.float64) - X.mean(axis=0)
    Yc = Y.astype(np.float64) - Y.mean(axis=0)
    want = np.linalg.pinv(Xc, rcond=1e-6) @ Yc
    np.testing.assert_allclose(coef, want, atol=ATOL)
    if design == "duplicated_column":
        np.testing.assert_allclose(coef[1], coef[3], atol=ATOL)
    else:
        np.testing.assert_allclose(coef[2], 0.0, atol=ATOL)
    np.testing.assert_allclose(
        intercept, Y.mean(axis=0) - X.mean(axis=0) @ coef, atol=1e-3)


def test_one_dimensional_features_and_a_single_fold():
    rng = np.random.default_rng(0)
    x = rng.normal(size=60).astype(np.float32)
    Y = (np.outer(x, [1.0, -2.0])
         + 0.01 * rng.normal(size=(60, 2))).astype(np.float32)
    tm, jm = _pair(n_folds=1)
    got, want = tm.fit(x, Y), jm.fit(x, Y)
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=ATOL)
    assert got["median_score"] > 0.9
    np.testing.assert_allclose(tm.models[0][0], jm.models[0][0], atol=ATOL)
    assert tm.predict(x).shape == (60, 2)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), atol=1e-3)


def test_too_few_groups_fit_in_sample_and_scores_accumulate():
    """Fewer groups than folds: one in-sample split, as in JAX; a second
    fit adds its folds to the first's, and the metrics average both."""
    X, Y = _problem(T=80)
    groups = np.repeat([0, 1], 40)
    tm, jm = _pair(n_folds=3)
    tm.fit(X, Y, groups=groups)
    jm.fit(X, Y, groups=groups)
    X2, Y2 = _problem(T=80, seed=6)
    got, want = tm.fit(X2, Y2), jm.fit(X2, Y2)
    assert len(tm.scores) == len(jm.scores) == 2
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=ATOL)


def test_tensor_inputs_match_numpy():
    X, Y = _problem()
    groups = np.repeat(np.arange(4), 60)
    a = tlin.LinearPredictivityModel({"n_folds": 4, "device": "cpu"})
    b = tlin.LinearPredictivityModel({"n_folds": 4, "device": "cpu"})
    got = a.fit(torch.as_tensor(X), torch.as_tensor(Y), groups=groups)
    want = b.fit(X, Y, groups=groups)
    assert got == want


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_saved_files_load_in_the_other_package(writer, tmp_path):
    X, Y = _problem()
    groups = np.repeat(np.arange(4), 60)
    tm, jm = _pair(n_folds=4)
    src, dst = (tm, jm) if writer == "torch" else (jm, tm)
    fresh = type(dst)({"device": "cpu"})
    src.fit(X, Y, groups=groups)
    src.save(tmp_path / "lin")
    assert np.load(tmp_path / "lin" / "best_model_coefficients.npy").shape \
        == (9, 6)
    fresh.load(tmp_path / "lin")
    np.testing.assert_array_equal(fresh.best_model[0], src.best_model[0])
    np.testing.assert_allclose(fresh.predict(X[:5]), src.predict(X[:5]),
                               atol=1e-5)


def test_errors_match_jax(tmp_path):
    tm, jm = _pair()
    for model in (tm, jm):
        with pytest.raises(ValueError, match="^Model has not been fitted"):
            model.predict(np.zeros((3, 2)))
        with pytest.raises(ValueError, match="^No model to save$"):
            model.save(tmp_path / "x")
        with pytest.raises(FileNotFoundError, match="No model found at"):
            model.load(tmp_path / "missing")


@pytest.mark.parametrize("config,use_groups", [
    ({"model_type": "ridge", "n_folds": 3, "use_groups": False,
      "param_grid": {"alpha": [0.1, 1.0, 10.0]}, "inner_cv": 3}, False),
    ({"model_type": "linear", "n_folds": 4}, True),
    ({"model_type": "lasso", "n_folds": 3, "use_groups": False,
      "model_kwargs": {"alpha": 0.01}}, False),
], ids=["ridge_grid", "linear_groups", "lasso"])
def test_sklearn_model_matches_jax(config, use_groups, tmp_path):
    X, Y = _problem()
    groups = np.repeat(np.arange(4), 60) if use_groups else None
    got = tsk.SklearnPredictivityModel(dict(config, device="cpu")).fit(
        X, Y, groups=groups)
    want = jsk.SklearnPredictivityModel(dict(config)).fit(
        X, Y, groups=groups)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=ATOL)
    for key in ("median_score", "mean_score", "best_fold_score"):
        assert abs(got[key] - want[key]) <= ATOL
    assert got["best_model_params"] == want["best_model_params"]
    assert got.get("alpha") == want.get("alpha")


def test_sklearn_model_save_load_and_errors(tmp_path):
    X, Y = _problem()
    config = {"model_type": "ridge", "n_folds": 3, "use_groups": False,
              "output_dir": str(tmp_path / "sk"), "device": "cpu"}
    model = tsk.SklearnPredictivityModel(config)
    model.fit(X, Y)
    fresh = jsk.SklearnPredictivityModel({"model_type": "ridge"})
    fresh.load(tmp_path / "sk")
    np.testing.assert_allclose(fresh.predict(X[:4]), model.predict(X[:4]),
                               atol=1e-5)
    for pkg in (tsk, jsk):
        with pytest.raises(ValueError, match="Unsupported model type: svr"):
            pkg.SklearnPredictivityModel({"model_type": "svr"})
    with pytest.warns(UserWarning, match="no groups provided"):
        tsk.SklearnPredictivityModel({"n_folds": 2, "device": "cpu"}).fit(
            X, Y)


def test_sklearn_model_without_scikit_learn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tsk.SklearnPredictivityModel({})

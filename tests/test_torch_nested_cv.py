"""Port parity for fit_nested_cv in train/test mode: the port on the CPU
against the JAX package on the same seeded numpy problem (T~400, D=40,
V=30). Bars (README's solver parity): identical selected alphas,
correlations within 2e-3, median r within 1e-3, the same metric keys and
solver_paths."""

import numpy as np
import pytest
import torch

from litcoder_core_tpu.models import nested_cv as jcv
from litcoder_core_torch.models import nested_cv as tcv

torch.set_num_threads(2)


def _problem(T=400, D=40, V=30, Tp=100, seed=0, zero_col=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    Xt = rng.normal(size=(Tp, D)).astype(np.float32)
    if zero_col:
        X[:, 7] = 0.0
        Xt[:, 7] = 0.0
    W = (rng.normal(size=(D, V)) * rng.uniform(0.02, 0.3, V)).astype(
        np.float32)
    Y = (X @ W + rng.normal(size=(T, V))).astype(np.float32)
    Yt = (Xt @ W + rng.normal(size=(Tp, V))).astype(np.float32)
    return X, Y, Xt, Yt


def _assert_parity(got, want):
    mt, wt, at = got
    mj, wj, aj = want
    np.testing.assert_array_equal(at, aj)
    assert set(mt) == set(mj)
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert mt["n_significant"] == mj["n_significant"]
    if wj is None:
        assert wt is None
    else:
        np.testing.assert_allclose(wt, wj, atol=1e-3 * np.abs(wj).max())


@pytest.mark.parametrize("T,form", [(400, "complement"), (410, "gather")])
@pytest.mark.parametrize("return_weights", [True, False])
def test_train_test_matches_jax(T, form, return_weights):
    """400 rows in chunks of 20 cover every row (complement form); 410
    leave a 10-row tail outside every fold (gather form)."""
    X, Y, Xt, Yt = _problem(T=T)
    splits = tcv.create_folds(T, "chunked", 5, 20, seed=0)
    assert tcv._folds_cover_all_rows(splits, T) == (form == "complement")
    kw = dict(chunk_length=20, n_inner_folds=5, seed=0,
              return_weights=return_weights)
    got = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw)
    want = jcv.fit_nested_cv(X, Y, Xt, Yt, **kw)
    assert got[0]["solver_paths"] == {"mode": "train_test",
                                      "alpha_search": "chol",
                                      "fast_scan": "off"}
    _assert_parity(got, want)


def test_single_alpha_and_contiguous_folds_match_jax():
    X, Y, Xt, Yt = _problem(seed=1)
    kw = dict(chunk_length=20, n_inner_folds=4, single_alpha=True,
              folding_type="chunked_contiguous")
    got = tcv.NestedCVModel(seed=3, device="cpu").fit_predict(
        X, Y, X_test=Xt, y_test=Yt, **kw)
    want = jcv.NestedCVModel(seed=3).fit_predict(X, Y, X_test=Xt,
                                                 y_test=Yt, **kw)
    assert len(set(got[2].tolist())) == 1
    _assert_parity(got, want)


@pytest.mark.parametrize("form", ["complement", "gather"])
def test_fold_factors_and_scores_match_jax(form):
    """One fold of each form: the solve factors Z_a = (G_tr + a^2 I)^-1
    Xva^T (invariant, unlike eigenvectors) and the (A, V) fold scores."""
    X, Y, _, _ = _problem(seed=4)
    tr, va = tcv.create_folds(400, "chunked", 5, 20, seed=0)[2]
    alphas = np.logspace(-1, 4, 6).astype(np.float32)
    tX, tY, ta = (torch.as_tensor(a) for a in (X, Y, alphas))
    tva = torch.as_tensor(va)
    if form == "complement":
        Zj = jcv._complement_fold_factors(X, jcv._full_gram(X), va, alphas,
                                          True)
        sj = jcv._score_fold_chol_whole_complement(X, Y, va, Zj,
                                                   jcv._xty_scan(X, Y), True)
        Zt = tcv._complement_fold_factors(tX[tva], tX.T @ tX, ta, True)
        st = tcv._score_fold_voxel_chunks(Zt, tY, True, None,
                                          form="complement", X=tX, va=tva,
                                          XtY_base=tX.T @ tY)
    else:
        Zj, _ = jcv._fold_chol_factors(X[tr], X[va], alphas, True)
        sj = jcv._score_chunk_chol(Zj, X[tr], Y[tr], Y[va], True)
        Zt, _ = tcv._fold_chol_factors(tX[tr], tX[tva], ta, True)
        st = tcv._score_fold_voxel_chunks(Zt, tY, True, None, form="gather",
                                          X=tX, tr=torch.as_tensor(tr),
                                          va=tva)
    Zj = np.asarray(Zj)
    np.testing.assert_allclose(Zt.numpy(), Zj, atol=1e-4 * np.abs(Zj).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-4)


def test_cholesky_failure_scores_like_jax():
    """alpha 0 on a design with an all-zero column: G + 0 I is singular, so
    the Cholesky fails. JAX gets NaN factors and scores that alpha 0; the
    port turns cholesky_ex's info into NaN factors and must agree."""
    X, Y, Xt, Yt = _problem(seed=2, zero_col=True)
    alphas = np.array([0.0, 1.0, 10.0, 100.0, 1000.0], np.float32)
    splits = tcv.create_folds(400, "chunked", 5, 20, seed=0)
    mt = tcv._find_best_alphas_chol(torch.as_tensor(X), torch.as_tensor(Y),
                                    splits, torch.as_tensor(alphas), True,
                                    True).numpy()
    mj = np.asarray(jcv._find_best_alphas_chol(X, Y, splits, alphas, True,
                                               True, None))
    assert np.all(mj[0] == 0.0) and np.all(mt[0] == 0.0)
    np.testing.assert_allclose(mt, mj, atol=2e-3)
    kw = dict(chunk_length=20, n_inner_folds=5, alphas=alphas,
              method="chol")
    _assert_parity(tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw),
                   jcv.fit_nested_cv(X, Y, Xt, Yt, **kw))


def test_ties_go_to_the_first_alpha():
    scores = torch.tensor([[0.1, 0.5], [0.3, 0.5], [0.3, 0.2]])
    np.testing.assert_array_equal(
        tcv._select_best_alphas(scores, np.array([1.0, 2.0, 3.0]), False),
        [2.0, 1.0])


@pytest.mark.parametrize("kwargs", [
    dict(X_test=None, y_test=None, voxel_chunk_size=8),
    dict(voxel_chunk_size=8),
    dict(fast_scan=True),
    dict(fast_scan="auto"),
    dict(X_test=None, y_test=None, fast_scan=True),
    dict(n_devices=2),
    dict(significance="permutation"),
    dict(method="eigh"),
    dict(method="svd"),
    dict(normalpha=False),
    dict(X_test=None, y_test=None, method="eigh"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_paths_raise(kwargs):
    """Every argument here once raised and now runs the JAX package's
    route: the same solver_paths and alphas, correlations within 2e-3
    (n_devices=2: two CPU mesh entries against JAX's 2-device mesh)."""
    X, Y, Xt, Yt = _problem(T=100, D=5, V=3, Tp=20)
    kw = dict(X_test=Xt, y_test=Yt, chunk_length=10)
    kw.update(kwargs)
    mt, _, at = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    mj, _, aj = jcv.fit_nested_cv(X, Y, **kw)
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert mt.get("significance_method") == mj.get("significance_method")


def test_invalid_arguments_raise_value_error():
    X, Y, Xt, Yt = _problem(T=100, D=5, V=3, Tp=20)
    for bad in (dict(method="qr"), dict(significance="bootstrap"),
                dict(fast_scan="yes")):
        with pytest.raises(ValueError):
            tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **bad)


@pytest.mark.parametrize("fold_type,n", [("chunked", 403),
                                         ("chunked_contiguous", 400)])
def test_folds_identical_to_jax(fold_type, n):
    from litcoder_core_tpu.models.folding import create_folds as jfolds

    for seed in (0, 7):
        got = tcv.create_folds(n, fold_type, 5, 20, seed=seed)
        want = jfolds(n, fold_type, 5, 20, seed=seed)
        assert len(got) == len(want)
        for (gt, gv), (wt, wv) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)

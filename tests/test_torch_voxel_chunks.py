"""Port parity for voxel_chunk_size streaming, in both modes: the port on the
CPU against the JAX package and against its own unchunked fit, on the
problems of tests/test_nested_cv.py:71-208 (T=300-400, D=8, V=20-25,
chunks of 6-7 voxels that leave a tail).

Bars: chunked and unchunked fits select identical alphas, correlations
within 1e-5 and weights within 1e-5 (the same products, column by column);
against the JAX package identical alphas and correlations within 2e-3;
the chunked pieces within 2e-4 of their JAX twins."""

import numpy as np
import pytest
import torch

from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_tpu.models import nested_cv as jcv

torch.set_num_threads(2)


def _synthetic(seed, T=400, D=8, V=30, noise=0.5, n_signal=20, Tp=80):
    """V voxels, the first n_signal carrying a linear signal; a noise-only
    test set as in the JAX tests."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    wt = np.zeros((D, V), np.float32)
    wt[:, :n_signal] = rng.normal(size=(D, min(n_signal, V)))
    Y = (X @ wt + noise * rng.normal(size=(T, V))).astype(np.float32)
    Xte = rng.normal(size=(Tp, D)).astype(np.float32)
    Yte = rng.normal(size=(Tp, V)).astype(np.float32)
    return X, Y, Xte, Yte


def _assert_same_fit(a, b, atol=1e-5):
    (ma, wa, aa), (mb, wb, ab) = a, b
    np.testing.assert_array_equal(aa, ab)
    np.testing.assert_allclose(ma["correlations"], mb["correlations"],
                               atol=atol)
    assert ma["solver_paths"] == mb["solver_paths"]
    if wb is not None:
        np.testing.assert_allclose(wa, wb, atol=atol)


@pytest.mark.parametrize("method", ["auto", "eigh", "svd", "dual"])
def test_voxel_chunking_matches_unchunked(method):
    X, Y, Xte, Yte = _synthetic(1, T=300, V=25)
    kw = dict(seed=0, method=method)
    whole = tcv.fit_nested_cv(X, Y, Xte, Yte, device="cpu", **kw)
    chunked = tcv.fit_nested_cv(X, Y, Xte, Yte, device="cpu",
                                voxel_chunk_size=7, **kw)
    _assert_same_fit(chunked, whole)
    want = jcv.fit_nested_cv(X, Y, Xte, Yte, voxel_chunk_size=7, **kw)
    np.testing.assert_array_equal(chunked[2], want[2])
    np.testing.assert_allclose(chunked[0]["correlations"],
                               want[0]["correlations"], atol=2e-3)
    assert chunked[0]["solver_paths"] == want[0]["solver_paths"]


def test_complement_path_matches_svd_path():
    """method='eigh' (complement-gram eigh) against method='svd' (spectral
    svd), as tests/test_nested_cv.py:131 holds the JAX package."""
    X, Y, Xte, Yte = _synthetic(2, V=20)
    kw = dict(seed=0, chunk_length=20)
    fast = tcv.fit_nested_cv(X, Y, Xte, Yte, method="eigh", device="cpu",
                             **kw)
    ref = tcv.fit_nested_cv(X, Y, Xte, Yte, method="svd", device="cpu", **kw)
    assert fast[0]["solver_paths"]["alpha_search"] == "complement_eigh"
    assert ref[0]["solver_paths"]["alpha_search"] == "spectral_svd"
    np.testing.assert_array_equal(fast[2], ref[2])
    np.testing.assert_allclose(fast[0]["correlations"],
                               ref[0]["correlations"], atol=2e-3)
    np.testing.assert_allclose(fast[1], ref[1], atol=3e-3)


def test_complement_path_with_voxel_chunking():
    X, Y, Xte, Yte = _synthetic(3, V=23)
    whole = tcv.fit_nested_cv(X, Y, Xte, Yte, seed=0, method="eigh",
                              device="cpu")
    chunked = tcv.fit_nested_cv(X, Y, Xte, Yte, seed=0, method="eigh",
                                voxel_chunk_size=6, device="cpu")
    _assert_same_fit(chunked, whole)


@pytest.mark.parametrize("method", ["auto", "eigh"])
def test_use_corr_false_chunked_matches_jax(method):
    X, Y, Xte, Yte = _synthetic(4, T=300, V=10, n_signal=10)
    kw = dict(use_corr=False, seed=0, voxel_chunk_size=4, method=method)
    got = tcv.fit_nested_cv(X, Y, Xte, Yte, device="cpu", **kw)
    want = jcv.fit_nested_cv(X, Y, Xte, Yte, **kw)
    assert got[0]["solver_paths"] == want[0]["solver_paths"]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0]["correlations"],
                               want[0]["correlations"], atol=2e-3)
    assert np.isfinite(got[0]["median_score"])


@pytest.mark.parametrize("chunk", [None, 3])
def test_constant_voxel_targets_no_nans(chunk):
    """A zero-variance voxel yields r = 0, p = 1 and no NaN, chunked or
    not (tests/test_nested_cv.py:184)."""
    rng = np.random.default_rng(0)
    T, D, V = 160, 5, 8
    X = rng.normal(size=(T, D)).astype(np.float32)
    Y = (X @ rng.normal(size=(D, V)) + rng.normal(size=(T, V))).astype(
        np.float32)
    Y[:, 3] = 2.5
    Xte = rng.normal(size=(40, D)).astype(np.float32)
    Yte = (Xte @ rng.normal(size=(D, V))).astype(np.float32)
    Yte[:, 3] = 2.5
    m, w, a = tcv.fit_nested_cv(X, Y, Xte, Yte, chunk_length=10,
                                n_inner_folds=3, voxel_chunk_size=chunk,
                                device="cpu")
    corr = np.asarray(m["correlations"])
    pv = np.asarray(m["p_values"])
    assert np.isfinite(corr).all() and np.isfinite(pv).all()
    assert corr[3] == 0.0 and pv[3] == 1.0
    assert np.isfinite(w).all()


@pytest.mark.parametrize("return_weights", [True, False])
def test_fused_full_cv_chunked_matches_whole_and_jax(return_weights):
    """The fused route with a voxel chunk: chunked downdate, chunked inner
    scoring and (without weights) the chunked refit, against the unchunked
    fused fit and the JAX chunked fit. 810 rows leave a remainder outside
    every fold; V=25 in chunks of 7 leaves a tail of 4."""
    X, Y, _, _ = _synthetic(5, T=810, V=25)
    kw = dict(chunk_length=20, n_outer_folds=4, n_inner_folds=3, seed=2,
              return_weights=return_weights)
    whole = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    chunked = tcv.fit_nested_cv(X, Y, device="cpu", voxel_chunk_size=7,
                                **kw)
    assert chunked[0]["solver_paths"]["mode"] == "full_cv_fused"
    _assert_same_fit(chunked, whole)
    want = jcv.fit_nested_cv(X, Y, voxel_chunk_size=7, **kw)
    np.testing.assert_array_equal(chunked[2], want[2])
    np.testing.assert_allclose(chunked[0]["correlations"],
                               want[0]["correlations"], atol=2e-3)
    assert chunked[0]["n_majority_significant"] == \
        want[0]["n_majority_significant"]


def test_per_fold_full_cv_chunked_matches_whole():
    X, Y, _, _ = _synthetic(6, T=300, D=60, V=25)
    kw = dict(folding_type="kfold_trimmed", chunk_length=20, n_outer_folds=3,
              n_inner_folds=3)
    whole = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    chunked = tcv.fit_nested_cv(X, Y, device="cpu", voxel_chunk_size=6, **kw)
    assert chunked[0]["solver_paths"]["mode"] == "full_cv_per_fold"
    _assert_same_fit(chunked, whole)


def test_chunked_downdate_and_refit_match_jax():
    """_downdate_outer in voxel chunks against the whole downdate and the
    JAX chunked downdate (with its tail dispatch); the chunked refit
    against the whole refit and the JAX chunked refit."""
    X, Y, _, _ = _synthetic(7, T=400, D=12, V=23)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    tr, te = tcv.create_folds(400, "chunked", 4, 20, seed=0)[1]
    tte = torch.as_tensor(te)
    G, XtY = tX.T @ tX, tX.T @ tY
    G_w, XtY_w = tcv._downdate_outer(tX, tY, G, XtY, tte)
    G_c, XtY_c = tcv._downdate_outer(tX, tY, G, XtY, tte, 5)
    np.testing.assert_allclose(XtY_c.numpy(), XtY_w.numpy(), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(G_c.numpy(), G_w.numpy())
    Gj, XtYj = jcv._downdate_outer_chunked(
        X, Y, jcv._full_gram(X), jcv._xty(X, Y), te, 5, 4)
    XtYj = jcv._downdate_xty_tail(XtYj, X, Y, te, 20, 3)
    np.testing.assert_allclose(XtY_c.numpy(), np.asarray(XtYj), rtol=1e-4,
                               atol=1e-3)
    valphas = np.geomspace(0.1, 1e3, 23).astype(np.float32)
    tva = torch.as_tensor(valphas)
    w_w, c_w, _ = tcv._refit_score_from_gram(G_w, XtY_w, tX[tte], tY, tte,
                                             tva, 1e-10, True, True)
    w_c, c_c, p_c = tcv._refit_score_from_gram(G_c, XtY_c, tX[tte], tY, tte,
                                               tva, 1e-10, True, True,
                                               chunk=5)
    assert p_c is None
    np.testing.assert_allclose(c_c.numpy(), c_w.numpy(), atol=1e-5)
    np.testing.assert_allclose(w_c, w_w, atol=1e-5)
    cj, _ = jcv._refit_score_from_gram_chunks(Gj, XtYj, X[te], Y, te,
                                              valphas, 1e-10, True, 5, 4)
    np.testing.assert_allclose(c_c.numpy()[:20], np.asarray(cj), atol=2e-4)


@pytest.mark.parametrize("form", ["gather", "complement", "gram", "dual"])
def test_score_fold_voxel_chunks_matches_jax(form):
    """Every form of the one chunked fold scorer against the JAX kernel
    (full chunks plus the tail dispatch there; one loop here). The dual
    form gets a wide design: the kernel of a tall one is rank-deficient."""
    X, Y, _, _ = _synthetic(8, T=240, D=300 if form == "dual" else 10, V=17)
    alphas = np.logspace(-1, 3, 4).astype(np.float32)
    tX, tY, ta = (torch.as_tensor(a) for a in (X, Y, alphas))
    tr, va = tcv.create_folds(240, "chunked", 4, 20, seed=0)[0]
    lo = tr[-9:]
    ttr, tva, tlo = (torch.as_tensor(a) for a in (tr, va, lo))
    extra = {}
    if form == "dual":
        K = X @ X.T
        Zj = jcv._dual_fold_factors(K, tr, va, alphas, True)
        Zt = tcv._dual_fold_factors(tX @ tX.T, ttr, tva, ta, True)
    elif form == "gram":
        XtY_base = np.array(jcv._xty(X, Y))
        extra = dict(lo=lo, XtY_base=XtY_base)
        G = X.T @ X - X[va].T @ X[va] - X[lo].T @ X[lo]
        Zj, _ = jcv._chol_factors_from_gram(G, X[va], alphas, True)
        Zt, _ = tcv._chol_factors_from_gram(torch.as_tensor(G), tX[tva], ta,
                                            True)
    else:
        G = X[tr].T @ X[tr] if form == "gather" else X.T @ X - X[va].T @ X[va]
        Zj, _ = jcv._chol_factors_from_gram(G, X[va], alphas, True)
        Zt, _ = tcv._chol_factors_from_gram(torch.as_tensor(G), tX[tva], ta,
                                            True)
    Zj = np.asarray(Zj)
    want = np.concatenate([
        np.asarray(jcv._score_fold_voxel_chunks(
            Zj, Y, True, c, n, off, False, form=form, X=X, tr=tr, va=va,
            **extra))
        for c, n, off in ((5, 3, 0), (2, 1, 15))], axis=1)
    textra = {k: torch.as_tensor(v) for k, v in
              dict(lo=lo, XtY_base=extra.get("XtY_base")).items()
              if k in extra}
    got = tcv._score_fold_voxel_chunks(Zt, tY, True, 5, False, form=form,
                                       X=tX, tr=ttr, va=tva, **textra)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)

"""Port parity for litcoder_core_torch.models.ridge against the JAX
package's ridge.py. Only invariant outputs are compared (spectra, weights,
predictions, scores), never eigenvectors, whose signs vary. Tolerances are
relative to float32 eigensolves of small, well-conditioned designs."""

import numpy as np
import pytest
import torch

from litcoder_core_tpu.models import ridge as jr
from litcoder_core_torch.models import ridge as tr

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _problem(T, D, V=7, Tp=30, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    Y = (X @ rng.normal(size=(D, V)) + rng.normal(size=(T, V))).astype(
        np.float32)
    Xp = rng.normal(size=(Tp, D)).astype(np.float32)
    alphas = np.logspace(-1, 3, V).astype(np.float32)
    return X, Y, Xp, alphas


@pytest.mark.parametrize("method,T,D", [("eigh", 80, 12), ("dual", 15, 40),
                                        ("auto", 80, 12), ("auto", 15, 40)])
def test_ridge_svd_spectrum_weights_predictions(method, T, D):
    X, Y, Xp, alphas = _problem(T, D)
    js = jr.ridge_svd(X, Xp, method=method)
    ts = tr.ridge_svd(_t(X), _t(Xp), method=method)
    k = min(T, D)
    np.testing.assert_allclose(ts.S.numpy()[:k], np.asarray(js.S)[:k],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(ts.good.numpy()[:k],
                                  np.asarray(js.good)[:k])
    wj = np.asarray(jr.ridge_fit_from_svd(js, Y, alphas))
    wt = tr.ridge_fit_from_svd(ts, _t(Y), _t(alphas)).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-3, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(tr.predict(_t(Xp), _t(wt)).numpy(),
                               np.asarray(jr.predict(Xp, wt)), atol=1e-4)


def test_ridge_svd_unported_method_raises():
    """'svd' is ported (the all-zero design masks every component, as in
    the JAX package); a method no package knows raises ValueError."""
    got = tr.ridge_svd(torch.zeros((4, 2)), method="svd")
    want = jr.ridge_svd(np.zeros((4, 2), np.float32), method="svd")
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(want.good))
    assert not got.good.any()
    with pytest.raises(ValueError, match="method"):
        tr.ridge_svd(torch.zeros((4, 2)), method="qr")


@pytest.mark.parametrize("D,rank", [(30, 30), (30, 12), (3, 3)])
def test_lmax_dense_matches_jax_and_eigh(D, rank):
    rng = np.random.default_rng(D + rank)
    A = rng.normal(size=(200, rank)) @ rng.normal(size=(rank, D))
    G = (A.T @ A).astype(np.float32)
    want = float(np.linalg.eigvalsh(G.astype(np.float64))[-1])
    got = float(tr.lmax_dense(_t(G)))
    assert abs(got - float(jr.lmax_dense(G))) <= 1e-4 * want
    assert abs(got - want) <= 1e-4 * want


@pytest.mark.parametrize("use_corr", [True, False])
def test_score_predictions_matches_jax(use_corr):
    rng = np.random.default_rng(6)
    P = rng.normal(size=(40, 9)).astype(np.float32)
    pred = (P + rng.normal(size=P.shape)).astype(np.float32)
    if use_corr:
        pred[:, 3] = 0.5  # constant prediction -> NaN -> 0
    zP = jr.zscore(P, axis=0)
    Pvar = np.var(P, axis=0, ddof=1)
    want = np.asarray(jr._score_predictions(pred, P, zP, Pvar, use_corr))
    tP = _t(P)
    got = tr._score_predictions(_t(pred), tP, tr.zscore(tP, dim=0),
                                use_corr).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if use_corr:
        assert got[3] == 0.0


# --- ROADMAP C: the Lanczos breakdown on a rank-deficient kernel -------------


def _roadmap_c_problem():
    """tests/test_torch_full_cv.py's _problem(400, 30, 20, seed=13) with
    X = 3X + 2 (rank 30 plus a dominant mean direction), a test set from
    seed 14, and inner chunked folds of 20 rows (5 folds, seed 0)."""
    from tests.test_torch_full_cv import _problem as full_cv_problem

    X, Y = full_cv_problem(400, 30, 20, seed=13)
    Xt, Yt = full_cv_problem(100, 30, 20, seed=14)
    return X * 3.0 + 2.0, Y, Xt * 3.0 + 2.0, Yt


def test_lmax_dense_survives_a_missed_breakdown():
    """On fold 0's 320 x 320 kernel the f32 breakdown test misses the spent
    Krylov space (beta 0.07 against 1e-6 x 41,924) and the junk betas
    overflow; the result must still be lambda-max within 1e-4."""
    from litcoder_core_torch.models import nested_cv as tcv

    X = _roadmap_c_problem()[0]
    tr_idx, _ = tcv.create_folds(400, "chunked", 5, 20, seed=0)[0]
    Xtr = _t(X)[torch.as_tensor(tr_idx)]
    K = Xtr @ Xtr.T
    want = float(torch.linalg.eigvalsh(K.double())[-1])
    assert abs(want - 41924.7) < 0.1
    got = float(tr.lmax_dense(K))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4 * want


def test_dual_fit_on_the_roadmap_c_problem_selects_jax_alphas():
    """The dual fit over folds 0 and 4 of that scheme. Fold 0 is the one
    where the unrepaired port returned NaN; folds 1-3 are left out because
    there the JAX package's own dual factors come out NaN (the fault it
    still has), which scores every alpha 0."""
    from litcoder_core_torch.models import nested_cv as tcv
    from litcoder_core_tpu.models import nested_cv as jcv

    X, Y, Xt, Yt = _roadmap_c_problem()
    folds = tcv.create_folds(400, "chunked", 5, 20, seed=0)
    kw = dict(inner_splits=[folds[0], folds[4]], method="dual")
    mt, _, at = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw)
    mj, _, aj = jcv.fit_nested_cv(X, Y, Xt, Yt, **kw)
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    assert len(set(at.tolist())) > 1   # not the NaN scale's first alpha
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)


@pytest.mark.parametrize("n", [1, 4, 40])
def test_lmax_dense_on_matrices_that_meet_their_bound(n):
    """All-equal row sums make lambda-max equal to the Gershgorin bound (a
    constant matrix), and a diagonal matrix likewise: the repaired result
    stays that of the plain Lanczos there."""
    for G in (np.full((n, n), 2.5, np.float32),
              np.diag(np.linspace(1.0, 9.0, n)).astype(np.float32)):
        want = float(np.linalg.eigvalsh(G.astype(np.float64))[-1])
        got = float(tr.lmax_dense(_t(G)))
        assert abs(got - want) <= 1e-5 * want
        assert abs(got - float(jr.lmax_dense(G))) <= 1e-6 * want


# --- the 'svd' method, the scan core and the one-call wrappers ---------------


@pytest.mark.parametrize("T,D", [(80, 12), (15, 40)])
def test_svd_method_matches_jax(T, D):
    X, Y, Xp, alphas = _problem(T, D)
    js = jr.ridge_svd(X, Xp, method="svd", singcutoff=1e-3)
    ts = tr.ridge_svd(_t(X), _t(Xp), method="svd", singcutoff=1e-3)
    np.testing.assert_allclose(ts.S.numpy(), np.asarray(js.S), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(ts.good.numpy(), np.asarray(js.good))
    wj = np.asarray(jr.ridge_fit_from_svd(js, Y, alphas))
    wt = tr.ridge_fit_from_svd(ts, _t(Y), _t(alphas)).numpy()
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    U, S, Vh, good = tr.svd_masked(_t(X), 1e-3)
    np.testing.assert_allclose((U * S) @ Vh, X, atol=1e-4)


# use_corr=False scores are sqrt(|1 - resvar/var|): where a large alpha
# leaves R^2 at float32 rounding (~1e-7), the square root lifts it to ~5e-4,
# so those scores are held to the fit's 2e-3 bar.


@pytest.mark.parametrize("method", ["svd", "eigh", "dual"])
@pytest.mark.parametrize("use_corr", [True, False])
def test_ridge_corr_and_score_alpha_grid_match_jax(method, use_corr):
    X, Y, Xp, _ = _problem(60, 10, V=9, Tp=25, seed=3)
    rng = np.random.default_rng(4)
    Yp = (Xp @ rng.normal(size=(10, 9)) + rng.normal(size=(25, 9))).astype(
        np.float32)
    alphas = np.logspace(-1, 3, 6).astype(np.float32)
    want = np.asarray(jr.ridge_corr(X, Xp, Y, Yp, alphas, use_corr=use_corr,
                                    normalpha=True, method=method))
    got = tr.ridge_corr(_t(X), _t(Xp), _t(Y), _t(Yp), alphas,
                        use_corr=use_corr, normalpha=True, method=method)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-4 if use_corr else 2e-3)
    svd = tr.ridge_svd(_t(X), _t(Xp), method=method)
    fast = tr.score_alpha_grid(svd.S, svd.good, svd.PVh,
                               tr._ur_product(svd, _t(Y)), _t(Yp),
                               tr._normalize_alphas(alphas, svd, True),
                               use_corr=use_corr, fast_scan=True)
    np.testing.assert_array_equal(fast.numpy(), got.numpy())


@pytest.mark.parametrize("method", ["svd", "eigh"])
def test_ridge_fit_and_corr_pred_wrappers_match_jax(method):
    X, Y, Xp, valphas = _problem(70, 9, V=7, Tp=20, seed=5)
    Yp = np.random.default_rng(6).normal(size=(20, 7)).astype(np.float32)
    for alpha in (3.0, valphas):
        wj = np.asarray(jr.ridge_fit(X, Y, alpha, method=method))
        wt = tr.ridge_fit(_t(X), _t(Y), alpha, method=method).numpy()
        np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    for use_corr in (True, False):
        cj = np.asarray(jr.ridge_corr_pred(X, Xp, Y, Yp, valphas,
                                           use_corr=use_corr, method=method))
        ct = tr.ridge_corr_pred(_t(X), _t(Xp), _t(Y), _t(Yp), valphas,
                                use_corr=use_corr, method=method).numpy()
        np.testing.assert_allclose(ct, cj, atol=2e-4 if use_corr else 2e-3)

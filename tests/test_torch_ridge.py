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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.ridge_svd(torch.zeros((4, 2)), method="svd")


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
    got = tr._score_predictions(
        _t(pred), tP, tr.zscore(tP, dim=0),
        torch.var(tP, dim=0, correction=1), use_corr).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if use_corr:
        assert got[3] == 0.0

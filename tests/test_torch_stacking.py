"""Port parity for stacked regression (litcoder_core_torch.models.stacking
against litcoder_core_tpu.models.stacking) on the CPU: the simplex
projection and the FISTA solver, the out-of-fold refits on both routes
(grouped Cholesky and spectral), the voxel-chunked pipeline against the
port's unchunked fit, the fit without a test set, and the validation
errors.

Problems: two spaces of 20 and 24 features, T=300 training rows in 3
chunked folds of 10-row chunks, 80 test rows, V=30, the first space
carrying most of the signal. Bars: the same best alphas and solver_paths;
stack weights within 1e-4; correlations within 2e-4. On correlated
spaces the blend's optimum is flat, so there the QP objective is compared
(within 1e-6 relative) instead of the weights."""

import numpy as np
import pytest
import torch

import litcoder_core_tpu.models.stacking as js
import litcoder_core_torch.models.stacking as ts
from litcoder_core_torch.models import StackedRidgeModel, fit_stacked_ridge

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 4, 6), n_inner_folds=3, chunk_length=10,
          seed=0)


def two_spaces(seed=3, T=300, Tp=80, dims=(20, 24), V=30, noise=3.0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(d, V)).astype(np.float32) for d in dims]

    def draw(n):
        Xs = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
        Y = Xs[0] @ ws[0] + 0.5 * Xs[1] @ ws[1]
        return Xs, (Y + noise * rng.normal(size=(n, V))).astype(np.float32)

    Xs, Y = draw(T)
    Xts, Yt = draw(Tp)
    return Xs, Y, Xts, Yt


def assert_stacks_match(got, want):
    (mt, wt, at), (mj, wj, aj) = got, want
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    assert set(mt) == set(mj)
    np.testing.assert_allclose(wt, wj, atol=1e-4)
    np.testing.assert_allclose(wt.sum(axis=1), 1.0, atol=1e-5)
    assert wt.min() >= 0.0
    for key in ("stack_weights_mean", "stack_weights_median",
                "stack_dominant_share"):
        np.testing.assert_allclose(mt[key], mj[key], atol=1e-4)
    if "correlations" in mj:
        np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                                   atol=2e-4)
        np.testing.assert_allclose(mt["per_space_test_r"],
                                   mj["per_space_test_r"], atol=2e-4)
        assert mt["best_alphas"] == mj["best_alphas"]


# ---- the QP ------------------------------------------------------------


def test_project_simplex_matches_jax():
    rng = np.random.default_rng(0)
    for s in (2, 3, 5):
        v = rng.normal(scale=3.0, size=(64, s)).astype(np.float32)
        got = ts.project_simplex(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(js.project_simplex(v)),
                                   atol=1e-6)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
        assert got.min() >= 0.0
    w = np.array([[0.2, 0.3, 0.5]], np.float32)   # already feasible
    np.testing.assert_allclose(ts.project_simplex(torch.as_tensor(w)), w,
                               atol=1e-7)


def _qp(P, y):
    A = np.einsum("vts,vtu->vsu", P, P).astype(np.float32)
    b = np.einsum("vts,vt->vs", P, y).astype(np.float32)
    return A, b


def _objective(A, b, w):
    return (np.einsum("vs,vsu,vu->v", w, A, w) - 2 * np.einsum("vs,vs->v", b,
                                                               w))


def test_simplex_lsq_matches_jax_on_independent_spaces():
    rng = np.random.default_rng(1)
    P = rng.normal(size=(40, 50, 3))
    y = P @ np.array([0.6, 0.3, 0.1]) + 0.5 * rng.normal(size=(40, 50))
    A, b = _qp(P, y)
    got = ts.simplex_lsq(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(js.simplex_lsq(A, b)),
                               atol=1e-4)


def test_simplex_lsq_matches_jax_objective_on_correlated_spaces():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(40, 60))
    P = np.stack([base + 0.05 * rng.normal(size=(40, 60)) for _ in range(3)],
                 axis=-1)
    y = base + rng.normal(size=(40, 60))
    A, b = _qp(P, y)
    got = ts.simplex_lsq(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    want = np.asarray(js.simplex_lsq(A, b))
    f_got, f_want = _objective(A, b, got), _objective(A, b, want)
    np.testing.assert_allclose(f_got, f_want, rtol=1e-6,
                               atol=1e-6 * np.abs(f_want).max())
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


# ---- the fit --------------------------------------------------------------

FITS = {
    # name: (fit arguments, oof_refit)
    "grouped_chol": ({}, "grouped_chol"),
    "spectral": (dict(method="eigh"), "spectral"),
    "chunked": (dict(voxel_chunk_size=7), "grouped_chol_chunked"),
    "no test set": (dict(test=False), "grouped_chol"),
}


@pytest.fixture(scope="module")
def fits():
    """(port fit, JAX fit) per case; the chunked case is held to the port's
    unchunked fit (test_chunked_matches_unchunked), which is held to
    JAX's."""
    problem = two_spaces()
    out = {}
    for name, (kw, _) in FITS.items():
        kw = dict(KW, **kw)
        args = problem if kw.pop("test", True) else problem[:2]
        out[name] = (fit_stacked_ridge(*args, device="cpu", **kw),
                     None if name == "chunked"
                     else js.fit_stacked_ridge(*args, **kw))
    return out


@pytest.mark.parametrize("name", [n for n in FITS if n != "chunked"])
def test_fit_matches_jax(fits, name):
    got, want = fits[name]
    assert got[0]["solver_paths"]["oof_refit"] == FITS[name][1]
    assert_stacks_match(got, want)


def test_chunked_matches_unchunked(fits):
    (mc, wc, ac), _ = fits["chunked"]
    (mu, wu, au), want = fits["grouped_chol"]
    assert mc["solver_paths"] == dict(mu["solver_paths"],
                                      oof_refit="grouped_chol_chunked")
    assert set(mc) == set(want[0])
    np.testing.assert_array_equal(ac, au)
    np.testing.assert_allclose(wc, wu, atol=1e-5)
    np.testing.assert_allclose(mc["correlations"], mu["correlations"],
                               atol=1e-5)


def test_stack_identifies_the_generating_space(fits):
    (m, w, alphas), _ = fits["grouped_chol"]
    assert w.shape == (30, 2) and alphas.shape == (2, 30)
    assert m["stack_weights_mean"][0] > 0.6
    assert m["median_score"] >= max(np.median(r)
                                    for r in m["per_space_test_r"]) - 0.02
    assert m["solver_paths"] == {"fast_scan": "off", "alpha_search": "chol",
                                 "oof_refit": "grouped_chol"}


def test_no_test_set_metrics(fits):
    (m, _, _), _ = fits["no test set"]
    assert set(m) == {"solver_paths", "stack_weights_mean",
                      "stack_weights_median", "stack_dominant_share",
                      "stage_seconds"}


def test_pervoxel_refit_matches_jax_and_grouped():
    """The per-voxel-index Cholesky refit (the voxel-sharded route's) on one
    fold: equal to JAX's and to the grouped refit."""
    Xs, Y, _, _ = two_spaces(seed=5)
    alphas = np.logspace(-1, 4, 6).astype(np.float32)
    best_idx = np.random.default_rng(0).integers(0, 6, Y.shape[1])
    X = Xs[0]
    got = ts._pervoxel_chol_pred(torch.as_tensor(X[:200]),
                                 torch.as_tensor(X[200:]),
                                 torch.as_tensor(Y[:200]), alphas,
                                 torch.as_tensor(best_idx), True)
    want = np.asarray(js._pervoxel_chol_pred(X[:200], X[200:], Y[:200],
                                             alphas, best_idx, True))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    grouped = ts._grouped_chol_pred(torch.as_tensor(X[:200]),
                                    torch.as_tensor(X[200:]),
                                    torch.as_tensor(Y[:200]),
                                    alphas[best_idx], True)
    np.testing.assert_allclose(got.numpy(), grouped.numpy(),
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("t_rows,n_vox", [
    (26880, 95556), (25620, 20484), (300, 30), (1_000_000, 20484)])
def test_stacked_chunk_cap_matches_jax(t_rows, n_vox):
    assert (ts._stacked_chunk_cap(t_rows, n_vox)
            == js._stacked_chunk_cap(t_rows, n_vox))


def _bad_calls():
    Xs, Y, Xts, Yt = two_spaces(T=60, Tp=20, V=4)
    return {
        "method": ((Xs, Y), dict(method="cholesky")),
        "one space": ((Xs[:1], Y), {}),
        "X_tests without y_test": ((Xs, Y, Xts), {}),
        "rows": (([Xs[0], Xs[1][:-1]], Y), {}),
        "test space count": ((Xs, Y, Xts[:1], Yt), {}),
        "test space rows": ((Xs, Y, [Xts[0][:-1], Xts[1]], Yt), {}),
        "test space width": ((Xs, Y, [Xts[0][:, :-1], Xts[1]], Yt), {}),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_validation_errors_match_jax(case):
    args, kw = _bad_calls()[case]
    with pytest.raises(ValueError) as want:
        js.fit_stacked_ridge(*args, **kw)
    with pytest.raises(ValueError) as got:
        fit_stacked_ridge(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(n_devices=2)])
def test_mesh_is_not_ported(kw):
    """The mesh is ported: an object that is not a Mesh is refused, and
    n_devices=2 (two CPU entries) gives the JAX package's 2-device mesh
    fit: its picks, simplex weights and solver_paths (pervoxel_chol)."""
    Xs, Y, _, _ = two_spaces(T=60, V=4)
    if "mesh" in kw:
        with pytest.raises(TypeError, match="Mesh"):
            fit_stacked_ridge(Xs, Y, device="cpu", **kw)
        with pytest.raises(TypeError, match="Mesh"):
            StackedRidgeModel(device="cpu", **kw).fit_predict(Xs, Y)
        return
    want = js.fit_stacked_ridge(Xs, Y, **kw)
    assert want[0]["solver_paths"]["oof_refit"] == "pervoxel_chol"
    assert_stacks_match(fit_stacked_ridge(Xs, Y, device="cpu", **kw), want)
    assert_stacks_match(
        StackedRidgeModel(device="cpu", **kw).fit_predict(Xs, Y), want)

"""Port parity for banded ridge (litcoder_core_torch.models.banded against
litcoder_core_tpu.models.banded): the host helpers value for value, the
validation errors and the fit's main routes on seeded numpy problems run
through both packages on the CPU.

Problems: two bands of 24 and 16 features, T=240 training rows in 4
chunked folds of 10-row chunks (Tva=60), 40 test rows; V=23 (< Tva: the
scan solves against s X^T Y) or V=80 (>= Tva: against Xva^T). Bars: the
same best alphas, best gammas and solver_paths; correlations and p-values
within 2e-4; weights within 1e-4 of their largest magnitude; the same
metric keys. Every problem is full-rank with T_tr >= D (ROADMAP.md C: the
port's lmax_dense deliberately differs from JAX's on a missed Krylov
breakdown)."""

import jax
import numpy as np
import pytest
import torch

import litcoder_core_tpu.models.banded as jb
import litcoder_core_torch.models.banded as tb
from litcoder_core_torch.models import BandedRidgeModel, fit_banded_ridge

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 5, 6), n_gammas=4, n_inner_folds=4,
          chunk_length=10, seed=0)


def banded_problem(seed, T=240, dims=(24, 16), V=23, TP=40, noise=0.5):
    """Y = X1 W1 + 0.3 X2 W2 + noise, train and test."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(d, V)).astype(np.float32) / np.sqrt(d)
          for d in dims]
    scale = [1.0] + [0.3] * (len(dims) - 1)

    def draw(n):
        Xs = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
        Y = sum(c * X @ w for c, X, w in zip(scale, Xs, ws))
        return Xs, (Y + noise * rng.normal(size=(n, V))).astype(np.float32)

    Xs, Y = draw(T)
    Xts, Yt = draw(TP)
    return Xs, Y, Xts, Yt


def assert_fits_match(got, want, weights=True):
    (mt, wt, at, gt), (mj, wj, aj, gj) = got, want
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(gt, gj)
    assert set(mt) == set(mj)
    assert mt["best_gammas"] == mj["best_gammas"]
    if "correlations" in mj:
        np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                                   atol=2e-4)
        np.testing.assert_allclose(mt["p_values"], mj["p_values"],
                                   atol=2e-4)
        assert mt["best_alphas"] == mj["best_alphas"]
    if weights:
        assert wt.shape == wj.shape
        np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    else:
        assert wt is None and wj is None


def both(problem, **kw):
    """(port fit on the CPU, JAX fit) on the same inputs."""
    args = dict(KW, **kw)
    return (fit_banded_ridge(*problem, device="cpu", **args),
            jb.fit_banded_ridge(*problem, **args))


# ---- host helpers ---------------------------------------------------------


@pytest.mark.parametrize("n_bands,n_gammas,seed,conc", [
    (2, 10, 0, 1.0), (3, 5, 7, 1.0), (2, 1, 0, 1.0), (4, 20, 3, 0.5)])
def test_sample_gammas_matches_jax(n_bands, n_gammas, seed, conc):
    got = tb.sample_gammas(n_bands, n_gammas, seed, conc)
    np.testing.assert_array_equal(got, jb.sample_gammas(n_bands, n_gammas,
                                                        seed, conc))
    assert got.dtype == np.float32 and got.shape == (n_gammas, n_bands)
    np.testing.assert_array_equal(got[0], np.float32(1.0 / n_bands))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 5000, 20484])
def test_bucket_width_matches_jax(n):
    assert tb._bucket_width(n) == jb._bucket_width(n)
    assert tb._bucket_width(n, 16) == jb._bucket_width(n, 16)


@pytest.mark.parametrize("t_rows,chunk", [
    (26880, 8192), (5376, 8192), (240, 7), (26880, 20), (1_000_000, 4096)])
def test_scan_chunk_cap_matches_jax(t_rows, chunk):
    assert tb._scan_chunk_cap(t_rows, chunk) == jb._scan_chunk_cap(t_rows,
                                                                   chunk)


@pytest.mark.parametrize("a_n,t_va,chunk", [
    (10, 5376, 4608), (10, 5376, 8192), (6, 60, 7), (7, 20000, 4096),
    (10, 5124, 20484)])
def test_scan_alpha_batch_matches_jax(a_n, t_va, chunk):
    assert (tb._scan_alpha_batch(a_n, t_va, chunk)
            == jb._scan_alpha_batch(a_n, t_va, chunk))


# ---- validation -----------------------------------------------------------


def _bad_calls():
    Xs, Y, Xts, Yt = banded_problem(1, T=40, V=3, TP=10)
    return {
        "fast_scan": ((Xs, Y), dict(fast_scan="false")),
        "method": ((Xs, Y), dict(method="cholesky")),
        "significance": ((Xs, Y), dict(significance="fdr")),
        "X_tests without y_test": ((Xs, Y, Xts), {}),
        "Y rows": ((Xs, Y[:-1]), {}),
        "test space count": ((Xs, Y, Xts[:1], Yt), {}),
        "test space rows": ((Xs, Y, [Xts[0][:-1], Xts[1]], Yt), {}),
        "test space width": ((Xs, Y, [Xts[0][:, :-1], Xts[1]], Yt), {}),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_validation_errors_match_jax(case):
    args, kw = _bad_calls()[case]
    with pytest.raises(ValueError) as want:
        jb.fit_banded_ridge(*args, **kw)
    with pytest.raises(ValueError) as got:
        fit_banded_ridge(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(n_devices=2)])
def test_mesh_is_not_ported(kw):
    """The mesh is ported: an object that is not a Mesh is refused, and
    n_devices=2 (two CPU entries) gives the JAX package's 2-device mesh
    fit: its (gamma, alpha) picks and solver_paths (spectral refit)."""
    Xs, Y, _, _ = banded_problem(1, T=40, V=3)
    if "mesh" in kw:
        with pytest.raises(TypeError, match="Mesh"):
            fit_banded_ridge(Xs, Y, device="cpu", **kw)
        with pytest.raises(TypeError, match="Mesh"):
            BandedRidgeModel(device="cpu", **kw).fit_predict(Xs, Y)
        return
    want = jb.fit_banded_ridge(Xs, Y, **kw)
    assert want[0]["solver_paths"]["banded_refit"] == "spectral"
    assert_fits_match(fit_banded_ridge(Xs, Y, device="cpu", **kw), want)
    assert_fits_match(
        BandedRidgeModel(device="cpu", **kw).fit_predict(Xs, Y), want)


# ---- the fit's routes -----------------------------------------------------

ROUTES = {
    # name: (problem seed and V, fit arguments, expected solver_paths)
    "chol, V < Tva": ((17, 23), {}, ("chol", "grouped_chol")),
    "chol, V >= Tva": ((18, 80), {}, ("chol", "grouped_chol")),
    "eigh": ((17, 23), dict(method="eigh"), ("eigh", "spectral")),
    "svd_fallback": ((17, 23), dict(method="svd"),
                     ("svd_fallback", "spectral")),
    "normalpha=False": ((17, 23), dict(normalpha=False),
                        ("eigh", "spectral")),
    "unequal folds": ((17, 23), dict(chunk_length=7),
                      ("chol", "grouped_chol")),
    "return_weights=False": ((18, 80), dict(return_weights=False),
                             ("chol", "grouped_chol")),
    "return_weights=False, spectral": ((17, 23), dict(
        return_weights=False, method="eigh"), ("eigh", "spectral")),
    "no test set": ((17, 23), dict(test=False), ("chol", "grouped_chol")),
}


@pytest.fixture(scope="module")
def route_fits():
    problems = {}
    out = {}
    for name, ((seed, V), kw, _) in ROUTES.items():
        kw = dict(kw)
        problem = problems.setdefault((seed, V), banded_problem(seed, V=V))
        if not kw.pop("test", True):
            problem = problem[:2]
        out[name] = both(problem, **kw)
    return out


@pytest.mark.parametrize("name", list(ROUTES))
def test_routes_match_jax(route_fits, name):
    got, want = route_fits[name]
    scan, refit = ROUTES[name][2]
    assert got[0]["solver_paths"] == {"banded_scan": scan,
                                      "banded_refit": refit}
    assert_fits_match(got, want,
                      weights=ROUTES[name][1].get("return_weights", True))


def test_chol_fit_recovers_the_first_band(route_fits):
    (m, w, alphas, gammas), _ = route_fits["chol, V >= Tva"]
    assert m["median_score"] > 0.8
    assert gammas.shape == (80, 2) and alphas.shape == (80,)
    np.testing.assert_allclose(gammas.sum(axis=1), 1.0, atol=1e-6)
    # The signal's first band carries more variance than the second.
    assert np.median(gammas[:, 0]) > np.median(gammas[:, 1])
    assert set(m["stage_seconds"]) == {"scan", "refit", "test_scoring"}


def test_no_test_set_metrics(route_fits):
    (m, w, _, _), _ = route_fits["no test set"]
    assert set(m) == {"best_gammas", "solver_paths", "stage_seconds"}
    assert w.shape == (40, 23)


# ---- permutation significance ----------------------------------------------


def test_permutation_pvalues_equal_jax(monkeypatch):
    """The port's offset draw is fed JAX's (randint of PRNGKey(seed), one
    draw for all voxels): the p-values must then be equal."""
    calls = []

    def draw(seed, fold_idx, n_permutations, n_samples):
        calls.append((seed, fold_idx, n_permutations, n_samples))
        return torch.as_tensor(np.array(jax.random.randint(
            jax.random.PRNGKey(seed), (n_permutations,), 1, n_samples)))

    monkeypatch.setattr(tb, "_permutation_offsets", draw)
    problem = banded_problem(19, V=23)
    got, want = both(problem, significance="permutation",
                     n_permutations=200, seed=3)
    assert calls == [(3, None, 200, 40)]
    assert_fits_match(got, want)
    assert got[0]["p_values"] == want[0]["p_values"]
    assert got[0]["significance_method"] == "permutation"
    assert min(got[0]["p_values"]) == pytest.approx(1 / 201)


"""Port parity for every alpha-search path of fit_nested_cv: the port on the
CPU against the JAX package on the problem of tests/test_solver_path_matrix.py
(T=180, D=8, V=13; a wide twin with D=150), across method x voxel chunking x
mode x fast_scan, plus the gates that send 'auto' off the Cholesky search.

Bars: the same metrics['solver_paths'] as the JAX fit, identical selected
alphas, correlations within 2e-3 and weights within 5e-3 (README's solver
parity); across paths of the port, its own selections agree as the JAX
package's do."""

import numpy as np
import pytest
import torch

from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_tpu.models import nested_cv as jcv

torch.set_num_threads(2)

T, TP, D, V = 180, 48, 8, 13
WIDE_D = 150  # > the 120 inner train rows: dual territory
ALPHAS = np.logspace(-1, 3, 5)
KW = dict(alphas=ALPHAS, chunk_length=6, n_inner_folds=3, seed=0)

rng = np.random.default_rng(7)
X = rng.normal(size=(T, D)).astype(np.float32)
WT = rng.normal(size=(D, V)).astype(np.float32)
Y = (X @ WT + 0.5 * rng.normal(size=(T, V))).astype(np.float32)
X_TEST = rng.normal(size=(TP, D)).astype(np.float32)
Y_TEST = (X_TEST @ WT + 0.5 * rng.normal(size=(TP, V))).astype(np.float32)
X_WIDE = rng.normal(size=(T, WIDE_D)).astype(np.float32)
WT_W = (rng.normal(size=(WIDE_D, V)) / np.sqrt(WIDE_D)).astype(np.float32)
Y_WIDE = (X_WIDE @ WT_W + 0.5 * rng.normal(size=(T, V))).astype(np.float32)
XT_WIDE = rng.normal(size=(TP, WIDE_D)).astype(np.float32)
YT_WIDE = (XT_WIDE @ WT_W + 0.5 * rng.normal(size=(TP, V))).astype(
    np.float32)

_cache = {}


def _fit(pkg, *args, **kw):
    key = (pkg, len(args), args[0] is X_WIDE,
           tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _cache:
        if pkg == "torch":
            _cache[key] = tcv.fit_nested_cv(*args, device="cpu", **kw)
        else:
            _cache[key] = jcv.fit_nested_cv(*args, **kw)
    return _cache[key]


def _both(*args, **kw):
    return _fit("torch", *args, **kw), _fit("jax", *args, **kw)


def _assert_parity(got, want, weights=True):
    (mt, wt, at), (mj, wj, aj) = got, want
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert mt["n_significant"] == mj["n_significant"]
    if weights and wj is not None:
        np.testing.assert_allclose(wt, wj, atol=5e-3)


TT_EXPECT = {"auto": "chol", "chol": "chol", "eigh": "complement_eigh",
             "svd": "spectral_svd", "dual": "dual"}


@pytest.mark.parametrize("method", sorted(TT_EXPECT))
@pytest.mark.parametrize("chunk", [None, 5])
def test_train_test_matrix(method, chunk):
    got, want = _both(X, Y, X_TEST, Y_TEST, method=method,
                      voxel_chunk_size=chunk, **KW)
    assert got[0]["solver_paths"] == {"mode": "train_test",
                                      "alpha_search": TT_EXPECT[method],
                                      "fast_scan": "off"}
    _assert_parity(got, want)
    # Every path of the port selects what its svd path selects.
    ref = _fit("torch", X, Y, X_TEST, Y_TEST, method="svd", **KW)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], atol=5e-3)


@pytest.mark.parametrize("method,expected", [
    ("auto", "dual"), ("dual", "dual"), ("svd", "spectral_svd"),
    ("eigh", "complement_eigh"),
])
@pytest.mark.parametrize("chunk", [None, 5])
def test_train_test_wide_matrix(method, expected, chunk):
    """Wide folds: 'auto' takes the dual search, 'svd' the per-fold spectral
    states, and 'eigh' the complement-gram eigh of a rank-deficient Gram
    (its gate reads the method and the fold structure, not the width)."""
    got, want = _both(X_WIDE, Y_WIDE, XT_WIDE, YT_WIDE, method=method,
                      voxel_chunk_size=chunk, **KW)
    assert got[0]["solver_paths"]["alpha_search"] == expected
    _assert_parity(got, want)


FULL_EXPECT = {
    "auto": ("full_cv_fused", "fused_chol"),
    "chol": ("full_cv_fused", "fused_chol"),
    "eigh": ("full_cv_per_fold", "per_fold_loop_eigh"),
    "svd": ("full_cv_per_fold", "per_fold_loop_svd"),
    "dual": ("full_cv_per_fold", "dual"),
}


@pytest.mark.parametrize("method", sorted(FULL_EXPECT))
@pytest.mark.parametrize("chunk", [None, 5])
def test_full_cv_matrix(method, chunk):
    """Inner folds of the 120 outer-train rows have unequal shapes, so the
    spectral methods take the per-fold loop."""
    got, want = _both(X, Y, method=method, voxel_chunk_size=chunk,
                      n_outer_folds=3, **KW)
    mode, search = FULL_EXPECT[method]
    assert got[0]["solver_paths"]["mode"] == mode
    assert got[0]["solver_paths"]["alpha_search"] == search
    _assert_parity(got, want)
    assert (got[0]["n_majority_significant"]
            == want[0]["n_majority_significant"])
    ref = _fit("torch", X, Y, method=method, n_outer_folds=3, **KW)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0]["correlations"], ref[0]["correlations"],
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["train_test", "full_cv"])
@pytest.mark.parametrize("fast_scan", [True, "auto"])
def test_fast_scan_matrix(mode, fast_scan):
    """On the CPU TF32 changes nothing (as JAX's default precision is fp32
    there): the fast scan records 'bf16' or 'auto_accepted' like the JAX
    package and selects exactly the fp32 alphas."""
    args = (X, Y, X_TEST, Y_TEST) if mode == "train_test" else (X, Y)
    extra = {} if mode == "train_test" else dict(n_outer_folds=3)
    got, want = _both(*args, fast_scan=fast_scan, **extra, **KW)
    assert got[0]["solver_paths"]["fast_scan"] == (
        "bf16" if fast_scan is True else "auto_accepted")
    _assert_parity(got, want)
    fp32 = _fit("torch", *args, **extra, **KW)
    np.testing.assert_array_equal(got[2], fp32[2])
    np.testing.assert_allclose(got[0]["correlations"],
                               fp32[0]["correlations"], atol=1e-5)


def _mixed_folds():
    """Inner folds of unequal width: one train block taller than D=100, one
    narrower, so neither the Cholesky nor the dual gate holds for 'auto'."""
    return [(np.arange(0, 120), np.arange(120, 180)),
            (np.arange(100, 180), np.arange(0, 100))]


@pytest.mark.parametrize("case", [
    "normalpha_false", "singcutoff", "small_alpha", "mixed_folds",
    "normalpha_false_unequal",
])
def test_auto_gates_route_like_jax(case):
    """The arguments that send 'auto' off the eigensolve-free searches:
    normalpha=False, singcutoff > 1e-10, an alpha under 0.03 (complement
    eigh on these equal partition-union folds), folds mixing tall and wide
    (per-fold loop), and normalpha=False on unequal folds."""
    Xd, Yd, Xt, Yt = X, Y, X_TEST, Y_TEST
    kw = dict(KW)
    if case == "normalpha_false":
        kw["normalpha"] = False
    elif case == "singcutoff":
        kw["singcutoff"] = 1e-3
    elif case == "small_alpha":
        kw["alphas"] = np.array([0.01, 0.3, 10.0, 300.0])
    elif case == "mixed_folds":
        Xd, Xt = X_WIDE[:, :100], XT_WIDE[:, :100]
        Yd, Yt = Y_WIDE, YT_WIDE
        kw["inner_splits"] = _mixed_folds()
    else:
        kw["normalpha"] = False
        kw["chunk_length"] = 7  # 180 rows in chunks of 7: unequal folds
    got, want = _both(Xd, Yd, Xt, Yt, **kw)
    expected = {"normalpha_false": "complement_eigh",
                "singcutoff": "complement_eigh",
                "small_alpha": "complement_eigh",
                "mixed_folds": "per_fold_loop_auto",
                "normalpha_false_unequal": "per_fold_loop_auto"}[case]
    assert want[0]["solver_paths"]["alpha_search"] == expected
    _assert_parity(got, want)


def test_spectral_states_and_complement_scores_match_jax():
    """The pieces: the complement-eigh fold states' spectra and scores, and
    the per-fold spectral scores, against the JAX functions."""
    splits = tcv.create_folds(T, "chunked", 3, 6, seed=0)
    va_idx = np.stack([va for _, va in splits])
    tr_idx = np.stack([tr for tr, _ in splits])
    union = np.arange(T)
    alphas = ALPHAS.astype(np.float32)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    ta = torch.as_tensor(alphas)
    sj = jcv._fold_states_complement(X, union, va_idx, 1e-10)
    st = tcv._fold_states_complement(tX, torch.as_tensor(union),
                                     torch.as_tensor(va_idx), 1e-10)
    np.testing.assert_allclose(st[0].numpy(), np.asarray(sj[0]), rtol=1e-4)
    cj = np.asarray(jcv._score_whole_complement(sj, X, Y, union, va_idx,
                                                alphas, True, True))
    ct = tcv._score_all_complement(st, tX, tY, None,
                                   torch.as_tensor(va_idx), ta, True, True,
                                   None).numpy()
    np.testing.assert_allclose(ct, cj, atol=2e-4)
    for method in ("eigh", "svd"):
        statj = jcv._fold_spectral_states(X, tr_idx, va_idx, 1e-10, method)
        pj = np.asarray(jcv._score_chunk_with_states(
            statj, Y, tr_idx, va_idx, alphas, True, True))
        statt = tcv._fold_spectral_states(tX, torch.as_tensor(tr_idx),
                                          torch.as_tensor(va_idx), 1e-10,
                                          method)
        pt = tcv._score_chunk_with_states(
            statt, tY, torch.as_tensor(tr_idx), torch.as_tensor(va_idx), ta,
            True, True).numpy()
        np.testing.assert_allclose(pt, pj, atol=2e-4)


@pytest.mark.parametrize("method", ["eigh", "svd", "dual"])
def test_refit_follows_method_like_jax(method):
    """_fit_and_score factors X_train with `method` (chol/dual searches
    refit on 'auto'); weights and held-out scores match the JAX refit."""
    valphas = np.geomspace(0.1, 100.0, V).astype(np.float32)
    wj, cj, pj = jcv._fit_and_score(X, Y, X_TEST, Y_TEST, valphas, True,
                                    1e-10, None, method)
    wt, ct, pt = tcv._fit_and_score(*(torch.as_tensor(a) for a in
                                      (X, Y, X_TEST, Y_TEST)), valphas, True,
                                    1e-10, 4, method)
    wj = np.asarray(wj)
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(ct, np.asarray(cj), atol=2e-4)
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=1e-3, atol=1e-12)

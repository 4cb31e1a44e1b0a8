"""Port parity for significance='permutation' (the contract of
tests/test_significance.py and tests/test_stats.py:109-143): the port's
offset draw (nested_cv._permutation_offsets) is fed the JAX package's own
draws, jax.random.randint(fold_in(PRNGKey(seed), fold_idx), (n,), 1, T)
(PRNGKey(seed) itself in train/test mode), and the p-values must then equal
the JAX package's exactly, in both modes, chunked or not. Problems: T=240-300,
D=8, V=20 (seeded numpy)."""

import jax
import numpy as np
import pytest
import torch

from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.ops import stats as tstats
from litcoder_core_tpu.models import nested_cv as jcv
from litcoder_core_tpu.ops import stats as jstats

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 3, 5), chunk_length=10, n_inner_folds=3,
          seed=0)


def _problem(T=240, Tp=80, D=8, V=20, noise=0.5, seed=77, n_null=0):
    """Y = X W + noise; the last n_null voxels carry no signal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    wt = rng.normal(size=(D, V)).astype(np.float32)
    wt[:, V - n_null:] = 0.0
    Y = (X @ wt + noise * rng.normal(size=(T, V))).astype(np.float32)
    X_test = rng.normal(size=(Tp, D)).astype(np.float32)
    Y_test = (X_test @ wt + noise * rng.normal(size=(Tp, V))).astype(
        np.float32)
    return X, Y, X_test, Y_test


def _jax_offsets(seed, fold_idx, n_permutations, n_samples):
    key = jax.random.PRNGKey(seed)
    if fold_idx is not None:
        key = jax.random.fold_in(key, fold_idx)
    return torch.as_tensor(np.array(
        jax.random.randint(key, (n_permutations,), 1, n_samples)))


@pytest.fixture
def jax_draws(monkeypatch):
    calls = []

    def draw(*args):
        calls.append(args)
        return _jax_offsets(*args)

    monkeypatch.setattr(tcv, "_permutation_offsets", draw)
    return calls


@pytest.mark.parametrize("chunk", [None, 7])
def test_train_test_pvalues_equal_jax(jax_draws, chunk):
    X, Y, Xt, Yt = _problem(n_null=10)
    kw = dict(KW, significance="permutation", n_permutations=200,
              voxel_chunk_size=chunk)
    got = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw)
    want = jcv.fit_nested_cv(X, Y, Xt, Yt, **kw)
    assert jax_draws == [(0, None, 200, 80)]   # one draw for all chunks
    np.testing.assert_array_equal(got[0]["p_values"], want[0]["p_values"])
    assert got[0]["significance_method"] == "permutation"
    assert got[0]["n_significant"] == want[0]["n_significant"]
    p = np.asarray(got[0]["p_values"])
    assert p.min() < 0.05 < p.max()           # a tail that is not all floor


@pytest.mark.parametrize("route,chunk", [("fused", None), ("fused", 6),
                                         ("per_fold", None)])
def test_full_cv_pvalues_equal_jax(jax_draws, route, chunk):
    X, Y, _, _ = _problem(T=300, n_null=10)
    kw = dict(KW, n_outer_folds=3, significance="permutation",
              n_permutations=100, voxel_chunk_size=chunk)
    if route == "per_fold":
        kw["method"] = "eigh"
    got = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    want = jcv.fit_nested_cv(X, Y, **kw)
    assert got[0]["solver_paths"] == want[0]["solver_paths"]
    assert [c[1] for c in jax_draws] == [0, 1, 2]   # one stream per fold
    np.testing.assert_array_equal(got[0]["p_values"], want[0]["p_values"])
    assert got[0]["n_significant"] == want[0]["n_significant"]
    assert (got[0]["n_majority_significant"]
            == want[0]["n_majority_significant"])


def test_permutation_train_test_mode():
    """Own draws: correlations as in the parametric fit, p floored at
    1/(n+1) (reached by every voxel of this strong signal)."""
    X, Y, Xt, Yt = _problem()
    n_perm = 200
    m_perm, _, _ = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu",
                                     significance="permutation",
                                     n_permutations=n_perm, **KW)
    m_par, _, _ = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **KW)
    np.testing.assert_allclose(m_perm["correlations"], m_par["correlations"],
                               atol=1e-6)
    p = np.asarray(m_perm["p_values"])
    np.testing.assert_allclose(p, 1.0 / (n_perm + 1), atol=1e-6)
    assert m_perm["significance_method"] == "permutation"
    assert "significance_method" not in m_par
    assert m_perm["n_significant"] == Y.shape[1]


def test_permutation_detects_null():
    X, Y, Xt, Yt = _problem(noise=1.0)
    rng = np.random.default_rng(5)
    m, _, _ = tcv.fit_nested_cv(
        X, rng.normal(size=Y.shape).astype(np.float32), Xt,
        rng.normal(size=Yt.shape).astype(np.float32), device="cpu",
        significance="permutation", n_permutations=200, **KW)
    assert np.median(m["p_values"]) > 0.05
    assert m["n_significant"] <= 1


def test_permutation_full_cv_mode():
    X, Y, _, _ = _problem(T=300)
    m, _, _ = tcv.fit_nested_cv(X, Y, device="cpu",
                                significance="permutation",
                                n_permutations=100, n_outer_folds=3, **KW)
    assert m["significance_method"] == "permutation"
    p = np.asarray(m["p_values"])
    assert np.all((p > 0) & (p <= 1))
    assert m["median_score"] > 0.5 and m["n_significant"] > 0


def test_offsets_seeded_per_fold_and_chunks_share_them():
    """The default draw is reproducible, differs between folds and seeds,
    and lies in [1, T); chunked and unchunked fits give the same p."""
    a = tcv._permutation_offsets(0, 1, 500, 80)
    np.testing.assert_array_equal(a, tcv._permutation_offsets(0, 1, 500, 80))
    assert not torch.equal(a, tcv._permutation_offsets(0, 2, 500, 80))
    assert not torch.equal(a, tcv._permutation_offsets(1, 1, 500, 80))
    assert not torch.equal(a, tcv._permutation_offsets(0, None, 500, 80))
    assert int(a.min()) >= 1 and int(a.max()) <= 79
    X, Y, Xt, Yt = _problem(n_null=10)
    kw = dict(KW, significance="permutation", n_permutations=50)
    whole = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw)
    chunked = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu",
                                voxel_chunk_size=3, **kw)
    assert whole[0]["p_values"] == chunked[0]["p_values"]


def test_permutation_pvalues_equal_jax():
    """ops.stats.permutation_pvalues fed the JAX offsets: signal voxels at
    the floor, noise voxels well above it, the same p as the JAX function
    (its null by rolling, the port's by one FFT cross-correlation)."""
    rng = np.random.default_rng(1)
    T, V = 200, 6
    y_true = rng.normal(size=(T, V)).astype(np.float32)
    y_pred = np.concatenate(
        [y_true[:, :3] + 0.3 * rng.normal(size=(T, 3)).astype(np.float32),
         rng.normal(size=(T, 3)).astype(np.float32)], axis=1)
    key = jax.random.PRNGKey(0)
    pj, oj = jstats.permutation_pvalues(y_true, y_pred, key,
                                        n_permutations=200)
    offsets = np.array(jax.random.randint(key, (200,), 1, T))
    pt, ot = tstats.permutation_pvalues(torch.as_tensor(y_true),
                                        torch.as_tensor(y_pred),
                                        torch.as_tensor(offsets))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    assert np.all(pt.numpy()[:3] <= 2 / 201) and np.all(pt.numpy()[3:] > 0.05)


def test_permutation_pvalues_two_sided_equal_jax():
    rng = np.random.default_rng(2)
    y_true = rng.normal(size=(150, 2)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    offsets = torch.as_tensor(np.array(
        jax.random.randint(key, (100,), 1, 150)))
    for two_sided in (False, True):
        pj, _ = jstats.permutation_pvalues(y_true, -y_true, key,
                                           n_permutations=100,
                                           two_sided=two_sided)
        pt, _ = tstats.permutation_pvalues(torch.as_tensor(y_true),
                                           torch.as_tensor(-y_true), offsets,
                                           two_sided=two_sided)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        # One-sided on r: anticorrelation is not significant; two-sided is.
        assert np.all(pt.numpy() <= 2 / 101) == two_sided

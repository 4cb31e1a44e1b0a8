"""Port parity for the fused nested-CV step (parallel/step.py) and its ridge
helpers (score_alpha_grid_woodbury, lmax_downdate, lmax_update): the port on
the CPU against the JAX package on the same seeded numpy problems. Bars:
identical selected alphas, correlations and p-values within 2e-4, weights
within 1e-4 of their max."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from litcoder_core_torch.models import ridge as tridge
from litcoder_core_torch.parallel import step as tstep
from litcoder_core_tpu.models import ridge as jridge
from litcoder_core_tpu.parallel import step as jstep

torch.set_num_threads(2)

D, V = 12, 30
GRID = np.logspace(-1, 8, 10).astype(np.float32)


def _problem(T, d=D, seed=0, Tp=60):
    """X (T, d), Y = X W + noise with voxel gains spread over a decade, and
    a held-out block of Tp rows."""
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(d, V)) * rng.uniform(0.05, 0.5, V)
         / np.sqrt(max(d / 12, 1.0))).astype(np.float32)
    X = rng.normal(size=(T + Tp, d)).astype(np.float32)
    Y = (X @ W + rng.normal(size=(T + Tp, V))).astype(np.float32)
    return X[:T], Y[:T], X[T:], Y[T:]


def _hand_folds(T, n_rows, seed=3):
    """Five val blocks over `n_rows` random rows of T; each fold trains on
    the other blocks. Complementary, but the union misses T - n_rows rows."""
    perm = np.random.default_rng(seed).permutation(T)[:n_rows]
    va = np.sort(perm.reshape(5, -1), axis=1).astype(np.int32)
    tr = np.stack([np.setdiff1d(perm, v) for v in va]).astype(np.int32)
    return tr, va


def _non_complementary(T, chunk=10):
    """equal_size_folds whose train blocks also hold the remainder rows."""
    tr, va = jstep.equal_size_folds(T, 5, chunk, seed=0)
    rem = np.setdiff1d(np.arange(T), va.ravel())
    return np.concatenate([tr, np.broadcast_to(rem, (5, rem.size))],
                          axis=1).astype(np.int32), va


def _run_both(problem, folds, alphas=GRID, **kw):
    X, Y, Xt, Yt = problem
    tr, va = folds
    got = tstep.nested_cv_step(X, Y, Xt, Yt, alphas, tr, va, device="cpu",
                               **kw)
    want = jstep.nested_cv_step(X, Y, Xt, Yt, jnp.asarray(alphas), tr, va,
                                **kw)
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


def _assert_step_parity(got, want):
    (rt, pt, at, wt), (rj, pj, aj, wj) = got, want
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(rt, rj, atol=2e-4)
    np.testing.assert_allclose(pt, pj, atol=2e-4)
    assert wt.shape == wj.shape
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())


# (label, T, d, folds, step kwargs, expected scan, union refit engaged)
ROUTES = [
    ("woodbury, k=7", 407, D, "equal", {}, "woodbury", True),
    ("woodbury, k=0", 400, D, "equal", {}, "woodbury", True),
    ("chol", 407, D, "equal", dict(method="chol"), "chol", False),
    ("eigh", 407, D, "equal", dict(method="eigh"), "eigh", False),
    ("svd", 407, D, "equal", dict(method="svd"), "eigh", False),
    ("non-complementary auto", 407, D, "noncomp", {}, "eigh", False),
    ("non-complementary eigh", 407, D, "noncomp", dict(method="eigh"),
     "eigh", False),
    ("non-complementary svd", 407, D, "noncomp", dict(method="svd"), "eigh",
     False),
    ("wide auto (dual)", 100, 120, "equal", {}, "eigh", False),
    ("dual", 407, D, "equal", dict(method="dual"), "eigh", False),
    ("single_alpha", 407, D, "equal", dict(single_alpha=True), "woodbury",
     True),
    ("use_corr=False", 407, D, "equal", dict(use_corr=False), "woodbury",
     True),
    ("fast_scan=True", 407, D, "equal", dict(fast_scan=True), "woodbury",
     True),
    ("chol, fast_scan=True", 407, D, "equal",
     dict(method="chol", fast_scan=True), "chol", False),
    ("normalpha=False", 407, D, "equal", dict(normalpha=False), "eigh",
     False),
    ("singcutoff=1e-3", 407, D, "equal", dict(singcutoff=1e-3), "eigh",
     False),
    ("union misses 320 of 640 rows", 640, D, "hand", {}, "woodbury", False),
    ("union misses 240 of 640 rows", 640, D, "hand240", {}, "woodbury",
     True),
]


def _folds(kind, T):
    if kind == "equal":
        return jstep.equal_size_folds(T, 5, 10, seed=0)
    if kind == "noncomp":
        return _non_complementary(T)
    return _hand_folds(T, 320 if kind == "hand" else 400)


@pytest.mark.parametrize("label,T,d,kind,kw,scan,union_refit", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_step_matches_jax(label, T, d, kind, kw, scan, union_refit,
                          caplog):
    """Same alphas, scores, p-values and weights as the JAX step; the same
    scan (_resolve_scan_method) and refit (the union refit exactly when the
    JAX gate engages it), as the step's log line reports them."""
    problem = _problem(T, d, seed=len(label))
    folds = _folds(kind, T)
    method = kw.get("method", "auto")
    complement = (method in ("auto", "eigh", "woodbury", "chol")
                  and folds[0].shape[1] >= d
                  and jstep._folds_are_complementary(*folds))
    args = (method, complement, GRID, kw.get("normalpha", True),
            kw.get("singcutoff", 1e-10))
    assert (tstep._resolve_scan_method(*args)
            == jstep._resolve_scan_method(*args) == scan)
    with caplog.at_level(logging.INFO, logger=tstep.__name__):
        got, want = _run_both(problem, folds, **kw)
    _assert_step_parity(got, want)
    logged = [r.getMessage() for r in caplog.records
              if r.name == tstep.__name__]
    assert logged == [
        f"nested_cv_step: {scan if complement else 'per_fold'} scan, "
        f"{'union_woodbury' if union_refit else 'full'} refit"]
    if kw.get("single_alpha"):
        assert np.unique(got[2]).size == 1


def test_gate_refuses_small_alphas_and_routes_to_eigh():
    """A grid with an alpha under 0.03 takes the eigh scan in both packages
    (Woodbury's factor would be ill-conditioned), with the same results."""
    grid = np.logspace(-2, 6, 9).astype(np.float32)
    folds = jstep.equal_size_folds(407, 5, 10, seed=0)
    assert (tstep._resolve_scan_method("auto", True, grid, True)
            == jstep._resolve_scan_method("auto", True, grid, True)
            == "eigh")
    got, want = _run_both(_problem(407), folds, alphas=grid)
    _assert_step_parity(got, want)


def _union_products(X, Y, va):
    union = np.sort(va.ravel())
    Xu = X[union]
    lam, Q = np.linalg.eigh((Xu.T @ Xu).astype(np.float64))
    return (lam.astype(np.float32), Q.astype(np.float32),
            (Xu.T @ Y[union]).astype(np.float32), union)


@pytest.mark.parametrize("T", [407, 400], ids=["k=7", "k=0"])
@pytest.mark.parametrize("normalpha", [True, False])
def test_refit_union_woodbury_matches_jax(T, normalpha):
    X, Y, _, _ = _problem(T, seed=5)
    _, va = jstep.equal_size_folds(T, 5, 10, seed=0)
    lam, Q, XtY_u, union = _union_products(X, Y, va)
    rng = np.random.default_rng(6)
    # A repeated grid value: each voxel takes its first grid match.
    grid = np.concatenate([GRID, GRID[3:4]])
    best = grid[rng.integers(0, grid.size, size=V)]
    want = np.asarray(jstep._refit_union_woodbury(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lam), jnp.asarray(Q),
        jnp.asarray(XtY_u), jnp.asarray(union, jnp.int32), jnp.asarray(best),
        jnp.asarray(grid), normalpha))
    got = tstep._refit_union_woodbury(
        torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(lam),
        torch.as_tensor(Q), torch.as_tensor(XtY_u),
        torch.as_tensor(union, dtype=torch.long), torch.as_tensor(best),
        torch.as_tensor(grid), normalpha).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    full = tstep._refit_full(torch.as_tensor(X), torch.as_tensor(Y),
                             torch.as_tensor(best), normalpha, 1e-10,
                             "auto").numpy()
    np.testing.assert_allclose(got, full, atol=1e-4 * np.abs(full).max())


@pytest.mark.parametrize("which", ["downdate", "update"])
def test_lmax_downdate_and_update_match_jax(which):
    X, _, _, _ = _problem(407, seed=7)
    _, va = jstep.equal_size_folds(407, 5, 10, seed=0)
    union = np.sort(va.ravel())
    Xu = X[union]
    lam, Q = np.linalg.eigh((Xu.T @ Xu).astype(np.float64))
    lam, Q = lam.astype(np.float32), Q.astype(np.float32)
    rows = va[0] if which == "downdate" else np.setdiff1d(np.arange(407),
                                                          union)
    P = (X[rows] @ Q).astype(np.float32)
    jfn, tfn = ((jridge.lmax_downdate, tridge.lmax_downdate)
                if which == "downdate"
                else (jridge.lmax_update, tridge.lmax_update))
    want = float(jfn(jnp.asarray(lam), jnp.asarray(P)))
    got = float(tfn(torch.as_tensor(lam), torch.as_tensor(P)))
    assert abs(got - want) <= 1e-4 * abs(want)
    sign = -1.0 if which == "downdate" else 1.0
    dense = np.linalg.eigvalsh(np.diag(lam.astype(np.float64))
                               + sign * P.T.astype(np.float64) @ P)[-1]
    assert abs(got - dense) <= 1e-4 * dense


@pytest.fixture(scope="module")
def woodbury_fold():
    """(lam, P, UR0, Yva, nal) of fold 0 of a T=400 problem."""
    X, Y, _, _ = _problem(400, seed=8)
    _, va = jstep.equal_size_folds(400, 5, 10, seed=0)
    lam, Q, XtY_u, _ = _union_products(X, Y, va)
    Xva, Yva = X[va[0]], Y[va[0]]
    P = (Xva @ Q).astype(np.float32)
    UR0 = (Q.T @ (XtY_u - Xva.T @ Yva)).astype(np.float32)
    nal = (GRID * np.sqrt(lam.max())).astype(np.float32)
    return lam, P, UR0, Yva, nal


@pytest.mark.parametrize("alpha_batch", [None, 1, 3, GRID.size])
def test_score_alpha_grid_woodbury_batches(woodbury_fold, alpha_batch):
    """Every alpha_batch gives the one-at-a-time scores and the JAX ones."""
    lam, P, UR0, Yva, nal = woodbury_fold
    t = [torch.as_tensor(a) for a in woodbury_fold]
    got = tridge.score_alpha_grid_woodbury(*t, alpha_batch=alpha_batch)
    one = tridge.score_alpha_grid_woodbury(*t, alpha_batch=None)
    assert got.shape == (GRID.size, V)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6)
    want = np.asarray(jridge.score_alpha_grid_woodbury(
        *[jnp.asarray(a) for a in woodbury_fold], alpha_batch=alpha_batch))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


GATE_CASES = [
    ("auto", True, GRID, True, 1e-10),
    ("auto", False, GRID, True, 1e-10),
    ("auto", True, GRID, False, 1e-10),
    ("auto", True, GRID, True, 1e-6),
    ("auto", True, np.array([0.01, 1.0], np.float32), True, 1e-10),
    ("auto", True, np.array([0.03, 1.0], np.float32), True, 1e-10),
    ("auto", True, np.array([], np.float32), True, 1e-10),
    ("eigh", True, GRID, True, 1e-10),
    ("chol", True, GRID, False, 1e-10),
    ("woodbury", True, np.array([0.01], np.float32), True, 1e-10),
    ("svd", False, GRID, True, 1e-10),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=str)
def test_resolve_scan_method_gate_table(case):
    assert (tstep._resolve_scan_method(*case)
            == jstep._resolve_scan_method(*case))


@pytest.mark.parametrize("shape,want", [
    ((5, 800, 20484, 10), 6), ((5, 800, 95556, 10), 1),
    ((5, 5360, 20484, 10), 1), ((4, 100, 40, 10), 10),
    ((5, 800, 20484, 3), 3)],
    ids=["bench", "whole brain", "D=3072 problem", "small", "short grid"])
def test_woodbury_alpha_batch_matches_jax(shape, want):
    """How many alphas the Woodbury scan factors and scores together."""
    assert (tstep._woodbury_alpha_batch(*shape)
            == jstep._woodbury_alpha_batch(*shape) == want)


@pytest.mark.parametrize("n,f,ch,seed", [(407, 5, 10, 0), (4096, 5, 20, 0),
                                         (1000, 3, 7, 4)])
def test_equal_size_folds_index_for_index(n, f, ch, seed):
    for got, want in zip(tstep.equal_size_folds(n, f, ch, seed),
                         jstep.equal_size_folds(n, f, ch, seed)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_devices", [1, 4, 7])
def test_pad_voxels_matches_jax(n_devices):
    Y = np.arange(30, dtype=np.float32).reshape(2, 15)
    got, v = tstep.pad_voxels(Y, n_devices)
    want, vj = jstep.pad_voxels(Y, n_devices)
    assert v == vj == 15
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step_errors_match_jax():
    X, Y, Xt, Yt = _problem(407)
    folds = jstep.equal_size_folds(407, 5, 10, seed=0)
    noncomp = _non_complementary(407)
    cases = [(folds, dict(method="nope"), "method must be one of"),
             (folds, dict(fast_scan="auto"), "boolean fast_scan"),
             (noncomp, dict(method="woodbury"), "requires complementary"),
             (noncomp, dict(method="chol"), "requires complementary")]
    for (tr, va), kw, match in cases:
        with pytest.raises(ValueError, match=match):
            tstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, device="cpu",
                                 **kw)
        with pytest.raises(ValueError, match=match):
            jstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, **kw)


def test_make_nested_cv_step():
    with pytest.raises(TypeError, match="Mesh"):
        tstep.make_nested_cv_step(mesh=object(), device="cpu")(
            *_problem(407), GRID, *jstep.equal_size_folds(407, 5, 10))
    X, Y, Xt, Yt = _problem(407)
    tr, va = jstep.equal_size_folds(407, 5, 10, seed=0)
    bound = tstep.make_nested_cv_step(method="chol", device="cpu")
    got = bound(X, Y, Xt, Yt, GRID, tr, va)
    want = tstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, method="chol",
                                device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_step_restores_the_callers_tf32_flag():
    flags = torch.backends.cuda.matmul
    saved = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        X, Y, Xt, Yt = _problem(407)
        tr, va = jstep.equal_size_folds(407, 5, 10, seed=0)
        tstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, device="cpu")
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = saved

"""Port parity for fast_scan and the fit's TF32 scoping (the contract of
tests/test_fast_scan_auto.py): on the CPU TF32 changes no product, as the
JAX package's default matmul precision is fp32 there, so 'auto' must log
ACCEPTED and equal the fp32 fit exactly; a guard forced to reject falls back
to the fp32 selections; the fused full-CV route calibrates per outer fold.
The fit runs with TF32 off and gives the caller back its setting, also when
it raises. Problem: T=240-300, D=8, V=24, 5 alphas (seeded numpy)."""

import logging

import numpy as np
import pytest
import torch

from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.utils import device as tdevice
from litcoder_core_tpu.models import nested_cv as jcv

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 3, 5), chunk_length=10, n_inner_folds=3,
          seed=0)
LOGGER = "litcoder_core_torch.models.nested_cv"
FLAGS = torch.backends.cuda.matmul
TF32_ON = "tf32"


def _problem(T=240, Tp=60, D=8, V=24, noise=0.5, seed=53):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    wt = rng.normal(size=(D, V)).astype(np.float32)
    Y = (X @ wt + noise * rng.normal(size=(T, V))).astype(np.float32)
    X_test = rng.normal(size=(Tp, D)).astype(np.float32)
    Y_test = (X_test @ wt + noise * rng.normal(size=(Tp, V))).astype(
        np.float32)
    return X, Y, X_test, Y_test


@pytest.mark.parametrize("chunk", [None, 7])
def test_auto_accepts_and_matches_fp32(caplog, chunk):
    X, Y, Xt, Yt = _problem()
    m_fp32, _, a_fp32 = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu",
                                          voxel_chunk_size=chunk, **KW)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        m_auto, _, a_auto = tcv.fit_nested_cv(
            X, Y, Xt, Yt, fast_scan="auto", voxel_chunk_size=chunk,
            device="cpu", **KW)
    assert any("ACCEPTED" in r.message for r in caplog.records)
    np.testing.assert_array_equal(a_auto, a_fp32)
    np.testing.assert_allclose(m_auto["correlations"], m_fp32["correlations"],
                               atol=1e-5)
    want = jcv.fit_nested_cv(X, Y, Xt, Yt, fast_scan="auto",
                             voxel_chunk_size=chunk, **KW)
    assert m_auto["solver_paths"] == want[0]["solver_paths"]
    assert m_auto["solver_paths"]["fast_scan"] == "auto_accepted"
    np.testing.assert_array_equal(a_auto, want[2])


@pytest.mark.parametrize("full_cv", [False, True])
def test_auto_rejection_falls_back_to_fp32(caplog, monkeypatch, full_cv):
    """A threshold above 1 rejects every calibration: the result is the fp32
    search's, recorded 'auto_rejected' as the JAX package records it."""
    X, Y, Xt, Yt = _problem(T=300 if full_cv else 240)
    args = (X, Y) if full_cv else (X, Y, Xt, Yt)
    extra = dict(n_outer_folds=3) if full_cv else {}
    monkeypatch.setattr(tcv, "FAST_SCAN_AGREE_THRESHOLD", 1.01)
    monkeypatch.setattr(jcv, "FAST_SCAN_AGREE_THRESHOLD", 1.01)
    m_fp32, _, a_fp32 = tcv.fit_nested_cv(*args, device="cpu", **extra, **KW)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        m_auto, _, a_auto = tcv.fit_nested_cv(
            *args, fast_scan="auto", device="cpu", **extra, **KW)
    assert any("REJECTED" in r.message for r in caplog.records)
    np.testing.assert_array_equal(a_auto, a_fp32)
    np.testing.assert_allclose(m_auto["correlations"], m_fp32["correlations"],
                               atol=1e-5)
    want = jcv.fit_nested_cv(*args, fast_scan="auto", **extra, **KW)
    assert m_auto["solver_paths"] == want[0]["solver_paths"]
    assert m_auto["solver_paths"]["fast_scan"] == "auto_rejected"


@pytest.mark.parametrize("chunk", [None, 5])
def test_auto_full_cv_fused(caplog, chunk):
    X, Y, _, _ = _problem(T=300)
    kw = dict(KW, n_outer_folds=3, voxel_chunk_size=chunk)
    m_fp32, _, a_fp32 = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        m_auto, _, a_auto = tcv.fit_nested_cv(X, Y, fast_scan="auto",
                                              device="cpu", **kw)
    assert sum("fused full-CV fold" in r.message and "ACCEPTED" in r.message
               for r in caplog.records) == 3
    np.testing.assert_array_equal(a_auto, a_fp32)
    np.testing.assert_allclose(m_auto["correlations"], m_fp32["correlations"],
                               atol=1e-5)
    want = jcv.fit_nested_cv(X, Y, fast_scan="auto", **kw)
    assert m_auto["solver_paths"] == want[0]["solver_paths"] == {
        "mode": "full_cv_fused", "alpha_search": "fused_chol",
        "fast_scan": "auto_accepted"}


@pytest.mark.parametrize("method", ["auto", "eigh", "dual"])
def test_fast_scan_true_matches_jax(method):
    X, Y, Xt, Yt = _problem()
    got = tcv.fit_nested_cv(X, Y, Xt, Yt, fast_scan=True, method=method,
                            device="cpu", **KW)
    want = jcv.fit_nested_cv(X, Y, Xt, Yt, fast_scan=True, method=method,
                             **KW)
    assert got[0]["solver_paths"] == want[0]["solver_paths"]
    assert got[0]["solver_paths"]["fast_scan"] == "bf16"
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0]["correlations"],
                               want[0]["correlations"], atol=2e-3)


def test_fast_scan_accept_policy_matches_jax():
    """The shared accept decision on hand-made scores: 97 of 100 agreeing
    picks are under the 98% bar, 98 are not."""
    rng = np.random.default_rng(3)
    fast = rng.normal(size=(5, 300)).astype(np.float32)
    calib = jcv._calib_voxels(300)
    np.testing.assert_array_equal(tcv._calib_voxels(300), calib)
    for n_flip in (2, 3):
        cal = fast[:, calib].copy()
        cal[:, :n_flip] = cal[::-1, :n_flip] + 10.0 * np.arange(5)[:, None]
        agree = np.mean(fast[:, calib].argmax(0) == cal.argmax(0))
        got = tcv._fast_scan_accept(torch.as_tensor(fast),
                                    torch.as_tensor(cal), calib)
        assert got == jcv._fast_scan_accept(fast, cal, calib)
        assert got == (agree >= 0.98)


def _flag():
    return FLAGS.fp32_precision


def test_matmul_tf32_scopes_and_restores():
    saved = _flag()
    try:
        with tdevice.matmul_tf32(True):
            assert _flag() == TF32_ON
            with tdevice.matmul_tf32(False):
                assert _flag() != TF32_ON
            assert _flag() == TF32_ON
        assert _flag() == saved
        with pytest.raises(KeyError):
            with tdevice.matmul_tf32(True):
                raise KeyError("inside")
        assert _flag() == saved
    finally:
        FLAGS.fp32_precision = saved


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_fit_runs_fp32_and_restores_the_callers_flag(monkeypatch,
                                                     caller_tf32):
    """Whatever the caller set, the refit sees TF32 off, the fast scan turns
    it on around its own products only, and the caller's value is back
    after the fit, and after a fit that raises."""
    X, Y, Xt, Yt = _problem(T=120, V=6)
    saved = _flag()
    seen, asked = [], []
    real_fit_and_score = tcv._fit_and_score
    real_tf32 = tcv.matmul_tf32

    def spy_fit_and_score(*a, **k):
        seen.append(_flag())
        return real_fit_and_score(*a, **k)

    def spy_tf32(enabled):
        asked.append(bool(enabled))
        return real_tf32(enabled)

    monkeypatch.setattr(tcv, "_fit_and_score", spy_fit_and_score)
    monkeypatch.setattr(tcv, "matmul_tf32", spy_tf32)
    try:
        with tdevice.matmul_tf32(caller_tf32):
            before = _flag()
            tcv.fit_nested_cv(X, Y, Xt, Yt, fast_scan=True, device="cpu",
                              **KW)
            assert _flag() == before
            monkeypatch.setattr(tcv, "_select_best_alphas",
                                lambda *a, **k: 1 / 0)
            with pytest.raises(ZeroDivisionError):
                tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **KW)
            assert _flag() == before
    finally:
        FLAGS.fp32_precision = saved
    assert seen and all(v != TF32_ON for v in seen)
    assert True in asked and False in asked

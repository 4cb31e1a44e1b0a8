"""Port parity for the banded scan's other routes: the Python-level chunked
Cholesky scan (a tail chunk included), host streaming of the response,
the dual (kernel-ridge) scan for wide designs, method='dual' on a tall
design (T_tr = D), and fast_scan True and 'auto' (TF32 has no effect on
the CPU, so both must equal the fp32 fit there, as JAX's default-precision
scan equals its HIGHEST one on the CPU).

Problems as in tests/test_torch_banded.py (T=240, bands of 24 and 16,
V=23, 4 folds of 10-row chunks); the wide one has bands of 100 and 80 on
120 rows (T_tr=90 < D). Bars: the same alphas, gammas and solver_paths;
correlations and p-values within 2e-4; weights within 1e-4 of their
largest magnitude."""

import numpy as np
import pytest
import torch

import litcoder_core_tpu.models.banded as jb
import litcoder_core_torch.models.banded as tb
from litcoder_core_torch.models import fit_banded_ridge
from litcoder_core_torch.models.folding import create_folds
from tests.test_torch_banded import (
    KW,
    assert_fits_match,
    banded_problem,
    both,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tall():
    return banded_problem(17, V=23)


@pytest.fixture(scope="module")
def wide():
    return banded_problem(21, T=120, dims=(100, 80), V=23)


@pytest.fixture(scope="module")
def chunked(tall):
    """Port and JAX fits with voxel chunks of 7 (3 full chunks and a tail
    of 2), and the port's unchunked fit."""
    got, want = both(tall, voxel_chunk_size=7)
    return got, want, fit_banded_ridge(*tall, device="cpu", **KW)


def test_chunked_scan_matches_jax(chunked):
    got, want, _ = chunked
    assert got[0]["solver_paths"] == {"banded_scan": "chol",
                                      "banded_refit": "grouped_chol"}
    assert_fits_match(got, want)


def test_chunked_scan_matches_unchunked(chunked):
    got, _, whole = chunked
    np.testing.assert_array_equal(got[2], whole[2])
    np.testing.assert_array_equal(got[3], whole[3])
    np.testing.assert_allclose(got[0]["correlations"],
                               whole[0]["correlations"], atol=1e-5)
    np.testing.assert_allclose(got[1], whole[1], atol=1e-4)


def test_chunked_scores_equal_unchunked_with_a_tail(tall, monkeypatch):
    """The (G, A, V) scores themselves: chunks of 7 on V=23 leave a tail of
    2 voxels, which must score as the unchunked scan does."""
    Xs, Y = tall[:2]
    Xc = torch.cat([torch.as_tensor(X) for X in Xs], dim=1)
    Y_t = torch.as_tensor(Y)
    splits = create_folds(240, "chunked", 4, 10, seed=0)
    gammas = tb.sample_gammas(2, 4, 0)
    args = (Xs, Y_t, gammas, splits, KW["alphas"], True, True, 1e-10,
            "auto")
    whole = tb._score_gammas(*args, {}, Xc=Xc)
    calls = []
    orig = tb._chol_scan_chunked

    def spy(*a, **k):
        calls.append(a[-1])
        return orig(*a, **k)

    monkeypatch.setattr(tb, "_chol_scan_chunked", spy)
    parts = tb._score_gammas(*args, {}, voxel_chunk=7, Xc=Xc)
    assert calls == [7]
    assert parts.shape == whole.shape == (4, 6, 23)
    torch.testing.assert_close(parts, whole, atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk_length", [10, 7])
def test_chunked_scan_on_gather_folds_matches_jax(tall, chunk_length):
    """chunk_length=7 leaves rows in no fold (the gather form of the
    chunked scan, fold groups of unequal shapes)."""
    got, want = both(tall, voxel_chunk_size=5, chunk_length=chunk_length,
                     alphas=np.logspace(-1, 4, 4))
    assert_fits_match(got, want)


# ---- host streaming -------------------------------------------------------


@pytest.fixture
def xty_calls(monkeypatch):
    calls = []
    orig = tb._xty_streamed

    def spy(Xc, Y_host, *a, **k):
        calls.append(type(Y_host))
        return orig(Xc, Y_host, *a, **k)

    monkeypatch.setattr(tb, "_xty_streamed", spy)
    return calls


def test_host_response_streams_once(tall, chunked, xty_calls):
    """A numpy Y with voxel chunks builds the (D, V) cross-product once
    (the scan and the refit share it) and matches the device-resident
    fit and JAX's host-streamed fit."""
    got = fit_banded_ridge(*tall, device="cpu", voxel_chunk_size=7, **KW)
    assert xty_calls == [np.ndarray]
    assert "xty_stream" in got[0]["stage_seconds"]
    _, want, _ = chunked   # JAX streams a numpy Y the same way
    assert_fits_match(got, want)


def test_response_on_the_device_never_streams(tall, chunked, xty_calls):
    Xs, Y, Xts, Yt = tall
    got = fit_banded_ridge(Xs, torch.as_tensor(Y), Xts, Yt, device="cpu",
                           voxel_chunk_size=7, **KW)
    assert xty_calls == []
    assert "xty_stream" not in got[0]["stage_seconds"]
    assert_fits_match(got, chunked[1])


def test_streamed_fast_scan_auto_matches_jax(tall, xty_calls):
    """fast_scan='auto' in streaming mode gathers the calibration columns
    on the host."""
    got, want = both(tall, voxel_chunk_size=7, fast_scan="auto")
    assert xty_calls == [np.ndarray]
    assert set(got[0]["stage_seconds"]) == {
        "xty_stream", "scan_bf16", "scan_calibration_fp32", "refit",
        "test_scoring"}
    assert_fits_match(got, want)


# ---- dual scan -------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(method="dual"),
                                dict(voxel_chunk_size=7),
                                dict(method="svd")])
def test_wide_design_matches_jax(wide, kw):
    got, want = both(wide, **kw)
    scan = "svd_fallback" if kw.get("method") == "svd" else "dual"
    assert got[0]["solver_paths"] == {"banded_scan": scan,
                                      "banded_refit": "spectral"}
    assert_fits_match(got, want)


@pytest.mark.parametrize("method", ["dual", "auto"])
def test_forced_dual_on_a_tall_design_matches_jax(method):
    """method='dual' on a tall design (T_tr = D = 180, so 'auto' takes the
    Cholesky scan). The training kernels are full-rank only at T_tr = D:
    on a taller design they have rank D < T_tr, where both packages'
    lmax_dense can miss the Krylov breakdown (ROADMAP.md C)."""
    problem = banded_problem(23, T=240, dims=(100, 80), V=23)
    got, want = both(problem, method=method)
    assert got[0]["solver_paths"] == (
        {"banded_scan": "dual", "banded_refit": "spectral"}
        if method == "dual"
        else {"banded_scan": "chol", "banded_refit": "grouped_chol"})
    assert_fits_match(got, want)


# ---- fast scan -------------------------------------------------------------


@pytest.mark.parametrize("fast_scan", [True, "auto"])
def test_fast_scan_matches_jax(tall, fast_scan):
    got, want = both(tall, fast_scan=fast_scan)
    assert_fits_match(got, want)
    stages = set(got[0]["stage_seconds"])
    if fast_scan == "auto":
        assert {"scan_bf16", "scan_calibration_fp32"} <= stages
        assert "scan_fp32_fallback" not in stages   # accepted on the CPU
    else:
        assert "scan" in stages


def test_fast_scan_warns_on_the_fallback(tall, caplog):
    with caplog.at_level("WARNING", logger=tb.__name__):
        m, _, _, _ = fit_banded_ridge(*tall, device="cpu", method="svd",
                                      fast_scan=True, **KW)
    assert m["solver_paths"]["banded_scan"] == "svd_fallback"
    assert "running the fp32 scan" in caplog.text


def test_jax_streams_the_same_host_response(tall, monkeypatch):
    """The reference's own gate: a numpy Y with voxel chunks streams in
    the JAX package too, so the parity fits above compare like with
    like."""
    calls = []
    orig = jb._xty_streamed
    monkeypatch.setattr(jb, "_xty_streamed",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jb.fit_banded_ridge(*tall, voxel_chunk_size=7, **KW)
    assert calls == [1]

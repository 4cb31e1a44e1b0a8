"""Port parity for variance partitioning
(litcoder_core_torch.models.variance_partition against
litcoder_core_tpu.models.variance_partition) on the CPU, for 2 and 3
feature spaces, and its errors.

Problems: spaces of 8, 10 and 6 features, T=240 training rows in 3
chunked folds of 10-row chunks, 80 test rows, V=12; the responses mix the
first two spaces. Bars: the same keys; every component within 4e-4 (a
difference of signed squares of correlations held within 2e-4)."""

import numpy as np
import pytest
import torch

from litcoder_core_tpu.models.variance_partition import (
    variance_partitioning as jax_vp,
)
from litcoder_core_torch.models import variance_partitioning

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 4, 6), n_inner_folds=3, chunk_length=10,
          seed=0)


def spaces(seed=4, T=240, Tp=80, dims=(8, 10, 6), V=12):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(d, V)).astype(np.float32) for d in dims]

    def draw(n):
        Xs = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
        Y = Xs[0] @ ws[0] + 0.7 * Xs[1] @ ws[1]
        return Xs, (Y + 4.0 * rng.normal(size=(n, V))).astype(np.float32)

    Xs, Y = draw(T)
    Xts, Yt = draw(Tp)
    return Xs, Y, Xts, Yt


@pytest.mark.parametrize("n_spaces,names", [(2, None), (3, None),
                                            (3, ["wr", "emb", "lm"])])
def test_partition_matches_jax(n_spaces, names):
    Xs, Y, Xts, Yt = spaces()
    args = (Xs[:n_spaces], Y, Xts[:n_spaces], Yt)
    got = variance_partitioning(*args, names=names, device="cpu", **KW)
    want = jax_vp(*args, names=names, **KW)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float64 and got[key].shape == (12,)
        np.testing.assert_allclose(got[key], want[key], atol=4e-4,
                                   err_msg=key)
    if n_spaces == 2:
        np.testing.assert_allclose(
            got["r2_AB"] - got["unique_A"] - got["unique_B"]
            - got["shared"], 0.0, atol=1e-12)
        assert np.median(got["unique_A"]) > np.median(got["unique_B"])


def test_subset_fits_run_on_the_device_given(monkeypatch):
    """Each subset fit is fit_nested_cv in train/test mode without
    weights, on the caller's device."""
    import litcoder_core_torch.models.variance_partition as vp

    calls = []
    orig = vp.fit_nested_cv

    def spy(X, Y, **kw):
        calls.append((X.shape[1], kw["device"], kw["return_weights"]))
        return orig(X, Y, **kw)

    monkeypatch.setattr(vp, "fit_nested_cv", spy)
    Xs, Y, Xts, Yt = spaces()
    variance_partitioning(Xs[:2], Y, Xts[:2], Yt, device="cpu", **KW)
    assert calls == [(8, "cpu", False), (10, "cpu", False),
                     (18, "cpu", False)]


@pytest.mark.parametrize("n_spaces,n_tests,match", [
    (1, 1, "supports 2 or 3 spaces, got 1"),
    (4, 4, "supports 2 or 3 spaces, got 4"),
    (2, 3, "X_tests must match Xs per space"),
])
def test_errors_match_jax(n_spaces, n_tests, match):
    Xs, Y, Xts, Yt = spaces(dims=(3, 3, 3, 3), V=2)
    with pytest.raises(ValueError, match=match):
        jax_vp(Xs[:n_spaces], Y, Xts[:n_tests], Yt)
    with pytest.raises(ValueError, match=match):
        variance_partitioning(Xs[:n_spaces], Y, Xts[:n_tests], Yt,
                              device="cpu")

"""Port parity: litcoder_core_torch.ops.{stats, interp, fir} against their
JAX twins on the same seeded numpy inputs, within 1e-5 (float32 on both
sides; the sums run in another order)."""

import numpy as np
import pytest
import torch

from litcoder_core_tpu.ops import fir as jfir
from litcoder_core_tpu.ops import interp as jinterp
from litcoder_core_tpu.ops import stats as jstats
from litcoder_core_torch.ops import fir as tfir
from litcoder_core_torch.ops import interp as tinterp
from litcoder_core_torch.ops import stats as tstats

torch.set_num_threads(2)

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.fixture
def mat():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    x[:, 2] = 3.0  # zero-variance column
    return x


@pytest.mark.parametrize("ddof", [0, 1])
def test_zscore_matches_jax(mat, ddof):
    _close(tstats.zscore(_t(mat), dim=0, ddof=ddof),
           jstats.zscore(mat, axis=0, ddof=ddof))


def test_trainer_zscore_zero_variance_column(mat):
    got = tstats.trainer_zscore(_t(mat)).numpy()
    _close(got, jstats.trainer_zscore(mat))
    assert np.all(got[:, 2] == 0.0)  # demeaned, not divided


def test_trainer_zscore_1d(mat):
    _close(tstats.trainer_zscore(_t(mat[:, 0])),
           jstats.trainer_zscore(mat[:, 0]))


def test_pearson_r_constant_columns(mat):
    rng = np.random.default_rng(1)
    pred = (mat + rng.normal(size=mat.shape)).astype(np.float32)
    pred[:, 4] = -1.0  # constant prediction column
    got = tstats.pearson_r(_t(mat), _t(pred)).numpy()
    _close(got, jstats.pearson_r(mat, pred))
    assert got[2] == 0.0 and got[4] == 0.0  # NaN -> 0


def test_pvalues_and_fdr_match_jax():
    rng = np.random.default_rng(2)
    r = rng.uniform(-0.4, 0.9, 200)
    r[5] = np.nan
    np.testing.assert_array_equal(tstats.pearson_pvalues_f64(r, 120),
                                  jstats.pearson_pvalues_f64(r, 120))
    p = jstats.pearson_pvalues_f64(r, 120)
    for got, want in zip(tstats.bh_fdrcorrection_np(p, 0.05),
                         jstats.bh_fdrcorrection_np(p, 0.05)):
        np.testing.assert_array_equal(got, want)


def _times(rng, t_w=230, t_tr=49):
    dt = np.sort(rng.uniform(0, 100, t_w)).astype(np.float32)
    tt = np.linspace(1.0, 99.0, t_tr).astype(np.float32)
    return dt, tt


@pytest.mark.parametrize("window", [1, 3])
def test_lanczos_matrix_matches_jax(window):
    dt, tt = _times(np.random.default_rng(3))
    got = tinterp.lanczos_matrix(_t(dt), _t(tt), window, 1.5)
    _close(got, jinterp.lanczos_matrix(dt, tt, window, 1.5))


def test_lanczosfun_at_zero_and_outside_window():
    t = np.array([0.0, 0.5, 2.9, 3.0, 3.1, -4.0], np.float32)
    got = tinterp.lanczosfun(torch.tensor(1.0), _t(t), 3).numpy()
    _close(got, jinterp.lanczosfun(1.0, t, 3))
    assert got[0] == 1.0 and got[4] == 0.0 and got[5] == 0.0


@pytest.mark.parametrize("rectify", [False, True])
def test_lanczosinterp2d_matches_jax(rectify):
    rng = np.random.default_rng(4)
    dt, tt = _times(rng)
    data = rng.normal(size=(230, 5)).astype(np.float32)
    got = tinterp.lanczosinterp2D(_t(data), _t(dt), _t(tt), 3, 1.0, rectify)
    _close(got, jinterp.lanczosinterp2D(data, dt, tt, 3, 1.0, rectify))


@pytest.mark.parametrize("delays,circpad", [
    ([1, 2, 3, 4], False),
    ([0], False),
    ([-2, 0, 3], False),
    ([-1, 2], True),
    ([60], False),  # longer than the story: an all-zero block
])
def test_make_delayed_matches_jax(delays, circpad):
    rng = np.random.default_rng(5)
    stim = rng.normal(size=(40, 3)).astype(np.float32)
    got = tfir.make_delayed(_t(stim), delays, circpad).numpy()
    want = np.asarray(jfir.make_delayed(stim, delays, circpad))
    assert got.shape == want.shape == (40, 3 * len(delays))
    np.testing.assert_array_equal(got, want)


def test_host_zs_matches_jax(mat):
    from litcoder_core_tpu.utils.core import zs as jax_zs
    from litcoder_core_torch.utils.core import zs

    np.testing.assert_array_equal(zs(mat.copy()), jax_zs(mat.copy()))
    np.testing.assert_array_equal(zs(mat[:, 2].copy()),
                                  jax_zs(mat[:, 2].copy()))

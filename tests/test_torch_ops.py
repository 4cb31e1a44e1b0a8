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


# --- the rest of ops/stats.py -----------------------------------------------


def test_stats_module_matches_jax_name_for_name():
    def public(module):
        return {n for n, v in vars(module).items()
                if callable(v) and not n.startswith("_")
                and getattr(v, "__module__", "") == module.__name__}

    assert public(tstats) >= public(jstats)


def test_pearson_pvalues_match_jax_float32():
    rng = np.random.default_rng(3)
    rs = rng.uniform(-0.5, 0.5, 64).astype(np.float32)
    rs[7] = np.nan
    got = tstats.pearson_pvalues(_t(rs), 100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jstats.pearson_pvalues(rs, 100)),
                               rtol=2e-4, atol=1e-6)
    assert got[7] == 1.0
    # r = 0.35 at n = 2000 is below float32's range in both packages.
    assert float(tstats.pearson_pvalues(_t([0.35]), 2000)[0]) == 0.0
    np.testing.assert_array_equal(tstats.pearson_pvalues(_t([0.3]), 2),
                                  [1.0])


def test_pearson_r_pvalues_matches_jax():
    rng = np.random.default_rng(4)
    yt = rng.normal(size=(60, 5)).astype(np.float32)
    yp = (yt + rng.normal(size=(60, 5)) * np.arange(1, 6)).astype(np.float32)
    rt, pt = tstats.pearson_r_pvalues(_t(yt), _t(yp))
    rj, pj = jstats.pearson_r_pvalues(yt, yp)
    _close(rt, rj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-4,
                               atol=1e-6)


def test_fisher_combine_pvalues_matches_jax():
    """The float32 device combination, with the p = 0 floor and the all-ones
    guard (tests/test_stats.py:146)."""
    p = np.array([[0.0, 0.5, 1.0, 0.02], [0.3, 0.5, 1.0, 0.4]], np.float32)
    got = tstats.fisher_combine_pvalues(_t(p)).numpy()
    want = np.asarray(jstats.fisher_combine_pvalues(p))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(got).all() and got[0] < 1e-30 and got[2] == 1.0
    rng = np.random.default_rng(4)
    q = rng.uniform(1e-6, 1.0, size=(5, 40)).astype(np.float32)
    np.testing.assert_allclose(tstats.fisher_combine_pvalues(_t(q)).numpy(),
                               np.asarray(jstats.fisher_combine_pvalues(q)),
                               rtol=1e-4)


def test_bh_fdrcorrection_device_matches_jax_and_host():
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.uniform(0, 1e-4, 30), rng.uniform(0, 1, 200)])
    p32 = p.astype(np.float32)
    rt, ct = tstats.bh_fdrcorrection(_t(p32), alpha=0.05)
    rj, cj = jstats.bh_fdrcorrection(p32, alpha=0.05)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
    np.testing.assert_array_equal(rt.numpy(),
                                  tstats.bh_fdrcorrection_np(p, 0.05)[0])
    none, _ = tstats.bh_fdrcorrection(_t([0.5, 0.9]), alpha=0.05)
    assert not none.any()


def test_signed_square_corr_matches_jax():
    rng = np.random.default_rng(6)
    yt = rng.normal(size=(50, 4)).astype(np.float32)
    yp = (yt * [1.0, 0.5, -1.0, 0.0] + rng.normal(size=(50, 4))).astype(
        np.float32)
    _close(tstats.signed_square_corr(_t(yt), _t(yp)),
           jstats.signed_square_corr(yt, yp))


def test_noise_ceiling_split_half():
    """Two repeats have one split: equal to the JAX ceiling. Eight repeats:
    high-SNR voxels near 1, noise voxels near 0, fewer repeats lower
    (tests/test_stats.py:281), and one repeat raises."""
    r = np.random.default_rng(19)
    t, v, reps = 240, 20, 8
    signal = r.normal(size=(t, v)).astype(np.float32)
    noise = np.where(np.arange(v) < 10, 0.3, 50.0).astype(np.float32)
    resp = (signal[None] + noise[None, None, :]
            * r.normal(size=(reps, t, v))).astype(np.float32)
    _close(tstats.noise_ceiling_split_half(_t(resp[:2])),
           jstats.noise_ceiling_split_half(resp[:2]), atol=1e-5)
    ceil = tstats.noise_ceiling_split_half(_t(resp)).numpy()
    assert np.all(ceil[:10] > 0.9) and np.all(np.abs(ceil[10:]) < 0.4)
    ceil2 = tstats.noise_ceiling_split_half(_t(resp[:2])).numpy()
    assert np.mean(ceil2[:10]) <= np.mean(ceil[:10]) + 1e-3
    np.testing.assert_array_equal(
        ceil, tstats.noise_ceiling_split_half(
            _t(resp), torch.Generator().manual_seed(0)).numpy())
    with pytest.raises(ValueError, match=">= 2 repeats"):
        tstats.noise_ceiling_split_half(_t(resp[:1]))

"""Host column-stat helpers and the plotting unmask (twin of
litcoder_core_tpu/utils/core.py). numpy in, numpy out, except make_delayed,
which is FIR.make_delayed and returns a tensor. The device-side twin of
`zs` is litcoder_core_torch.ops.stats.trainer_zscore."""

import numpy as np

from litcoder_core_torch.features.fir_expander import FIR


def demean(v: np.ndarray) -> np.ndarray:
    """Removes the mean from each column of [v]."""
    return v - v.mean(0)


dm = demean


def zscore(v: np.ndarray) -> np.ndarray:
    """Z-scores each column of [v] (ddof=0); zero-variance columns are left
    demeaned. Accepts 1-D vectors."""
    s = v.std(0)
    m = v - v.mean(0)
    if m.ndim == 1:
        return m / s if s != 0.0 else m
    nonzero = s != 0.0
    m[:, nonzero] /= s[nonzero]
    return m


zs = zscore


def rescale(v: np.ndarray) -> np.ndarray:
    """Rescales each column of [v] to unit variance."""
    return v / v.std(0)


rs = rescale


def mcorr(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Correlation between each column of c1 and the matching column of c2."""
    return (zs(c1) * zs(c2)).mean(0)


def xcorr(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Correlation between each row of c1 and EACH row of c2."""
    return np.dot(zs(c1.T).T, zs(c2.T)) / (c1.shape[1])


def make_delayed(stim, delays, circpad: bool = False):
    """FIR delay stack, (T, D * len(delays)): FIR.make_delayed, one
    implementation for both names."""
    return FIR.make_delayed(stim, delays, circpad)


def unmask_correlations_for_plotting(masked_correlations: np.ndarray,
                                     mask_indices: np.ndarray,
                                     full_size: int) -> np.ndarray:
    """Expand masked correlations to full brain size with NaNs elsewhere."""
    full = np.full(full_size, np.nan)
    full[mask_indices] = masked_correlations
    return full

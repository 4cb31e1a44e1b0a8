"""Host statistics in float64, from scipy's distributions.

- two-sided Pearson p-values from Student's t with n - 2 degrees of freedom;
- Fisher's combination: chi-square with 2k degrees of freedom of
  -2 sum log p (a voxel whose p-values are all 1 keeps 1);
- Benjamini-Hochberg adjusted p-values (step-up, capped at 1).
"""

import numpy as np
from scipy import stats


def pearson_pvalues(r, n: int) -> np.ndarray:
    r = np.asarray(r, np.float64)
    df = n - 2
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.abs(r) * np.sqrt(df / np.clip(1.0 - r * r, 0.0, None))
    p = 2.0 * stats.t.sf(t, df)
    return np.clip(np.nan_to_num(p, nan=1.0), 0.0, 1.0)


def fisher_combine(pvalues) -> np.ndarray:
    """pvalues (k, V) -> (V,)."""
    p = np.asarray(pvalues, np.float64)
    with np.errstate(divide="ignore"):
        stat = -2.0 * np.log(p).sum(axis=0)
    out = stats.chi2.sf(stat, 2 * p.shape[0])
    return np.where(np.all(p >= 1.0, axis=0), 1.0, out)


def bh_adjust(pvalues) -> np.ndarray:
    p = np.asarray(pvalues, np.float64)
    n = p.size
    order = np.argsort(p, kind="stable")
    scaled = p[order] * n / np.arange(1, n + 1)
    adjusted = np.minimum(np.minimum.accumulate(scaled[::-1])[::-1], 1.0)
    out = np.empty(n)
    out[order] = adjusted
    return out

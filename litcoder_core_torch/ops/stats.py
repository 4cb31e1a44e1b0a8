"""Voxelwise statistics on tensors (twin of litcoder_core_tpu/ops/stats.py).

`torch.std`/`torch.var` default to correction=1 while `jnp.std` defaults to
ddof=0, so every call here names its `correction=`. The float64 p-value and
FDR tails are host numpy/scipy, as in the JAX package.
"""

import numpy as np
import torch


def zscore(x: torch.Tensor, dim: int = 0, eps: float = 1e-8,
           ddof: int = 1) -> torch.Tensor:
    """Z-score along `dim` with the model-level eps and ddof=1 by default
    (the reference's torch path, encoding/models/ridge_utils.py:6-15)."""
    mean = torch.mean(x, dim=dim, keepdim=True)
    std = torch.std(x, dim=dim, keepdim=True, correction=ddof)
    return (x - mean) / (std + eps)


def trainer_zscore(x: torch.Tensor) -> torch.Tensor:
    """Per-column ddof=0 z-score without eps; zero-variance columns are only
    demeaned (utils.core.zs semantics). Works for 1-D and 2-D inputs."""
    keep = x.ndim > 1
    m = x - torch.mean(x, dim=0, keepdim=keep)
    s = torch.std(x, dim=0, keepdim=keep, correction=0)
    return torch.where(s == 0.0, m, m / torch.where(s == 0.0, 1.0, s))


def pearson_r(y_true: torch.Tensor, y_pred: torch.Tensor,
              dim: int = 0) -> torch.Tensor:
    """Columnwise Pearson correlation; NaN and inf become 0."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    yt = y_true - torch.mean(y_true, dim=dim, keepdim=True)
    yp = y_pred - torch.mean(y_pred, dim=dim, keepdim=True)
    num = torch.sum(yt * yp, dim=dim)
    den = torch.sqrt(torch.sum(yt * yt, dim=dim) * torch.sum(yp * yp, dim=dim))
    return torch.nan_to_num(num / den, nan=0.0, posinf=0.0, neginf=0.0)


def pearson_pvalues_f64(r, n: int) -> np.ndarray:
    """Host float64 two-sided Pearson p-values, betainc(df/2, 1/2, 1 - r^2)
    as scipy.stats.pearsonr computes them; NaN -> 1."""
    from scipy.special import betainc

    r64 = np.asarray(r, np.float64)
    df = float(n - 2)
    if df <= 0:
        return np.ones_like(r64)
    x = np.clip(1.0 - r64 * r64, 0.0, 1.0)
    p = betainc(df / 2.0, 0.5, x)
    p = np.where(np.isnan(r64), 1.0, p)
    return np.clip(np.nan_to_num(p, nan=1.0), 0.0, 1.0)


def fisher_combine_pvalues_f64(fold_pvalues) -> np.ndarray:
    """Host float64 Fisher combination over axis 0 (folds), as
    scipy.stats.combine_pvalues(method='fisher') computes it: a zero p
    gives log 0, an infinite statistic and a combined p of 0; a voxel whose
    p-values are all 1 keeps 1."""
    from scipy.special import gammaincc

    p = np.asarray(fold_pvalues, np.float64)
    with np.errstate(divide="ignore"):
        stat = -2.0 * np.sum(np.log(p), axis=0)
    combined = np.where(np.isinf(stat), 0.0,
                        gammaincc(float(p.shape[0]), stat / 2.0))
    return np.where(np.all(p >= 1.0, axis=0), 1.0, combined)


def bh_fdrcorrection_np(pvals, alpha: float = 0.05):
    """Host float64 Benjamini-Hochberg step-up, identical to statsmodels
    fdrcorrection(method='indep'). Returns (reject_mask, corrected_pvals)."""
    p = np.asarray(pvals, np.float64)
    n = p.shape[0]
    order = np.argsort(p, kind="stable")
    ranked = p[order]
    ecdf = np.arange(1, n + 1, dtype=np.float64) / n

    corrected_sorted = np.minimum(
        np.minimum.accumulate((ranked / ecdf)[::-1])[::-1], 1.0
    )
    below = ranked <= ecdf * alpha
    reject_sorted = np.zeros(n, dtype=bool)
    if below.any():
        reject_sorted[: np.max(np.nonzero(below)[0]) + 1] = True

    inv = np.argsort(order)
    return reject_sorted[inv], corrected_sorted[inv]

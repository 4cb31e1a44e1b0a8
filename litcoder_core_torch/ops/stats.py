"""Voxelwise statistics on tensors (twin of litcoder_core_tpu/ops/stats.py,
name for name).

`torch.std`/`torch.var` default to correction=1 while `jnp.std` defaults to
ddof=0, so every call here names its `correction=`. The float64 p-value and
FDR tails are host numpy/scipy, as in the JAX package. torch has no
incomplete beta function, so `pearson_pvalues` (the JAX package's float32
device tail) evaluates scipy's in float64 on the host and returns float32 on
the input's device. Random draws (permutation shifts, split halves) come
from an explicit torch.Generator or are passed in.
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


def pearson_pvalues(r: torch.Tensor, n: int) -> torch.Tensor:
    """Two-sided Pearson p-values of r with n samples as float32 on r's
    device; NaN -> 1. (The fit uses pearson_pvalues_f64 directly.)"""
    r = torch.as_tensor(r)
    return torch.as_tensor(pearson_pvalues_f64(r.detach().cpu().numpy(), n),
                           dtype=torch.float32, device=r.device)


def pearson_r_pvalues(y_true: torch.Tensor, y_pred: torch.Tensor,
                      dim: int = 0):
    """(correlations, two-sided p-values) along `dim`."""
    r = pearson_r(y_true, y_pred, dim=dim)
    return r, pearson_pvalues(r, y_true.shape[dim])


def fisher_combine_pvalues(fold_pvalues: torch.Tensor) -> torch.Tensor:
    """float32 Fisher combination over axis 0 (folds) on the device: p is
    floored at the smallest normal float32 so a zero p gives a finite, huge
    statistic; a voxel whose p-values are all 1 keeps 1."""
    p = torch.as_tensor(fold_pvalues, dtype=torch.float32)
    logs = torch.log(torch.clamp(p, min=torch.finfo(torch.float32).tiny,
                                 max=1.0))
    stat = -2.0 * torch.sum(logs, dim=0)
    combined = torch.special.gammaincc(
        torch.full_like(stat, float(p.shape[0])), stat / 2.0)
    return torch.where(torch.all(p >= 1.0, dim=0), 1.0, combined)


def bh_fdrcorrection(pvals: torch.Tensor, alpha: float = 0.05):
    """Benjamini-Hochberg step-up on the device in float32: (reject mask,
    corrected p-values), the decisions of bh_fdrcorrection_np."""
    p = torch.as_tensor(pvals, dtype=torch.float32)
    n = p.shape[0]
    order = torch.argsort(p, stable=True)
    ranked = p[order]
    ecdf = torch.arange(1, n + 1, dtype=torch.float32, device=p.device) / n
    corrected_sorted = torch.clamp(
        torch.flip(torch.cummin(torch.flip(ranked / ecdf, [0]), 0).values,
                   [0]), max=1.0)
    below = ranked <= ecdf * alpha
    ranks = torch.arange(n, device=p.device)
    max_idx = torch.max(torch.where(below, ranks, -1))
    reject_sorted = ranks <= max_idx
    inv = torch.argsort(order)
    return reject_sorted[inv], corrected_sorted[inv]


def permutation_offsets(n_permutations: int, n_samples: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(n_permutations,) circular-shift offsets, uniform on [1, n_samples),
    drawn on the host from `generator` (so every device gets the same)."""
    return torch.randint(1, n_samples, (n_permutations,),
                         generator=generator)


# Voxel columns per block of the permutation null (bounds the float64 FFT
# buffers at T x 8192).
_PERM_BLOCK = 8192


def permutation_pvalues(y_true: torch.Tensor, y_pred: torch.Tensor,
                        offsets: torch.Tensor, two_sided: bool = False):
    """Voxelwise circular-shift permutation p-values (the JAX package's
    permutation_pvalues with its random offsets passed in).

    The null correlation of shift k is pearson_r(y_true, roll(y_pred, k)).
    Rolling leaves y_pred's mean and norm unchanged, so with both series
    centred its numerator is the circular cross-correlation
    sum_t yt[t] yp[t - k], and one float64 FFT per voxel block gives every
    lag at once instead of one pass over (T, V) per shift.

    Returns (p (V,), observed r (V,)), float32: p = (1 + #{null >= obs}) /
    (n + 1), or with |null| >= |obs| when two_sided."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    T = y_true.shape[0]
    obs = pearson_r(y_true, y_pred)
    offsets = torch.as_tensor(offsets, device=y_true.device)
    exceed = []
    for lo in range(0, y_true.shape[1], _PERM_BLOCK):
        yt = y_true[:, lo:lo + _PERM_BLOCK].to(torch.float64)
        yp = y_pred[:, lo:lo + _PERM_BLOCK].to(torch.float64)
        yt = yt - yt.mean(dim=0, keepdim=True)
        yp = yp - yp.mean(dim=0, keepdim=True)
        den = torch.sqrt(torch.sum(yt * yt, dim=0) * torch.sum(yp * yp, dim=0))
        xcorr = torch.fft.irfft(torch.fft.rfft(yt, dim=0)
                                * torch.conj(torch.fft.rfft(yp, dim=0)),
                                n=T, dim=0)
        null = torch.nan_to_num(xcorr[offsets] / den, nan=0.0, posinf=0.0,
                                neginf=0.0)
        o = obs[lo:lo + _PERM_BLOCK].to(torch.float64)
        hit = (null.abs() >= o.abs()) if two_sided else (null >= o)
        exceed.append(hit.sum(dim=0).to(torch.float32))
    # XLA compiles the JAX package's division by the constant n + 1 into a
    # product with its float32 reciprocal; the same rounding here.
    inv = torch.tensor(1.0 / (offsets.shape[0] + 1.0), dtype=torch.float32)
    return (1.0 + torch.cat(exceed)) * inv.to(obs.device), obs


def signed_square_corr(y_true: torch.Tensor, y_pred: torch.Tensor,
                       dim: int = 0) -> torch.Tensor:
    """Signed-sqrt R^2 (the use_corr=False score), variances with
    correction=1 as the reference's torch path."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    resvar = torch.var(y_true - y_pred, dim=dim, correction=1)
    rsq = 1.0 - resvar / torch.var(y_true, dim=dim, correction=1)
    return torch.sqrt(torch.abs(rsq)) * torch.sign(rsq)


def noise_ceiling_split_half(responses: torch.Tensor, generator=None,
                             n_splits: int = 20) -> torch.Tensor:
    """Per-voxel noise ceiling from repeated presentations (n_reps, T, V):
    the mean split-half correlation over `n_splits` random partitions of the
    repeats (drawn from `generator`, seed 0 when None), Spearman-Brown
    corrected to n_reps. With an odd count each split drops one repeat, as
    the JAX package does."""
    responses = torch.as_tensor(responses, dtype=torch.float32)
    n_reps = responses.shape[0]
    if n_reps < 2:
        raise ValueError("noise ceiling needs >= 2 repeats")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    half = n_reps // 2
    r_half = torch.zeros(responses.shape[2], dtype=torch.float32,
                         device=responses.device)
    for _ in range(n_splits):
        perm = torch.randperm(n_reps, generator=generator).to(
            responses.device)
        a = torch.mean(responses[perm[:half]], dim=0)
        b = torch.mean(responses[perm[half:2 * half]], dim=0)
        r_half += pearson_r(a, b)
    r_half /= n_splits
    ratio = n_reps / half
    return (ratio * r_half) / (1.0 + (ratio - 1.0) * r_half)

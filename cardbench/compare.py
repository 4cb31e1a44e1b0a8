"""The numbers that decide `correct`, each against its limit.

Every number is a widest gap over voxels (or design entries) between what
was produced and what the plain reference (cardbench/reference/) gives:

- score_regret: how far below the reference's best mean validation score
  the reference's score at the produced alpha lies (0 when the produced
  alpha is the reference's pick; a near-tie picked the other way costs
  only the tie's width);
- r_gap: the produced held-out r against the reference's refit;
- p_gap, q_gap: the produced p-values and BH-adjusted p-values against
  the reference's, computed from the reference's r;
- p_flip_share: with permutation p-values, which are counts, the share of
  voxels whose count differs from the reference's;
- design_gap: the produced delayed, z-scored design against the
  reference's (LM forward, Lanczos, FIR delays, trimming, z-scores).

A value that is not finite counts as above every limit.
"""

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from cardbench.reference import stats


def score_regret(scores: np.ndarray, grid: np.ndarray,
                 produced_alphas: np.ndarray) -> float:
    grid = np.asarray(grid, np.float32)
    produced = np.asarray(produced_alphas, np.float32)
    idx = np.searchsorted(grid, produced)
    idx = np.clip(idx, 0, grid.size - 1)
    if not np.array_equal(grid[idx], produced):
        return math.inf
    picked = scores[idx, np.arange(scores.shape[1])]
    return float(np.max(scores.max(axis=0) - picked))


def widest_gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def train_test_numbers(out: Dict, scores: np.ndarray, grid: np.ndarray,
                       r_ref: np.ndarray, n_test: int,
                       p_perm: Optional[np.ndarray] = None,
                       n_permutations: int = 0) -> Dict[str, float]:
    """out: 'alphas', 'r', 'p', 'q' of one train/test fit; r_ref is the
    reference's refit at out['alphas'], and p_perm its permutation
    p-values when the fit's are."""
    nums = {"score_regret": score_regret(scores, grid, out["alphas"]),
            "r_gap": widest_gap(out["r"], r_ref)}
    if p_perm is not None:
        nums["p_flip_share"] = flip_share(out["p"], p_perm, n_permutations)
        return nums
    p_ref = stats.pearson_pvalues(r_ref, n_test)
    nums["p_gap"] = widest_gap(out["p"], p_ref)
    nums["q_gap"] = widest_gap(out["q"], stats.bh_adjust(p_ref))
    return nums


def flip_share(p, p_ref, n_permutations: int) -> float:
    """Share of voxels whose permutation count, p (n + 1) - 1, differs."""
    a = np.rint(np.asarray(p, np.float64) * (n_permutations + 1))
    b = np.rint(np.asarray(p_ref, np.float64) * (n_permutations + 1))
    if a.shape != b.shape:
        return math.inf
    return float(np.mean(a != b))


def full_cv_numbers(out: Dict, r_folds: np.ndarray,
                    test_sizes: Iterable[int]) -> Dict[str, float]:
    """out: 'r', 'p', 'q' of one full-CV fit against the reference's
    per-fold r (k, V)."""
    p_ref = stats.fisher_combine(np.stack([
        stats.pearson_pvalues(r, n) for r, n in zip(r_folds, test_sizes)]))
    return {
        "r_gap": widest_gap(out["r"], r_folds.mean(axis=0)),
        "p_gap": widest_gap(out["p"], p_ref),
        "q_gap": widest_gap(out["q"], stats.bh_adjust(p_ref)),
    }


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(every number finite and within its limit, {name: value, limit})."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok, table

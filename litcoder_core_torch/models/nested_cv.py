"""Nested cross-validation ridge, train/test mode (twin of
litcoder_core_tpu/models/nested_cv.py).

The inner-fold alpha search is the JAX package's Cholesky search
(_find_best_alphas_chol): no eigendecompositions, one Cholesky per
(fold, alpha), the `normalpha` scale from a Lanczos lambda-max. Folds whose
train + val rows cover every row downdate one shared Gram and X^T Y (the
complement form); otherwise the train rows are gathered (the gather form).
A refit on the spectral basis of the whole training design then scores the
held-out set, and the host computes float64 p-values and BH-FDR.

Everything else the JAX fit offers (full-CV mode, the dual, complement-
eigh, batched-spectral and per-fold search paths, voxel chunking,
fast_scan, the normalizers, meshes, permutation significance) raises
NotImplementedError here; ROADMAP.md queues it.
"""

import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.ridge import (
    _score_predictions,
    lmax_dense,
    predict,
    ridge_fit_from_svd,
    ridge_svd,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    pearson_pvalues_f64,
    pearson_r,
    zscore,
)
from litcoder_core_torch.utils.device import as_f32, resolve_device, to_numpy

logger = logging.getLogger(__name__)

Metrics = Dict[str, Union[float, List[float], List[bool]]]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to litcoder_core_torch yet (see ROADMAP.md, "
        "queue A); this slice runs the train/test Cholesky search only"
    )


def _folds_cover_all_rows(fold_splits, n_rows: int) -> bool:
    """True iff every fold's train + val rows are exactly range(n_rows)."""
    for tr, va in fold_splits:
        both = np.concatenate([np.asarray(tr), np.asarray(va)])
        if both.size != n_rows:
            return False
        if not np.array_equal(np.sort(both), np.arange(n_rows)):
            return False
    return True


def _chol_search_eligible(method: str, normalpha: bool, alphas, fold_splits,
                          n_features: int, singcutoff: float = 1e-10) -> bool:
    """Gate for the Cholesky search: explicit 'chol', or 'auto' with
    normalpha, min(alpha) >= 0.03, singcutoff <= 1e-10 and tall folds."""
    if method == "chol":
        return True
    if method != "auto" or not normalpha or singcutoff > 1e-10:
        return False
    a = np.asarray(alphas)
    if not (a.size and np.all(a >= 0.03)):
        return False
    return all(len(tr) >= n_features for tr, _ in fold_splits)


def _chol_factors_from_gram(G: torch.Tensor, Xva: torch.Tensor,
                            alphas: torch.Tensor, normalpha: bool):
    """(Z_all (A, D, Tva), nal (A,)): Z_a = (G + nal_a^2 I)^-1 Xva^T.

    torch.linalg.cholesky raises where jnp.linalg.cholesky returns NaN; the
    factor of a matrix that is not positive definite is made NaN here, so
    its alpha scores 0 downstream exactly as in the JAX package."""
    if normalpha:
        nal = alphas * torch.sqrt(torch.clamp(lmax_dense(G), min=0.0))
    else:
        nal = alphas
    eye = torch.eye(G.shape[0], dtype=torch.float32, device=G.device)
    L, info = torch.linalg.cholesky_ex(G[None] + (nal * nal)[:, None, None]
                                       * eye[None])
    L = torch.where((info > 0)[:, None, None], float("nan"), L)
    XvaT = Xva.T.expand(L.shape[0], -1, -1)
    Z = torch.linalg.solve_triangular(L, XvaT, upper=False)
    return torch.linalg.solve_triangular(L.mT, Z, upper=True), nal


def _score_alphas_from_factors(Z_all: torch.Tensor, XtY: torch.Tensor,
                               Yva: torch.Tensor,
                               use_corr: bool) -> torch.Tensor:
    """(A, V) scores: per alpha, pred = Z_a^T XtY against the val responses
    (one (Tva, V) prediction alive at a time)."""
    zP = zscore(Yva, dim=0)
    Pvar = torch.var(Yva, dim=0, correction=1)
    return torch.stack([
        _score_predictions(Z.T @ XtY, Yva, zP, Pvar, use_corr)
        for Z in Z_all
    ])


def _fold_chol_factors(Xtr: torch.Tensor, Xva: torch.Tensor,
                       alphas: torch.Tensor, normalpha: bool):
    """Gather-form factors (arbitrary fold rows): G_tr = Xtr^T Xtr."""
    return _chol_factors_from_gram(Xtr.T @ Xtr, Xva, alphas, normalpha)


def _score_chunk_chol(Z_all: torch.Tensor, Xtr: torch.Tensor,
                      Ytr: torch.Tensor, Yva: torch.Tensor,
                      use_corr: bool) -> torch.Tensor:
    """Gather-form fold scores: XtY = Xtr^T Ytr."""
    return _score_alphas_from_factors(Z_all, Xtr.T @ Ytr, Yva, use_corr)


def _complement_fold_factors(Xva: torch.Tensor, G_all: torch.Tensor,
                             alphas: torch.Tensor,
                             normalpha: bool) -> torch.Tensor:
    """Complement-form factors: G_tr = G_all - Xva^T Xva, no train gather."""
    Z_all, _ = _chol_factors_from_gram(G_all - Xva.T @ Xva, Xva, alphas,
                                       normalpha)
    return Z_all


def _score_fold_chol_whole_complement(Xva: torch.Tensor, Yva: torch.Tensor,
                                      Z_all: torch.Tensor,
                                      XtY_all: torch.Tensor,
                                      use_corr: bool) -> torch.Tensor:
    """Complement-form fold scores: XtY = XtY_all - Xva^T Yva, with XtY_all
    = X^T Y computed once per fit and shared by every fold."""
    return _score_alphas_from_factors(Z_all, XtY_all - Xva.T @ Yva, Yva,
                                      use_corr)


def _find_best_alphas_chol(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                           alphas: torch.Tensor, normalpha: bool,
                           use_corr: bool) -> torch.Tensor:
    """(A, V) mean inner-fold scores of the Cholesky search, one fold at a
    time (its (A, D, Tva) factors never coexist with another fold's)."""
    dev = X.device
    complement = _folds_cover_all_rows(fold_splits, X.shape[0])
    if complement:
        G_all = X.T @ X    # the JAX package's _full_gram
        XtY_all = X.T @ Y  # and _xty_scan
    corr_sum = torch.zeros((alphas.shape[0], Y.shape[1]), dtype=torch.float32,
                           device=dev)
    for train_idx, val_idx in fold_splits:
        va = torch.as_tensor(np.asarray(val_idx), device=dev)
        Xva, Yva = X[va], Y[va]
        if complement:
            Z_all = _complement_fold_factors(Xva, G_all, alphas, normalpha)
            corr_sum += _score_fold_chol_whole_complement(
                Xva, Yva, Z_all, XtY_all, use_corr)
        else:
            tr = torch.as_tensor(np.asarray(train_idx), device=dev)
            Z_all, _ = _fold_chol_factors(X[tr], Xva, alphas, normalpha)
            corr_sum += _score_chunk_chol(Z_all, X[tr], Y[tr], Yva, use_corr)
        del Z_all
    return corr_sum / len(fold_splits)


def _mean_fold_scores(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                      alphas: np.ndarray, normalpha: bool, use_corr: bool,
                      singcutoff: float, method: str,
                      paths: Dict[str, str]) -> torch.Tensor:
    """(A, V) mean inner-fold scores. Of the JAX package's search paths only
    the Cholesky one is ported; a fit that would take another raises."""
    if not _chol_search_eligible(method, normalpha, alphas, fold_splits,
                                 X.shape[1], singcutoff):
        raise _not_ported(
            f"the alpha search for method={method!r} (normalpha="
            f"{normalpha}, min alpha {float(np.min(alphas)):g}, singcutoff "
            f"{singcutoff:g}, narrowest train fold "
            f"{min(len(tr) for tr, _ in fold_splits)} rows for "
            f"{X.shape[1]} features)"
        )
    logger.info("alpha search path: cholesky (eigensolve-free fold streaming)")
    paths["alpha_search"] = "chol"
    return _find_best_alphas_chol(
        X, Y, fold_splits, torch.as_tensor(alphas, device=X.device),
        normalpha, use_corr,
    )


def _find_best_alphas(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                      alphas: np.ndarray, single_alpha: bool,
                      normalpha: bool, use_corr: bool, singcutoff: float,
                      method: str, paths: Dict[str, str]) -> np.ndarray:
    """Inner-CV alpha search: mean fold score per (alpha, voxel), then the
    argmax (fast_scan is off: float32 scans only in this slice)."""
    paths["fast_scan"] = "off"
    mean_corrs = _mean_fold_scores(X, Y, fold_splits, alphas, normalpha,
                                   use_corr, singcutoff, method, paths)
    return _select_best_alphas(mean_corrs, alphas, single_alpha)


def _select_best_alphas(mean_corrs: torch.Tensor, alphas: np.ndarray,
                        single_alpha: bool) -> np.ndarray:
    """Per-voxel (or global) argmax over mean fold scores; ties go to the
    first alpha, as torch.argmax returns the first maximum."""
    n_voxels = mean_corrs.shape[1]
    if single_alpha:
        best_idx = int(torch.argmax(torch.mean(mean_corrs, dim=1)))
        logger.info("Best single alpha = %.3f for all voxels",
                    alphas[best_idx])
        return np.full(n_voxels, float(alphas[best_idx]), dtype=np.float32)
    best_idx = to_numpy(torch.argmax(mean_corrs, dim=0))
    return np.asarray(alphas, np.float32)[best_idx]


def _fit_and_score(X_train: torch.Tensor, Y_train: torch.Tensor,
                   X_test: torch.Tensor, Y_test: torch.Tensor,
                   valphas: np.ndarray, normalpha: bool, singcutoff: float,
                   return_weights: bool = True
                   ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Refit with per-voxel alphas on the spectral basis of X_train (the
    small side, 'auto'), predict the held-out set, and return (weights (D, V)
    or None, correlations (V,), float64 p-values (V,)) as numpy."""
    svd = ridge_svd(X_train, None, singcutoff=singcutoff, method="auto")
    nalphas = torch.as_tensor(valphas, dtype=torch.float32,
                              device=X_train.device)
    if normalpha:
        nalphas = nalphas * svd.S[0]
    wt = ridge_fit_from_svd(svd, Y_train, nalphas)
    correlations = to_numpy(pearson_r(Y_test, predict(X_test, wt)))
    weights = to_numpy(wt) if return_weights else None
    return (weights, correlations,
            pearson_pvalues_f64(correlations, Y_test.shape[0]))


def fit_nested_cv(
    features,
    targets,
    X_test=None,
    y_test=None,
    groups: Optional[np.ndarray] = None,
    folding_type: str = "chunked",
    n_outer_folds: int = 5,
    n_inner_folds: int = 5,
    chunk_length: int = 20,
    alphas: Optional[List[float]] = None,
    alpha_fdr: float = 0.05,
    use_gpu: bool = True,
    single_alpha: bool = False,
    normalpha: bool = True,
    use_corr: bool = True,
    normalize_features: bool = False,
    normalize_targets: bool = False,
    singcutoff: float = 1e-10,
    seed: int = 0,
    voxel_chunk_size: Optional[int] = None,
    method: str = "auto",
    inner_splits: Optional[List] = None,
    outer_splits: Optional[List] = None,
    return_weights: bool = True,
    fast_scan: bool = False,
    mesh=None,
    n_devices: Optional[int] = None,
    significance: str = "parametric",
    n_permutations: int = 1000,
    device="cuda",
) -> Tuple[Metrics, Optional[np.ndarray], np.ndarray]:
    """Nested-CV ridge fit on `device`, train/test mode.

    The signature is the JAX package's (plus `device`); `use_gpu` is kept
    for API parity and `device` decides. features/targets/X_test/y_test may
    be numpy arrays or tensors.

    Returns:
        (metrics, weights (n_features, n_voxels) or None, best_alphas (V,)),
        all on the host.
    """
    del use_gpu, n_outer_folds, outer_splits
    if method not in ("auto", "chol", "dual", "eigh", "svd"):
        raise ValueError(
            f"method must be one of 'auto', 'chol', 'dual', 'eigh', "
            f"'svd'; got {method!r}"
        )
    if significance not in ("parametric", "permutation"):
        raise ValueError(
            f"significance must be 'parametric' or 'permutation', got "
            f"{significance!r}"
        )
    if fast_scan not in (True, False, "auto"):
        raise ValueError(
            f"fast_scan must be True, False or 'auto', got {fast_scan!r}"
        )
    if X_test is None or y_test is None:
        raise _not_ported("full nested-CV mode (no X_test/y_test)")
    if fast_scan is not False:
        raise _not_ported(f"fast_scan={fast_scan!r}")
    if voxel_chunk_size is not None:
        raise _not_ported("voxel_chunk_size")
    if normalize_features or normalize_targets:
        raise _not_ported("normalize_features/normalize_targets")
    if mesh is not None or n_devices is not None:
        raise _not_ported("mesh/n_devices voxel sharding")
    if significance == "permutation":
        raise _not_ported("significance='permutation'")
    del n_permutations

    dev = resolve_device(device)
    # float32 products in full precision: the JAX package's HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    paths = {"mode": "train_test"}
    if alphas is None:
        alphas = np.logspace(-1, 8, 10)
    alphas = np.asarray(alphas, np.float32)

    X = as_f32(features, dev)
    Y = as_f32(targets, dev)
    X_te = as_f32(X_test, dev)
    Y_te = as_f32(y_test, dev)
    logger.info("Running in train-test mode with provided test set")

    if inner_splits is None:
        inner_splits = create_folds(X.shape[0], folding_type, n_inner_folds,
                                    chunk_length, None, groups, seed=seed)
    best_valphas = _find_best_alphas(X, Y, inner_splits, alphas,
                                     single_alpha, normalpha, use_corr,
                                     singcutoff, method, paths)
    wt, correlations, pvalues = _fit_and_score(
        X, Y, X_te, Y_te, best_valphas, normalpha, singcutoff,
        return_weights=return_weights,
    )
    significant, corrected_pvals = bh_fdrcorrection_np(pvalues,
                                                       alpha=alpha_fdr)
    n_significant = int(np.sum(significant))
    metrics = _create_metrics_dict(
        list(correlations), list(pvalues), corrected_pvals, significant,
        best_valphas, n_significant,
    )
    metrics["solver_paths"] = paths
    logger.info("Median correlation: %.3f", metrics["median_score"])
    return metrics, wt, best_valphas


class NestedCVModel(BasePredictivityModel):
    """Nested-CV ridge model on `device` (reference NestedCVModel API)."""

    def __init__(self, model_name: str = "ridge_regression", seed: int = 0,
                 voxel_chunk_size: Optional[int] = None, device="cuda"):
        super().__init__(model_name)
        self.seed = seed
        self.voxel_chunk_size = voxel_chunk_size
        self.device = device

    def fit_predict(self, features, targets, X_test=None, y_test=None,
                    groups=None, **kwargs):
        kwargs.setdefault("seed", self.seed)
        kwargs.setdefault("voxel_chunk_size", self.voxel_chunk_size)
        kwargs.setdefault("device", self.device)
        return fit_nested_cv(features, targets, X_test=X_test,
                             y_test=y_test, groups=groups, **kwargs)


def _create_metrics_dict(correlations, pvalues, corrected_pvalues,
                         significant_mask, best_alphas,
                         n_significant) -> Metrics:
    """Train-test metrics, keys identical to the JAX package's."""
    correlations_arr = np.asarray(correlations)
    metrics: Metrics = {
        "median_score": float(np.median(correlations_arr)),
        "mean_score": float(np.mean(correlations_arr)),
        "std_score": float(np.std(correlations_arr)),
        "min_score": float(np.min(correlations_arr)),
        "max_score": float(np.max(correlations_arr)),
        "best_alphas": np.asarray(best_alphas).tolist(),
        "correlations": [float(c) for c in correlations],
        "p_values": [float(p) for p in pvalues],
        "corrected_p_values": np.asarray(corrected_pvalues).tolist(),
        "significant_mask": np.asarray(significant_mask).tolist(),
        "n_significant": int(n_significant),
        "percent_significant": float(
            n_significant / len(correlations_arr) * 100
        ),
    }
    if n_significant > 0:
        sig = correlations_arr[np.asarray(significant_mask, bool)]
        metrics.update({
            "median_significant_score": float(np.median(sig)),
            "mean_significant_score": float(np.mean(sig)),
            "min_significant_score": float(np.min(sig)),
            "max_significant_score": float(np.max(sig)),
        })
    return metrics

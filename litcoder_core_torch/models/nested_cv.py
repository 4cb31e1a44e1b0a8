"""Nested cross-validation ridge (twin of litcoder_core_tpu/models/nested_cv.py).

Both modes of the JAX fit:
- train/test mode (X_test/y_test given): inner-fold alpha search on the
  training set, a spectral refit, held-out scoring;
- full nested-CV mode (no test set): outer folds, each with its own inner
  search, refit and held-out scores, then the mean correlation, Fisher-
  combined p-values, BH-FDR and the majority mask. When the outer and inner
  folds are partition-union structured with tall inner folds (chunked
  folding) the fused route computes one union Gram and X^T Y, downdates
  them per outer fold and shares them with its inner folds and its refit;
  otherwise each outer fold is fitted on its gathered rows (per-fold
  route, with the normalizers).

The alpha search has no eigendecompositions: the Cholesky search (one
Cholesky per (fold, alpha), complement or gather form) for tall folds, its
dual (kernel-ridge) twin for wide ones, the `normalpha` scale from a Lanczos
lambda-max. The host computes float64 p-values, Fisher combination and
BH-FDR.

Still to come (ROADMAP.md), raising NotImplementedError: the eigh search
paths (complement-gram, batched spectral, per-fold loop), voxel chunking,
fast_scan, meshes and permutation significance.
"""

import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.normalizer import DataNormalizer
from litcoder_core_torch.models.ridge import (
    _score_predictions,
    lmax_dense,
    predict,
    ridge_fit_from_svd,
    ridge_svd,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    fisher_combine_pvalues_f64,
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
        "queue A)"
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


def _shifted_cholesky(G: torch.Tensor, alphas: torch.Tensor,
                      normalpha: bool):
    """(L (A, n, n), nal (A,)): Cholesky factors of G + nal_a^2 I, with
    nal = alphas * sqrt(lmax(G)) under normalpha.

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
    return torch.where((info > 0)[:, None, None], float("nan"), L), nal


def _cholesky_solve_all(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A, n, m): (L_a L_a^T)^-1 B for every factor, by two triangular
    solves (B (n, m) is shared by all of them)."""
    Z = torch.linalg.solve_triangular(L, B.expand(L.shape[0], -1, -1),
                                      upper=False)
    return torch.linalg.solve_triangular(L.mT, Z, upper=True)


def _chol_factors_from_gram(G: torch.Tensor, Xva: torch.Tensor,
                            alphas: torch.Tensor, normalpha: bool):
    """(Z_all (A, D, Tva), nal (A,)): Z_a = (G + nal_a^2 I)^-1 Xva^T."""
    L, nal = _shifted_cholesky(G, alphas, normalpha)
    return _cholesky_solve_all(L, Xva.T), nal


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


# --- dual (kernel-ridge) Cholesky search, for wide folds (T_tr < D) ---------
#
# pred_a = X_va X_tr^T (K_tr + a^2 I)^-1 Y_tr = M_a^T Y_tr with
# M_a = (K_tr + a^2 I)^-1 K_tr,va: the V-independent factors M_a play the
# role Z_a plays in the primal search, with Y_tr as the cross-product.
# K = X X^T is formed once per search and every fold takes 2-D slices of it.


def _full_kernel(X: torch.Tensor) -> torch.Tensor:
    """K = X X^T, the dual search's one big product."""
    return X @ X.T


def _kernel_blocks(K_full: torch.Tensor, tr: torch.Tensor, va: torch.Tensor):
    """(K_tr (Ttr, Ttr), K_tr,va (Ttr, Tva)) by 2-D gathers; K_full[tr][:, tr]
    would build a (Ttr, T) intermediate first."""
    return K_full[tr[:, None], tr[None, :]], K_full[tr[:, None], va[None, :]]


def _dual_fold_factors(K_full: torch.Tensor, tr: torch.Tensor,
                       va: torch.Tensor, alphas: torch.Tensor,
                       normalpha: bool) -> torch.Tensor:
    """M_all (A, Ttr, Tva), M_a = (K_tr + nal_a^2 I)^-1 K_tr,va. normalpha's
    scale is sqrt(lmax(K_tr)): kernel and Gram share their nonzero spectrum."""
    Ktr, Ktrva = _kernel_blocks(K_full, tr, va)
    L, _ = _shifted_cholesky(Ktr, alphas, normalpha)
    return _cholesky_solve_all(L, Ktrva)


def _score_fold_dual_whole(Y: torch.Tensor, tr: torch.Tensor,
                           va: torch.Tensor, M_all: torch.Tensor,
                           use_corr: bool) -> torch.Tensor:
    """(A, V) dual fold scores: pred_a = M_a^T Y_tr."""
    return _score_alphas_from_factors(M_all, Y[tr], Y[va], use_corr)


def _score_fold_dual_voxel_side(K_full: torch.Tensor, Y: torch.Tensor,
                                tr: torch.Tensor, va: torch.Tensor,
                                alphas: torch.Tensor, normalpha: bool,
                                use_corr: bool) -> torch.Tensor:
    """(A, V) dual fold scores for V < Tva: solve against Y_tr instead of
    K_tr,va, C_a = (K_tr + nal_a^2 I)^-1 Y_tr and pred_a = K_tr,va^T C_a, so
    the solves scale with V rather than the fold width."""
    Ktr, Ktrva = _kernel_blocks(K_full, tr, va)
    Ytr, Yva = Y[tr], Y[va]
    zP = zscore(Yva, dim=0)
    Pvar = torch.var(Yva, dim=0, correction=1)
    L, _ = _shifted_cholesky(Ktr, alphas, normalpha)
    return torch.stack([
        _score_predictions(Ktrva.T @ C, Yva, zP, Pvar, use_corr)
        for C in _cholesky_solve_all(L, Ytr)
    ])


def _find_best_alphas_dual(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                           alphas: torch.Tensor, normalpha: bool,
                           use_corr: bool) -> torch.Tensor:
    """(A, V) mean inner-fold scores of the dual search: one K = X X^T, per
    fold kernel slices and one Cholesky per alpha, no eigendecomposition."""
    dev = X.device
    K_full = _full_kernel(X)
    corr_sum = torch.zeros((alphas.shape[0], Y.shape[1]), dtype=torch.float32,
                           device=dev)
    for train_idx, val_idx in fold_splits:
        tr = torch.as_tensor(np.asarray(train_idx), device=dev)
        va = torch.as_tensor(np.asarray(val_idx), device=dev)
        if Y.shape[1] < len(val_idx):
            corr_sum += _score_fold_dual_voxel_side(K_full, Y, tr, va, alphas,
                                                    normalpha, use_corr)
            continue
        M_all = _dual_fold_factors(K_full, tr, va, alphas, normalpha)
        corr_sum += _score_fold_dual_whole(Y, tr, va, M_all, use_corr)
        del M_all
    return corr_sum / len(fold_splits)


def _dual_search_eligible(method: str, normalpha: bool, alphas, fold_splits,
                          n_features: int, singcutoff: float = 1e-10) -> bool:
    """Gate for the dual search: explicit 'dual', or 'auto' with the
    Cholesky search's alpha and singcutoff conditions and WIDE folds
    (T_tr < D: the (Ttr, Ttr) kernel is the small object)."""
    if method == "dual":
        return True
    if method != "auto" or not normalpha or singcutoff > 1e-10:
        return False
    a = np.asarray(alphas)
    if not (a.size and np.all(a >= 0.03)):
        return False
    return all(len(tr) < n_features for tr, _ in fold_splits)


def _mean_fold_scores(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                      alphas: np.ndarray, normalpha: bool, use_corr: bool,
                      singcutoff: float, method: str,
                      paths: Dict[str, str]) -> torch.Tensor:
    """(A, V) mean inner-fold scores: the Cholesky search when its gate
    holds, else the dual one. The JAX package's eigh paths (complement-gram,
    batched spectral, per-fold loop) are not ported: a fit that would take
    one raises."""
    alphas_t = torch.as_tensor(alphas, device=X.device)
    if _chol_search_eligible(method, normalpha, alphas, fold_splits,
                             X.shape[1], singcutoff):
        logger.info(
            "alpha search path: cholesky (eigensolve-free fold streaming)")
        paths["alpha_search"] = "chol"
        return _find_best_alphas_chol(X, Y, fold_splits, alphas_t, normalpha,
                                      use_corr)
    if _dual_search_eligible(method, normalpha, alphas, fold_splits,
                             X.shape[1], singcutoff):
        logger.info("alpha search path: dual cholesky (kernel-ridge; "
                    "eigensolve-free, wide folds)")
        paths["alpha_search"] = "dual"
        return _find_best_alphas_dual(X, Y, fold_splits, alphas_t, normalpha,
                                      use_corr)
    raise _not_ported(
        f"the eigh alpha search that method={method!r} reaches (normalpha="
        f"{normalpha}, min alpha {float(np.min(alphas)):g}, singcutoff "
        f"{singcutoff:g})"
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


# --- fused full-CV mode (cross-OUTER-fold reuse) -----------------------------
#
# With partitioning outer folds the complement identity spans the outer loop:
#     G_tr(f)   = G_full   - Xte(f)^T Xte(f)
#     XtY_tr(f) = XtY_full - Xte(f)^T Yte(f)
# so the union cross-products are computed once and downdated per outer
# fold, each outer fold's XtY_tr is shared by all of its inner folds, and the
# refit solves from the same downdated Gram and XtY.


def _downdate_outer(X: torch.Tensor, Y: torch.Tensor, G_full: torch.Tensor,
                    XtY_full: torch.Tensor, te: torch.Tensor):
    """(G_full - Xte^T Xte, XtY_full - Xte^T Yte)."""
    Xte = X[te]
    return G_full - Xte.T @ Xte, XtY_full - Xte.T @ Y[te]


def _score_inner_fold_from_gram(X: torch.Tensor, Y: torch.Tensor,
                                va_g: torch.Tensor, lo_g: torch.Tensor,
                                G_tr: torch.Tensor, XtY_tr: torch.Tensor,
                                alphas: torch.Tensor, normalpha: bool,
                                use_corr: bool) -> torch.Tensor:
    """(A, V) one inner fold's scores from its outer fold's training Gram and
    XtY. Only the val block and the inner leftover `lo_g` (outer-train rows
    no inner fold touches, e.g. the chunking remainder) are downdated, inside
    this call, so no third (D, V) buffer outlives it."""
    Xva, Yva, Xlo = X[va_g], Y[va_g], X[lo_g]
    Z_all, _ = _chol_factors_from_gram(G_tr - Xva.T @ Xva - Xlo.T @ Xlo, Xva,
                                       alphas, normalpha)
    XtY_in = XtY_tr - Xva.T @ Yva - Xlo.T @ Y[lo_g]
    return _score_alphas_from_factors(Z_all, XtY_in, Yva, use_corr)


def _refit_score_from_gram(G_tr: torch.Tensor, XtY_tr: torch.Tensor,
                           Xte: torch.Tensor, Yte: torch.Tensor,
                           valphas: torch.Tensor, singcutoff: float,
                           normalpha: bool, return_weights: bool):
    """(weights (D, V) or None, correlations (V,)): the per-voxel-alpha refit
    of ridge_svd('eigh') + ridge_fit_from_svd + predict, from the downdated
    training Gram and XtY instead of the training rows."""
    evals, evecs = torch.linalg.eigh(G_tr)  # ascending
    S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
    Vh = torch.flip(evecs, dims=[1]).T
    good = S > singcutoff
    nal = valphas * S[0] if normalpha else valphas
    inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
    UR = inv_s[:, None] * (Vh @ XtY_tr)  # (k, V)
    shrink = torch.where(good[:, None],
                         S[:, None] / (S[:, None] ** 2 + nal[None, :] ** 2),
                         0.0)
    wt = Vh.T @ (shrink * UR)  # (D, V)
    corr = pearson_r(Yte, Xte @ wt)
    return (wt if return_weights else None), corr


def _folds_partition_union(fold_splits) -> bool:
    """True iff each fold's train rows = union rows minus its val rows (the
    chunked-fold structure the complement identity requires)."""
    union = np.unique(np.concatenate(
        [np.concatenate([tr, va]) for tr, va in fold_splits]
    ))
    union_set = set(union.tolist())
    for tr, va in fold_splits:
        if set(tr.tolist()) != union_set - set(va.tolist()):
            return False
    return True


def _full_cv_fused_eligible(method: str, normalpha: bool, alphas,
                            singcutoff: float, normalize_features: bool,
                            normalize_targets: bool, outer_splits,
                            inner_splits_per_fold, n_features: int) -> bool:
    """Gate for the fused route: partition-union outer folds, partition-union
    inner folds over each outer fold's train rows with tall training blocks,
    the Cholesky search's conditions, and no per-fold normalization (which
    changes the data between outer folds and breaks any reuse)."""
    if method not in ("auto", "chol"):
        return False
    if normalize_features or normalize_targets:
        return False
    if not normalpha or singcutoff > 1e-10:
        return False
    a = np.asarray(alphas)
    if not (a.size and np.all(a >= 0.03)):
        return False
    if not _folds_partition_union(
        [(np.asarray(tr), np.asarray(te)) for tr, te in outer_splits]
    ):
        return False
    for inner in inner_splits_per_fold:
        inner = [(np.asarray(t), np.asarray(v)) for t, v in inner]
        if not _folds_partition_union(inner):
            return False
        if not all(len(itr) >= n_features for itr, _ in inner):
            return False
    return True


def _inner_splits_per_fold(outer_splits, inner_splits, groups,
                           folding_type: str, n_inner_folds: int,
                           chunk_length: int, seed: int) -> List:
    """Inner splits of every outer fold, built up front (the fused gate reads
    their structure): the injected ones (one list for all folds, or a list
    of per-fold lists), group folds over the fold's own groups, or the
    scheme's folds seeded seed + fold_idx + 1."""
    per_fold = []
    for fold_idx, (train_idx, _test_idx) in enumerate(outer_splits):
        if inner_splits is not None:
            fis = (inner_splits[fold_idx]
                   if isinstance(inner_splits[0], list) else inner_splits)
        elif groups is not None and folding_type == "group":
            fis = create_folds(len(train_idx), "group", n_inner_folds,
                               groups=np.asarray(groups)[train_idx],
                               seed=seed + fold_idx + 1)
        else:
            fis = create_folds(len(train_idx), folding_type, n_inner_folds,
                               chunk_length, seed=seed + fold_idx + 1)
        per_fold.append(fis)
    return per_fold


def _fused_outer_fold(X: torch.Tensor, Y: torch.Tensor, G_full: torch.Tensor,
                      XtY_full: torch.Tensor, train_idx, test_idx,
                      inner_splits, alphas: np.ndarray, single_alpha: bool,
                      normalpha: bool, use_corr: bool, singcutoff: float,
                      return_weights: bool):
    """(best alphas (V,), weights (D, V) or None, correlations (V,)) of one
    outer fold on the fused route. Its (D, V) G_tr/XtY_tr are locals, freed
    on return, before the next fold's downdate."""
    dev = X.device
    tr_np = np.asarray(train_idx)
    te = torch.as_tensor(np.asarray(test_idx), device=dev)
    G_tr, XtY_tr = _downdate_outer(X, Y, G_full, XtY_full, te)
    inner_union = np.unique(np.concatenate(
        [np.concatenate([t, v]) for t, v in inner_splits]
    ))
    in_leftover = np.setdiff1d(np.arange(len(tr_np)), inner_union,
                               assume_unique=True)
    lo_g = torch.as_tensor(tr_np[in_leftover], device=dev)
    alphas_t = torch.as_tensor(alphas, device=dev)
    acc = 0
    for _itr, iva in inner_splits:
        va_g = torch.as_tensor(tr_np[np.asarray(iva)], device=dev)
        acc = acc + _score_inner_fold_from_gram(X, Y, va_g, lo_g, G_tr,
                                                XtY_tr, alphas_t, normalpha,
                                                use_corr)
    best_valphas = _select_best_alphas(acc / len(inner_splits), alphas,
                                       single_alpha)
    # The refit uses the whole outer-train Gram/XtY: inner-leftover rows are
    # training rows of this fold.
    wt, corr = _refit_score_from_gram(
        G_tr, XtY_tr, X[te], Y[te],
        torch.as_tensor(best_valphas, device=dev), singcutoff, normalpha,
        return_weights)
    return (best_valphas, to_numpy(wt) if return_weights else None,
            to_numpy(corr))


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
    """Nested-CV ridge fit on `device`: train/test mode when X_test and
    y_test are given, full nested-CV mode otherwise.

    The signature is the JAX package's (plus `device`); `use_gpu` is kept
    for API parity and `device` decides. features/targets/X_test/y_test may
    be numpy arrays or tensors. In full-CV mode `inner_splits` may be one
    list of folds for every outer fold or a list of per-fold lists.

    Returns:
        (metrics, weights (n_features, n_voxels) or None, best_alphas (V,)),
        all on the host; in full-CV mode the weights and alphas are the
        means over the outer folds.
    """
    del use_gpu
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
    if fast_scan is not False:
        raise _not_ported(f"fast_scan={fast_scan!r}")
    if voxel_chunk_size is not None:
        raise _not_ported("voxel_chunk_size")
    if mesh is not None or n_devices is not None:
        raise _not_ported("mesh/n_devices voxel sharding")
    if significance == "permutation":
        raise _not_ported("significance='permutation'")
    del n_permutations

    dev = resolve_device(device)
    # float32 products in full precision: the JAX package's HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    paths: Dict[str, str] = {}
    if alphas is None:
        alphas = np.logspace(-1, 8, 10)
    alphas = np.asarray(alphas, np.float32)
    search = dict(alphas=alphas, single_alpha=single_alpha,
                  normalpha=normalpha, use_corr=use_corr,
                  singcutoff=singcutoff, method=method, paths=paths)
    normalize = normalize_features or normalize_targets

    X = as_f32(features, dev)
    Y = as_f32(targets, dev)

    if X_test is not None and y_test is not None:
        logger.info("Running in train-test mode with provided test set")
        paths["mode"] = "train_test"
        X_te = as_f32(X_test, dev)
        Y_te = as_f32(y_test, dev)
        if normalize:
            normalizer = DataNormalizer(normalize_features, normalize_targets)
            X, Y = normalizer.fit_transform(X, Y)
            X_te, Y_te = normalizer.transform(X_te, Y_te)
        if inner_splits is None:
            inner_splits = create_folds(X.shape[0], folding_type,
                                        n_inner_folds, chunk_length, None,
                                        groups, seed=seed)
        best_valphas = _find_best_alphas(X, Y, inner_splits, **search)
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

    # ---------------- full nested-CV mode ----------------
    logger.info("Running in full nested CV mode")
    if outer_splits is None:
        outer_splits = create_folds(X.shape[0], folding_type, n_outer_folds,
                                    chunk_length, None, groups, seed=seed)
    inner_per_fold = _inner_splits_per_fold(
        outer_splits, inner_splits, groups, folding_type, n_inner_folds,
        chunk_length, seed)
    fused = _full_cv_fused_eligible(
        method, normalpha, alphas, singcutoff, normalize_features,
        normalize_targets, outer_splits, inner_per_fold, X.shape[1])
    if fused:
        logger.info("full-CV path: fused outer-fold streaming (one union "
                    "Gram/XtY downdated per fold)")
        paths.update(mode="full_cv_fused", alpha_search="fused_chol",
                     fast_scan="off")
        G_full = X.T @ X
        XtY_full = X.T @ Y
        # Rows outside the fold-scheme union (the chunking remainder) are in
        # no fold: downdated away once, so G/XtY describe exactly the union.
        union = np.unique(np.concatenate(
            [np.concatenate([tr, te]) for tr, te in outer_splits]))
        leftover = np.setdiff1d(np.arange(X.shape[0]), union,
                                assume_unique=True)
        if leftover.size:
            G_full, XtY_full = _downdate_outer(
                X, Y, G_full, XtY_full, torch.as_tensor(leftover, device=dev))
    else:
        logger.info("full-CV path: per-fold (fused ineligible; see "
                    "_full_cv_fused_eligible for the gates)")
        paths["mode"] = "full_cv_per_fold"

    fold_scores, fold_pvalues, fold_valphas = [], [], []
    fold_significant_masks, fold_weights = [], []
    n_outer = len(outer_splits)  # may differ from n_outer_folds if injected
    for fold_idx, (train_idx, test_idx) in enumerate(outer_splits):
        logger.info("Processing fold %d/%d", fold_idx + 1, n_outer)
        if fused:
            best_valphas, wt, correlations = _fused_outer_fold(
                X, Y, G_full, XtY_full, train_idx, test_idx,
                inner_per_fold[fold_idx], alphas, single_alpha, normalpha,
                use_corr, singcutoff, return_weights)
            pvalues = pearson_pvalues_f64(correlations, len(test_idx))
        else:
            tr = torch.as_tensor(np.asarray(train_idx), device=dev)
            te = torch.as_tensor(np.asarray(test_idx), device=dev)
            X_train, X_te, y_train, y_te = X[tr], X[te], Y[tr], Y[te]
            if normalize:
                normalizer = DataNormalizer(normalize_features,
                                            normalize_targets)
                X_train, y_train = normalizer.fit_transform(X_train, y_train)
                X_te, y_te = normalizer.transform(X_te, y_te)
            best_valphas = _find_best_alphas(
                X_train, y_train, inner_per_fold[fold_idx], **search)
            wt, correlations, pvalues = _fit_and_score(
                X_train, y_train, X_te, y_te, best_valphas, normalpha,
                singcutoff, return_weights=return_weights)
            del X_train, X_te, y_train, y_te
        fold_valphas.append(best_valphas)
        if return_weights:
            fold_weights.append(wt)
        fold_scores.append(correlations)
        fold_pvalues.append(pvalues)
        significant, _ = bh_fdrcorrection_np(pvalues, alpha=alpha_fdr)
        fold_significant_masks.append(significant)
        logger.info("Fold %d/%d - median r: %.3f, significant: %d/%d",
                    fold_idx + 1, n_outer, float(np.median(correlations)),
                    int(np.sum(significant)), len(significant))

    all_correlations = np.mean(fold_scores, axis=0)
    all_pvalues = fisher_combine_pvalues_f64(np.stack(fold_pvalues))
    significant_mask, corrected_pvalues = bh_fdrcorrection_np(
        all_pvalues, alpha=alpha_fdr)
    n_significant = int(np.sum(significant_mask))
    significance_counts = np.sum(fold_significant_masks, axis=0)
    majority_significant_mask = significance_counts >= (n_outer // 2 + 1)
    n_majority_significant = int(np.sum(majority_significant_mask))
    mean_valphas = np.mean(fold_valphas, axis=0)
    mean_weights = np.mean(fold_weights, axis=0) if return_weights else None

    metrics = _create_full_cv_metrics_dict(
        all_correlations, all_pvalues, corrected_pvalues, significant_mask,
        majority_significant_mask, mean_valphas, n_significant,
        n_majority_significant,
    )
    metrics["solver_paths"] = paths
    logger.info("Median correlation: %.3f", metrics["median_score"])
    return metrics, mean_weights, mean_valphas


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


def _create_full_cv_metrics_dict(all_correlations, all_pvalues,
                                 corrected_pvalues, significant_mask,
                                 majority_significant_mask, mean_valphas,
                                 n_significant,
                                 n_majority_significant) -> Metrics:
    """Full-CV metrics, keys identical to the JAX package's."""
    metrics: Metrics = {
        "median_score": float(np.median(all_correlations)),
        "mean_score": float(np.mean(all_correlations)),
        "std_score": float(np.std(all_correlations)),
        "min_score": float(np.min(all_correlations)),
        "max_score": float(np.max(all_correlations)),
        "best_alphas": np.asarray(mean_valphas).tolist(),
        "correlations": np.asarray(all_correlations).tolist(),
        "p_values": np.asarray(all_pvalues).tolist(),
        "corrected_p_values": np.asarray(corrected_pvalues).tolist(),
        "significant_mask": np.asarray(significant_mask).tolist(),
        "majority_significant_mask": np.asarray(
            majority_significant_mask
        ).tolist(),
        "n_significant": int(n_significant),
        "n_majority_significant": int(n_majority_significant),
        "percent_significant": float(
            n_significant / len(all_correlations) * 100
        ),
        "percent_majority_significant": float(
            n_majority_significant / len(all_correlations) * 100
        ),
    }
    if n_significant > 0:
        sig = all_correlations[np.asarray(significant_mask, bool)]
        metrics.update({
            "median_significant_score": float(np.median(sig)),
            "mean_significant_score": float(np.mean(sig)),
            "min_significant_score": float(np.min(sig)),
            "max_significant_score": float(np.max(sig)),
        })
    if n_majority_significant > 0:
        msig = all_correlations[np.asarray(majority_significant_mask, bool)]
        metrics.update({
            "median_majority_significant_score": float(np.median(msig)),
            "mean_majority_significant_score": float(np.mean(msig)),
            "min_majority_significant_score": float(np.min(msig)),
            "max_majority_significant_score": float(np.max(msig)),
        })
    return metrics

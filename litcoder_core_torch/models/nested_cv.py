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

The alpha search takes the JAX package's first eligible path, recorded in
metrics['solver_paths']['alpha_search']:
- 'chol': one Cholesky per (fold, alpha), complement or gather form, the
  `normalpha` scale from a Lanczos lambda-max (tall folds, normalpha,
  min alpha >= 0.03, singcutoff <= 1e-10; or method='chol');
- 'dual': its kernel-ridge twin for wide folds (or method='dual');
- 'complement_eigh': per-fold eigh of the union Gram downdated by the val
  rows (equal-shape, partition-union, tall folds);
- 'spectral_<eigh|dual|svd>': per-fold spectral states (equal shapes);
- 'per_fold_loop_<method>': one ridge_svd per fold (unequal shapes).

`voxel_chunk_size` streams the responses through every path in column
chunks: views of Y (`Y[:, lo:hi]`), never a padded or gathered copy of all
of it; the JAX lax.map over chunks is a Python loop. `fast_scan` runs the
search's voxel-side products (X^T Y and the per-alpha predictions) with
TF32 (True), or guards that scan with an fp32 scan of a calibration voxel
subset ('auto'); the factorizations, the refit and the final scoring stay
fp32, and the fit restores the caller's TF32 setting when it returns.
`significance='permutation'` replaces the parametric tail with
circular-shift permutation p-values whose offsets each fold draws once.
The host computes float64 p-values, Fisher combination and BH-FDR.

`mesh`/`n_devices` shard the voxel axis over a 1-D device mesh
(parallel/mesh.py): the responses pad with zero columns to a multiple of
the mesh size and split into one shard per mesh entry, the stimuli
replicate per distinct device, and every columnwise stage runs shard by
shard on its device. What reads the whole voxel axis (the argmax inputs,
single_alpha's mean, the fast_scan guard's calibration voxels, on the
padded axis as in the JAX package) meets on the first shard's device; the
pad is stripped before the host statistics. A mesh replaces voxel
chunking.

Spans (utils.profiling.annotate; recorded only under a profiler): the fit
is `litcoder.fit`; inside it `litcoder.fit.search` (each alpha search,
counts folds, alphas, voxel_chunks), `litcoder.fit.refit` (refit,
held-out predictions, r and the permutation null, ending with r and p on
the host: that copy is where the host waits for the refit) and
`litcoder.fit.host_stats` (host p-values, BH-FDR, Fisher, the majority
mask, the metrics). `litcoder.fit.weights_to_host` (each voxel chunk's
weights into the host array, through utils.device.copy_to_host's pinned
staging ring on CUDA) nests in the refit. `litcoder.fit.gram` (each X^T X,
X^T Y or X X^T formed) and `litcoder.fit.lmax` (ridge.py) nest in
whichever of those forms them.
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
    ridge_corr_from_svd,
    ridge_fit_from_svd,
    ridge_svd,
    score_alpha_grid,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    fisher_combine_pvalues_f64,
    pearson_pvalues_f64,
    pearson_r,
    permutation_offsets,
    permutation_pvalues,
    zscore,
)
from litcoder_core_torch.utils.device import (
    as_f32,
    copy_to_host,
    matmul_tf32,
    resolve_device,
    to_numpy,
)
from litcoder_core_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

Metrics = Dict[str, Union[float, List[float], List[bool]]]


def _voxel_chunks(n_voxels: int, chunk: Optional[int]):
    """(lo, hi) column ranges of `chunk` voxels (one range when None)."""
    if chunk is None or chunk >= n_voxels:
        return [(0, n_voxels)]
    return [(lo, min(lo + chunk, n_voxels))
            for lo in range(0, n_voxels, chunk)]


def _full_and_tail(call, n_voxels: int, chunk: Optional[int]) -> torch.Tensor:
    """call(lo, hi) over every voxel chunk, concatenated on the last axis.
    (The JAX package dispatches the full chunks and the non-divisible tail
    as two programs so XLA never copies Y; a loop over column views has no
    such hazard, and the tail is just the last chunk.)"""
    parts = [call(lo, hi) for lo, hi in _voxel_chunks(n_voxels, chunk)]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _shard_fit_inputs(X: torch.Tensor, targets, vox_mesh):
    """(X replicas, one per shard, shards of the zero-padded targets): the
    targets pad to a multiple of the mesh size and split on the voxel axis
    (a numpy array goes to the devices block by block), X replicates once
    per distinct device."""
    # Imported here: litcoder_core_torch.parallel imports this module.
    from litcoder_core_torch.parallel.mesh import replicate, shard_padded

    shards = shard_padded(targets, vox_mesh).shards
    X_rep = replicate(X, vox_mesh)
    return [X_rep[y.device] for y in shards], shards


def _as_parts(X, Y):
    """(X parts, Y parts): the voxel axis as a list of column blocks, each
    with the X it is fitted with. A tensor Y is one block; a voxel-sharded
    fit passes its shards (each on its device) and their X replicas."""
    if isinstance(Y, (list, tuple)):
        return list(X), list(Y)
    return [X], [Y]


def _cat_parts(parts) -> torch.Tensor:
    """Per-block results (..., V_i) concatenated on the first one's device
    (the gather of a voxel-sharded fit; one block is returned as it is)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def _take_columns(blocks, idx: np.ndarray) -> torch.Tensor:
    """Columns `idx` (global voxel indices, ascending) of a list of column
    blocks, gathered on the first block's device."""
    out, lo = [], 0
    for b in blocks:
        hi = lo + b.shape[-1]
        sel = idx[(idx >= lo) & (idx < hi)] - lo
        if sel.size:
            out.append(b[..., torch.as_tensor(sel, device=b.device)])
        lo = hi
    return _cat_parts(out)


def _folds_cover_all_rows(fold_splits, n_rows: int) -> bool:
    """True iff every fold's train + val rows are exactly range(n_rows)."""
    for tr, va in fold_splits:
        both = np.concatenate([np.asarray(tr), np.asarray(va)])
        if both.size != n_rows:
            return False
        if not np.array_equal(np.sort(both), np.arange(n_rows)):
            return False
    return True


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


# --- complement-Gram eigh search (equal-shape partition-union folds) --------
#
# With U the union of every fold's rows, each fold's training Gram and
# cross-product are G_U - Xva^T Xva and X_U^T Y - Xva^T Yva: no (F, T_tr, .)
# gathers, one eigh per fold of the downdated Gram.


def _fold_states_complement(X: torch.Tensor, union_idx: torch.Tensor,
                            val_idx: torch.Tensor, singcutoff: float):
    """(S, Vh, good, PVh, Xva), each stacked over the folds (val_idx is
    (F, Tva)), from one batched eigh of the (F, D, D) downdated Grams."""
    Xu = X[union_idx]
    Xva = X[val_idx]                                    # (F, Tva, D)
    with annotate("litcoder.fit.gram"):
        G = (Xu.T @ Xu)[None] - Xva.mT @ Xva
    evals, evecs = torch.linalg.eigh(G)
    S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[-1]), min=0.0))
    Vh = torch.flip(evecs, dims=[-1]).mT
    return S, Vh, S > singcutoff, Xva @ Vh.mT, Xva


def _score_chunk_complement_body(states, X_union: torch.Tensor,
                                 Y_union_chunk: torch.Tensor,
                                 val_pos: torch.Tensor, alphas: torch.Tensor,
                                 normalpha: bool, use_corr: bool,
                                 fast_scan: bool = False) -> torch.Tensor:
    """(A, Vc) mean fold scores for one voxel chunk of the union rows;
    val_pos (F, Tva) are each fold's val rows as positions in the union."""
    S_all, Vh_all, good_all, PVh_all, Xva_all = states
    with annotate("litcoder.fit.gram"):
        XtY = X_union.T @ Y_union_chunk  # (D, Vc), shared by the folds
    acc = 0
    for S, Vh, good, PVh, Xva, vp in zip(S_all, Vh_all, good_all, PVh_all,
                                         Xva_all, val_pos):
        Yva = Y_union_chunk[vp]
        inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
        with annotate("litcoder.fit.gram"):
            XtY_tr = XtY - Xva.T @ Yva
        UR = inv_s[:, None] * (Vh @ XtY_tr)
        nal = alphas * S[0] if normalpha else alphas
        acc = acc + score_alpha_grid(S, good, PVh, UR, Yva, nal,
                                     use_corr=use_corr, fast_scan=fast_scan)
    return acc / S_all.shape[0]


def _score_all_complement(states, X_union: torch.Tensor, Y: torch.Tensor,
                          union_idx: Optional[torch.Tensor],
                          val_pos: torch.Tensor, alphas: torch.Tensor,
                          normalpha: bool, use_corr: bool,
                          chunk: Optional[int],
                          fast_scan: bool = False) -> torch.Tensor:
    """(A, V) complement-eigh scores, voxel chunk by voxel chunk; each
    chunk's union rows are gathered from its column view (union_idx None:
    the union is every row in order, and the view is used as it is)."""
    def one_chunk(lo, hi):
        Yc = Y[:, lo:hi]
        return _score_chunk_complement_body(
            states, X_union, Yc if union_idx is None else Yc[union_idx],
            val_pos, alphas, normalpha, use_corr, fast_scan)

    return _full_and_tail(one_chunk, Y.shape[1], chunk)


# --- per-fold spectral states (equal-shape folds) ---------------------------


def _fold_spectral_states(X: torch.Tensor, train_idx: torch.Tensor,
                          val_idx: torch.Tensor, singcutoff: float,
                          method: str):
    """One RidgeSVD per fold, computed once per search and shared by every
    voxel chunk (the factorization depends only on X). The JAX package
    vmaps the folds; here they are a loop."""
    return [ridge_svd(X[tr], X[va], singcutoff=singcutoff, method=method)
            for tr, va in zip(train_idx, val_idx)]


def _score_chunk_with_states(states, Y_chunk: torch.Tensor,
                             train_idx: torch.Tensor, val_idx: torch.Tensor,
                             alphas: torch.Tensor, normalpha: bool,
                             use_corr: bool) -> torch.Tensor:
    """(A, Vc) mean fold scores of one voxel chunk from the fold states."""
    acc = 0
    for state, tr, va in zip(states, train_idx, val_idx):
        nal = alphas * state.S[0] if normalpha else alphas
        acc = acc + ridge_corr_from_svd(state, Y_chunk[tr], Y_chunk[va], nal,
                                        use_corr=use_corr)
    return acc / len(states)


# --- Cholesky fold-streaming search (no eigendecompositions) ----------------


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
                               Yva: torch.Tensor, use_corr: bool,
                               fast_scan: bool = False) -> torch.Tensor:
    """(A, V) scores: per alpha, pred = Z_a^T XtY against the val responses
    (one (Tva, V) prediction alive at a time; TF32 under fast_scan)."""
    zP = zscore(Yva, dim=0)
    out = []
    for Z in Z_all:
        with matmul_tf32(fast_scan):
            pred = Z.T @ XtY
        out.append(_score_predictions(pred, Yva, zP, use_corr))
    return torch.stack(out)


def _fold_chol_factors(Xtr: torch.Tensor, Xva: torch.Tensor,
                       alphas: torch.Tensor, normalpha: bool):
    """Gather-form factors (arbitrary fold rows): G_tr = Xtr^T Xtr."""
    with annotate("litcoder.fit.gram"):
        G_tr = Xtr.T @ Xtr
    return _chol_factors_from_gram(G_tr, Xva, alphas, normalpha)


def _complement_fold_factors(Xva: torch.Tensor, G_all: torch.Tensor,
                             alphas: torch.Tensor,
                             normalpha: bool) -> torch.Tensor:
    """Complement-form factors: G_tr = G_all - Xva^T Xva, no train gather."""
    with annotate("litcoder.fit.gram"):
        G_tr = G_all - Xva.T @ Xva
    Z_all, _ = _chol_factors_from_gram(G_tr, Xva, alphas, normalpha)
    return Z_all


def _score_fold_voxel_chunks(factors: torch.Tensor, Y: torch.Tensor,
                             use_corr: bool, chunk: Optional[int],
                             fast_scan: bool = False, form: str = "gather",
                             X: Optional[torch.Tensor] = None,
                             tr: Optional[torch.Tensor] = None,
                             va: Optional[torch.Tensor] = None,
                             lo: Optional[torch.Tensor] = None,
                             XtY_base: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """One fold's (A, V) scores, voxel chunk by voxel chunk (one chunk when
    `chunk` is None), from its precomputed per-alpha solve factors (primal
    Z_all or dual M_all): the one scorer behind every Cholesky-family
    search. The chunk's cross-product (a scan product: it feeds only the
    alpha argmax; the refit forms its own in fp32), by `form`:
      'gather'     - Xtr^T Yc[tr] (arbitrary fold rows);
      'complement' - base - Xva^T Yc[va], base = X^T Yc or, when given,
                     the chunk's columns of XtY_base = X^T Y shared by every
                     fold (train rows = all rows minus the val rows: no
                     train gather);
      'gram'       - XtY_base[:, chunk] - Xva^T Yc[va] - Xlo^T Yc[lo]: the
                     fused route's inner fold (XtY_base = the outer fold's
                     downdated X^T Y, `lo` the outer-train rows no inner
                     fold touches, downdated here so no third (D, V) buffer
                     exists);
      'dual'       - none: the dual factors multiply Yc[tr] itself."""
    if form != "dual":
        Xva = X[va]
    if form == "gather":
        Xtr = X[tr]
    if form == "gram":
        Xlo = X[lo]

    def one_chunk(c0, c1):
        Yc = Y[:, c0:c1]
        if form == "dual":
            return _score_alphas_from_factors(factors, Yc[tr], Yc[va],
                                              use_corr, fast_scan)
        Yva_c = Yc[va]
        with matmul_tf32(fast_scan), annotate("litcoder.fit.gram"):
            if form == "gather":
                XtY = Xtr.T @ Yc[tr]
            else:
                base = X.T @ Yc if XtY_base is None else XtY_base[:, c0:c1]
                XtY = base - Xva.T @ Yva_c
                if form == "gram":
                    XtY = XtY - Xlo.T @ Yc[lo]
        return _score_alphas_from_factors(factors, XtY, Yva_c, use_corr,
                                          fast_scan)

    return _full_and_tail(one_chunk, Y.shape[1], chunk)


def _find_best_alphas_chol(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                           alphas: torch.Tensor, normalpha: bool,
                           use_corr: bool,
                           voxel_chunk_size: Optional[int] = None,
                           fast_scan: bool = False) -> torch.Tensor:
    """(A, V) mean inner-fold scores of the Cholesky search, one fold at a
    time (its (A, D, Tva) factors never coexist with another fold's)."""
    dev = X.device
    n_voxels = Y.shape[1]
    complement = _folds_cover_all_rows(fold_splits, X.shape[0])
    XtY_all = None
    if complement:
        # X^T Y is fold-independent; shared only when chunking is off (with
        # chunking on the caller asked for no persistent (D, V) buffer).
        with annotate("litcoder.fit.gram"):
            G_all = X.T @ X  # the JAX package's _full_gram
            if voxel_chunk_size is None or voxel_chunk_size >= n_voxels:
                with matmul_tf32(fast_scan):
                    XtY_all = X.T @ Y  # _xty_scan
    corr_sum = torch.zeros((alphas.shape[0], n_voxels), dtype=torch.float32,
                           device=dev)
    for train_idx, val_idx in fold_splits:
        va = torch.as_tensor(np.asarray(val_idx), device=dev)
        tr = torch.as_tensor(np.asarray(train_idx), device=dev)
        if complement:
            Z_all = _complement_fold_factors(X[va], G_all, alphas, normalpha)
        else:
            Z_all, _ = _fold_chol_factors(X[tr], X[va], alphas, normalpha)
        corr_sum += _score_fold_voxel_chunks(
            Z_all, Y, use_corr, voxel_chunk_size, fast_scan,
            form="complement" if complement else "gather", X=X, tr=tr, va=va,
            XtY_base=XtY_all)
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
    with annotate("litcoder.fit.gram"):
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


def _score_fold_dual_voxel_side(K_full: torch.Tensor, Y: torch.Tensor,
                                tr: torch.Tensor, va: torch.Tensor,
                                alphas: torch.Tensor, normalpha: bool,
                                use_corr: bool,
                                fast_scan: bool = False) -> torch.Tensor:
    """(A, V) dual fold scores for V < Tva: solve against Y_tr instead of
    K_tr,va, C_a = (K_tr + nal_a^2 I)^-1 Y_tr and pred_a = K_tr,va^T C_a, so
    the solves scale with V rather than the fold width."""
    Ktr, Ktrva = _kernel_blocks(K_full, tr, va)
    Ytr, Yva = Y[tr], Y[va]
    zP = zscore(Yva, dim=0)
    L, _ = _shifted_cholesky(Ktr, alphas, normalpha)
    out = []
    for C in _cholesky_solve_all(L, Ytr):
        with matmul_tf32(fast_scan):
            pred = Ktrva.T @ C
        out.append(_score_predictions(pred, Yva, zP, use_corr))
    return torch.stack(out)


def _find_best_alphas_dual(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                           alphas: torch.Tensor, normalpha: bool,
                           use_corr: bool,
                           voxel_chunk_size: Optional[int] = None,
                           fast_scan: bool = False,
                           total_voxels: Optional[int] = None
                           ) -> torch.Tensor:
    """(A, V) mean inner-fold scores of the dual search: one K = X X^T, per
    fold kernel slices and one Cholesky per alpha, no eigendecomposition.
    The solve side follows `total_voxels` (a voxel shard's whole axis, as
    the JAX package's sharded program sees it; default Y's width)."""
    dev = X.device
    n_voxels = Y.shape[1]
    total = n_voxels if total_voxels is None else total_voxels
    whole = voxel_chunk_size is None or voxel_chunk_size >= n_voxels
    K_full = _full_kernel(X)
    corr_sum = torch.zeros((alphas.shape[0], n_voxels), dtype=torch.float32,
                           device=dev)
    for train_idx, val_idx in fold_splits:
        tr = torch.as_tensor(np.asarray(train_idx), device=dev)
        va = torch.as_tensor(np.asarray(val_idx), device=dev)
        if whole and total < len(val_idx):
            corr_sum += _score_fold_dual_voxel_side(K_full, Y, tr, va, alphas,
                                                    normalpha, use_corr,
                                                    fast_scan)
            continue
        M_all = _dual_fold_factors(K_full, tr, va, alphas, normalpha)
        corr_sum += _score_fold_voxel_chunks(M_all, Y, use_corr,
                                             voxel_chunk_size, fast_scan,
                                             form="dual", tr=tr, va=va)
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
                      singcutoff: float, voxel_chunk_size: Optional[int],
                      method: str, fast_scan: bool,
                      paths: Dict[str, str],
                      total_voxels: Optional[int] = None) -> torch.Tensor:
    """(A, V) mean inner-fold scores on the first eligible search path, in
    the JAX package's order: Cholesky, dual, complement-gram eigh (equal
    partition-union folds), per-fold spectral states (equal shapes), the
    per-fold loop. `total_voxels`: see _find_best_alphas_dual."""
    dev = X.device
    n_voxels = Y.shape[1]
    alphas_t = torch.as_tensor(alphas, device=dev)
    shapes = {(len(tr), len(va)) for tr, va in fold_splits}
    ttr = next(iter(shapes))[0] if len(shapes) == 1 else 0
    resolved = method
    if resolved == "auto":
        # The spectral fallback factors the small side: Gram eigh when tall,
        # kernel ('dual') eigh when wide.
        resolved = "eigh" if ttr >= X.shape[1] else "dual"

    if _chol_search_eligible(method, normalpha, alphas, fold_splits,
                             X.shape[1], singcutoff):
        logger.info(
            "alpha search path: cholesky (eigensolve-free fold streaming)")
        paths["alpha_search"] = "chol"
        return _find_best_alphas_chol(X, Y, fold_splits, alphas_t, normalpha,
                                      use_corr, voxel_chunk_size, fast_scan)
    if _dual_search_eligible(method, normalpha, alphas, fold_splits,
                             X.shape[1], singcutoff):
        logger.info("alpha search path: dual cholesky (kernel-ridge; "
                    "eigensolve-free, wide folds)")
        paths["alpha_search"] = "dual"
        return _find_best_alphas_dual(X, Y, fold_splits, alphas_t, normalpha,
                                      use_corr, voxel_chunk_size, fast_scan,
                                      total_voxels)
    if (len(shapes) == 1 and resolved == "eigh"
            and _folds_partition_union(fold_splits)):
        logger.info(
            "alpha search path: complement-gram eigh (per-fold eigensolves;"
            " the faster cholesky path needs normalpha=True, min(alpha) >="
            " 0.03, singcutoff <= 1e-10, tall folds)")
        paths["alpha_search"] = "complement_eigh"
        union = np.unique(np.concatenate(
            [np.concatenate([tr, va]) for tr, va in fold_splits]))
        val_pos = torch.as_tensor(np.stack(
            [np.searchsorted(union, va) for _, va in fold_splits]),
            device=dev)
        va_idx = torch.as_tensor(np.stack([va for _, va in fold_splits]),
                                 device=dev)
        union_t = torch.as_tensor(union, device=dev)
        states = _fold_states_complement(X, union_t, va_idx, singcutoff)
        every_row = np.array_equal(union, np.arange(X.shape[0]))
        return _score_all_complement(
            states, X if every_row else X[union_t], Y,
            None if every_row else union_t, val_pos, alphas_t, normalpha,
            use_corr, voxel_chunk_size, fast_scan)
    if len(shapes) == 1:
        logger.info("alpha search path: batched per-fold spectral (%s)",
                    resolved)
        paths["alpha_search"] = f"spectral_{resolved}"
        tr_idx = torch.as_tensor(np.stack([tr for tr, _ in fold_splits]),
                                 device=dev)
        va_idx = torch.as_tensor(np.stack([va for _, va in fold_splits]),
                                 device=dev)
        states = _fold_spectral_states(X, tr_idx, va_idx, singcutoff,
                                       resolved)
        return _full_and_tail(
            lambda lo, hi: _score_chunk_with_states(
                states, Y[:, lo:hi], tr_idx, va_idx, alphas_t, normalpha,
                use_corr),
            n_voxels, voxel_chunk_size)
    logger.info("alpha search path: per-fold python loop (unequal fold "
                "shapes)")
    paths["alpha_search"] = f"per_fold_loop_{method}"
    corr_sum = torch.zeros((len(alphas), n_voxels), dtype=torch.float32,
                           device=dev)
    for train_idx, val_idx in fold_splits:
        tr = torch.as_tensor(np.asarray(train_idx), device=dev)
        va = torch.as_tensor(np.asarray(val_idx), device=dev)
        svd = ridge_svd(X[tr], X[va], singcutoff=singcutoff, method=method)
        nal = alphas_t * svd.S[0] if normalpha else alphas_t
        corr_sum += _full_and_tail(
            lambda lo, hi: ridge_corr_from_svd(
                svd, Y[:, lo:hi][tr], Y[:, lo:hi][va], nal,
                use_corr=use_corr),
            n_voxels, voxel_chunk_size)
    return corr_sum / len(fold_splits)


# --- fast_scan='auto': the TF32 scan guarded by an fp32 calibration scan ----

FAST_SCAN_AGREE_THRESHOLD = 0.98
FAST_SCAN_CALIB_VOXELS = 512


def _calib_voxels(n_voxels: int) -> np.ndarray:
    """Evenly spaced calibration voxel indices for the fast_scan guard."""
    return np.unique(np.linspace(
        0, n_voxels - 1, min(FAST_SCAN_CALIB_VOXELS, n_voxels), dtype=int))


def _fast_scan_accept(scores_fast: torch.Tensor, calib_scores: torch.Tensor,
                      calib: np.ndarray, label: str = "") -> bool:
    """The fast_scan='auto' decision (one policy for the plain search and the
    fused full-CV folds): the per-voxel argmax of the fast scan on the
    calibration voxels against that of an fp32 scan of them; accept when at
    least FAST_SCAN_AGREE_THRESHOLD agree (the picks a reduced-precision
    pass can flip are near-ties between adjacent alphas)."""
    v = scores_fast.shape[-1]
    pick_fast = to_numpy(torch.argmax(scores_fast.reshape(-1, v), dim=0))
    pick_cal = to_numpy(torch.argmax(calib_scores.reshape(-1, calib.size),
                                     dim=0))
    agree = float(np.mean(pick_fast[calib] == pick_cal))
    if agree >= FAST_SCAN_AGREE_THRESHOLD:
        logger.info(
            "fast_scan='auto'%s: TF32 scan ACCEPTED (calibration argmax "
            "agreement %.1f%% on %d voxels)", label, agree * 100, calib.size)
        return True
    logger.info(
        "fast_scan='auto'%s: TF32 scan REJECTED (agreement %.1f%% < %.0f%%);"
        " re-running in fp32", label, agree * 100,
        FAST_SCAN_AGREE_THRESHOLD * 100)
    return False


def _find_best_alphas(X: torch.Tensor, Y: torch.Tensor, fold_splits,
                      alphas: np.ndarray, single_alpha: bool,
                      normalpha: bool, use_corr: bool, singcutoff: float,
                      voxel_chunk_size: Optional[int], method: str,
                      fast_scan, paths: Dict[str, str]) -> np.ndarray:
    """Inner-CV alpha search: mean fold score per (alpha, voxel), then the
    argmax. fast_scan: False (fp32 scan), True (TF32 scan products), or
    'auto' (the TF32 scan over every voxel, accepted only if its picks on
    a calibration subset agree with an fp32 scan of that subset; otherwise
    the whole search reruns in fp32). X and Y may be per-shard lists (see
    _as_parts): the scores of every shard meet on the first shard's device
    before the argmax, the calibration columns too, so single_alpha's mean
    and the guard see the whole voxel axis."""
    search = (fold_splits, alphas, normalpha, use_corr, singcutoff)
    Xp, Yp = _as_parts(X, Y)
    total = sum(y.shape[1] for y in Yp)

    def scores(fast: bool) -> torch.Tensor:
        return _cat_parts([
            _mean_fold_scores(x, y, *search, voxel_chunk_size, method, fast,
                              paths, total) for x, y in zip(Xp, Yp)])

    with _search_span(fold_splits, alphas, Yp, voxel_chunk_size):
        if fast_scan != "auto":
            paths["fast_scan"] = "bf16" if fast_scan else "off"
            return _select_best_alphas(scores(bool(fast_scan)), alphas,
                                       single_alpha)
        mc_fast = scores(True)
        calib = _calib_voxels(mc_fast.shape[1])
        mc_cal = _mean_fold_scores(Xp[0], _take_columns(Yp, calib), *search,
                                   None, method, False, paths)
        if _fast_scan_accept(mc_fast, mc_cal, calib):
            paths["fast_scan"] = "auto_accepted"
            return _select_best_alphas(mc_fast, alphas, single_alpha)
        paths["fast_scan"] = "auto_rejected"
        del mc_fast
        return _select_best_alphas(scores(False), alphas, single_alpha)


def _search_span(fold_splits, alphas, Y_parts, voxel_chunk_size) -> annotate:
    """The span of one alpha search over `fold_splits` and the column
    blocks `Y_parts`."""
    return annotate("litcoder.fit.search", folds=len(fold_splits),
                    alphas=len(alphas),
                    voxel_chunks=sum(len(_voxel_chunks(y.shape[1],
                                                       voxel_chunk_size))
                                     for y in Y_parts))


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


# --- refit and held-out scoring ---------------------------------------------


def _permutation_offsets(seed: int, fold_idx: Optional[int],
                         n_permutations: int, n_samples: int) -> torch.Tensor:
    """The circular-shift offsets of one fold's permutation test (fold_idx
    None: train/test mode), shared by every voxel chunk of the fold. Each
    fold has its own stream, as the JAX package's fold_in(PRNGKey(seed),
    fold_idx): a CPU torch.Generator seeded from (seed, fold_idx) through
    numpy's SeedSequence, so the card and the CPU draw the same offsets."""
    entropy = [seed] if fold_idx is None else [seed, fold_idx]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return permutation_offsets(n_permutations, n_samples,
                               torch.Generator().manual_seed(int(state)))


def _score_held_out(Yte: torch.Tensor, pred: torch.Tensor,
                    perm_offsets: Optional[torch.Tensor]):
    """(correlations, permutation p-values or None)."""
    if perm_offsets is None:
        return pearson_r(Yte, pred), None
    p, obs = permutation_pvalues(Yte, pred, perm_offsets)
    return obs, p


def _weights_to_host(dst: np.ndarray, wt: torch.Tensor) -> None:
    """One voxel chunk's weights into its columns of the host weights, in
    the span `litcoder.fit.weights_to_host` (bytes, blocks, and staged: 1
    through the pinned staging ring on CUDA, 0 on the CPU)."""
    with annotate("litcoder.fit.weights_to_host", bytes=dst.nbytes,
                  staged=int(wt.is_cuda)) as span:
        span.counts["blocks"] = copy_to_host(dst, wt)


def _fit_and_score(X_train: torch.Tensor, Y_train: torch.Tensor,
                   X_test: torch.Tensor, Y_test: torch.Tensor,
                   valphas: np.ndarray, normalpha: bool, singcutoff: float,
                   voxel_chunk_size: Optional[int] = None,
                   method: str = "auto", return_weights: bool = True,
                   perm_offsets: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Refit with per-voxel alphas on one spectral state of X_train, predict
    the held-out set and score it, voxel chunk by voxel chunk (each chunk's
    weights go into its columns of one host array). Returns (weights (D, V)
    or None, correlations (V,), float64 p-values (V,)): parametric from the
    host tail, or with perm_offsets the permutation test (one-sided on r).

    'chol'/'dual' are search methods; the refit factors whichever side of
    X_train is smaller ('auto'), other methods factor as asked. Per-shard
    lists (see _as_parts) are refitted shard by shard, on the host after."""
    Xp, Yp = _as_parts(X_train, Y_train)
    Xtp, Ytp = _as_parts(X_test, Y_test)
    if len(Yp) > 1:
        bounds = np.cumsum([0] + [y.shape[1] for y in Yp])
        outs = [_fit_and_score(x, y, xt, yt, valphas[lo:hi], normalpha,
                               singcutoff, voxel_chunk_size, method,
                               return_weights, perm_offsets)
                for x, y, xt, yt, lo, hi in zip(Xp, Yp, Xtp, Ytp, bounds[:-1],
                                                bounds[1:])]
        return ((np.concatenate([o[0] for o in outs], axis=1)
                 if return_weights else None),
                np.concatenate([o[1] for o in outs]),
                np.concatenate([o[2] for o in outs]))
    X_train, Y_train, X_test, Y_test = Xp[0], Yp[0], Xtp[0], Ytp[0]
    svd_method = "auto" if method in ("chol", "dual") else method
    with annotate("litcoder.fit.refit"):
        svd = ridge_svd(X_train, None, singcutoff=singcutoff,
                        method=svd_method)
        nalphas = torch.as_tensor(valphas, dtype=torch.float32,
                                  device=X_train.device)
        if normalpha:
            nalphas = nalphas * svd.S[0]
        weights = (np.empty((X_train.shape[1], Y_train.shape[1]),
                            np.float32) if return_weights else None)
        corr_parts, p_parts = [], []
        for lo, hi in _voxel_chunks(Y_train.shape[1], voxel_chunk_size):
            wt = ridge_fit_from_svd(svd, Y_train[:, lo:hi], nalphas[lo:hi])
            corr, p = _score_held_out(Y_test[:, lo:hi], predict(X_test, wt),
                                      perm_offsets)
            corr_parts.append(corr)
            p_parts.append(p)
            if return_weights:
                _weights_to_host(weights[:, lo:hi], wt)
            del wt
        correlations = to_numpy(torch.cat(corr_parts))
        pvalues = (None if perm_offsets is None
                   else to_numpy(torch.cat(p_parts)).astype(np.float64))
    if pvalues is None:
        with annotate("litcoder.fit.host_stats"):
            pvalues = pearson_pvalues_f64(correlations, Y_test.shape[0])
    return weights, correlations, pvalues


# --- fused full-CV mode (cross-OUTER-fold reuse) -----------------------------
#
# With partitioning outer folds the complement identity spans the outer loop:
#     G_tr(f)   = G_full   - Xte(f)^T Xte(f)
#     XtY_tr(f) = XtY_full - Xte(f)^T Yte(f)
# so the union cross-products are computed once and downdated per outer
# fold, each outer fold's XtY_tr is shared by all of its inner folds, and the
# refit solves from the same downdated Gram and XtY.


def _downdate_outer(X: torch.Tensor, Y: torch.Tensor, G_full: torch.Tensor,
                    XtY_full: torch.Tensor, te: torch.Tensor,
                    chunk: Optional[int] = None):
    """(G_full - Xte^T Xte, XtY_full - Xte^T Yte), the (Tte, V) test-row
    gather streamed in voxel chunks of `chunk` (None: one chunk): XtY_tr
    starts as a copy of XtY_full and each chunk's columns are downdated in
    place (the JAX package's _downdate_outer_chunked fori_loop carry; its
    separate tail dispatch, _downdate_xty_tail, is the loop's last chunk
    here)."""
    with annotate("litcoder.fit.gram"):
        Xte = X[te]
        XtY_tr = XtY_full.clone()
        for lo, hi in _voxel_chunks(Y.shape[1], chunk):
            XtY_tr[:, lo:hi] -= Xte.T @ Y[:, lo:hi][te]
        return G_full - Xte.T @ Xte, XtY_tr


def _inner_fold_factors_from_gram(X: torch.Tensor, va_g: torch.Tensor,
                                  lo_g: torch.Tensor, G_tr: torch.Tensor,
                                  alphas: torch.Tensor,
                                  normalpha: bool) -> torch.Tensor:
    """One inner fold's per-alpha solve factors from its outer fold's
    training Gram, downdated by the inner val rows and the inner leftover
    `lo_g` (outer-train rows no inner fold touches)."""
    Xva, Xlo = X[va_g], X[lo_g]
    with annotate("litcoder.fit.gram"):
        G_inner = G_tr - Xva.T @ Xva - Xlo.T @ Xlo
    Z_all, _ = _chol_factors_from_gram(G_inner, Xva, alphas, normalpha)
    return Z_all


def _score_inner_fold_from_gram(X: torch.Tensor, Y: torch.Tensor,
                                va_g: torch.Tensor, lo_g: torch.Tensor,
                                G_tr: torch.Tensor, XtY_tr: torch.Tensor,
                                alphas: torch.Tensor, normalpha: bool,
                                use_corr: bool, fast_scan: bool = False,
                                chunk: Optional[int] = None) -> torch.Tensor:
    """(A, V) one inner fold's scores from its outer fold's training Gram and
    XtY, in voxel chunks of `chunk`. Only the val block and the inner
    leftover are downdated, chunk by chunk, so no third (D, V) buffer
    exists."""
    Z_all = _inner_fold_factors_from_gram(X, va_g, lo_g, G_tr, alphas,
                                          normalpha)
    return _score_fold_voxel_chunks(Z_all, Y, use_corr, chunk, fast_scan,
                                    form="gram", X=X, va=va_g, lo=lo_g,
                                    XtY_base=XtY_tr)


def _refit_state_from_gram(G_tr: torch.Tensor, singcutoff: float):
    """(S, Vh, good, inv_s) of ridge_svd('eigh') from a training Gram."""
    evals, evecs = torch.linalg.eigh(G_tr)  # ascending
    S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
    good = S > singcutoff
    inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
    return S, torch.flip(evecs, dims=[1]).T, good, inv_s


def _weights_from_state(state, XtY: torch.Tensor,
                        nal: torch.Tensor) -> torch.Tensor:
    """(D, V) refit weights V S/(S^2 + nal^2) S^-1 V^T XtY, per-voxel nal."""
    S, Vh, good, inv_s = state
    UR = inv_s[:, None] * (Vh @ XtY)  # (k, V)
    shrink = torch.where(good[:, None],
                         S[:, None] / (S[:, None] ** 2 + nal[None, :] ** 2),
                         0.0)
    return Vh.T @ (shrink * UR)


def _refit_score_from_gram(G_tr: torch.Tensor, XtY_tr: torch.Tensor,
                           Xte: torch.Tensor, Y: torch.Tensor,
                           te: torch.Tensor, valphas: torch.Tensor,
                           singcutoff: float, normalpha: bool,
                           return_weights: bool,
                           perm_offsets: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None):
    """(weights (D, V) on the host or None, correlations (V,), permutation
    p-values or None): the per-voxel-alpha refit of ridge_svd('eigh') +
    ridge_fit_from_svd + predict, from the downdated training Gram and XtY
    instead of the training rows. One eigh, then per voxel chunk of `chunk`
    (None: one chunk) its weights, predictions of the test rows `te` and
    scores; weights go to the host chunk by chunk, into one array, as in
    _fit_and_score."""
    state = _refit_state_from_gram(G_tr, singcutoff)
    nal = valphas * state[0][0] if normalpha else valphas
    weights = (np.empty(XtY_tr.shape, np.float32) if return_weights
               else None)
    corr_parts, p_parts = [], []
    for lo, hi in _voxel_chunks(Y.shape[1], chunk):
        wt = _weights_from_state(state, XtY_tr[:, lo:hi], nal[lo:hi])
        corr, p = _score_held_out(Y[:, lo:hi][te], Xte @ wt, perm_offsets)
        corr_parts.append(corr)
        p_parts.append(p)
        if return_weights:
            _weights_to_host(weights[:, lo:hi], wt)
        del wt
    return (weights, torch.cat(corr_parts),
            None if perm_offsets is None else torch.cat(p_parts))


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


def _fused_outer_fold(X, Y, G_full, XtY_full, train_idx, test_idx,
                      inner_splits, alphas: np.ndarray, single_alpha: bool,
                      normalpha: bool, use_corr: bool, singcutoff: float,
                      return_weights: bool,
                      voxel_chunk_size: Optional[int] = None,
                      fast_scan=False,
                      perm_offsets: Optional[torch.Tensor] = None,
                      fold_idx: int = 0,
                      paths: Optional[Dict[str, str]] = None):
    """(best alphas (V,), weights (D, V) or None, correlations (V,),
    permutation p-values or None) of one outer fold on the fused route. Its
    (D, V) G_tr/XtY_tr are locals, freed on return, before the next fold's
    downdate. With a voxel_chunk_size the downdate, the inner scoring and
    the refit stream voxel chunks; fast_scan='auto' calibrates this fold's
    TF32 scan on its own. X, Y, G_full and XtY_full may be per-shard lists
    (see _as_parts): each shard is downdated, scored and refitted on its
    device, and the scores meet before the argmax."""
    Xp, Yp = _as_parts(X, Y)
    Gp, XtYp = _as_parts(G_full, XtY_full)
    tr_np = np.asarray(train_idx)
    inner_union = np.unique(np.concatenate(
        [np.concatenate([t, v]) for t, v in inner_splits]
    ))
    in_leftover = np.setdiff1d(np.arange(len(tr_np)), inner_union,
                               assume_unique=True)
    shards = []
    for x, y, g, xty in zip(Xp, Yp, Gp, XtYp):
        dev = x.device
        te = torch.as_tensor(np.asarray(test_idx), device=dev)
        G_tr, XtY_tr = _downdate_outer(x, y, g, xty, te, voxel_chunk_size)
        shards.append(dict(
            X=x, Y=y, te=te, G_tr=G_tr, XtY_tr=XtY_tr,
            lo_g=torch.as_tensor(tr_np[in_leftover], device=dev),
            alphas=torch.as_tensor(alphas, device=dev),
            va_gs=[torch.as_tensor(tr_np[np.asarray(iva)], device=dev)
                   for _itr, iva in inner_splits]))

    def inner_scores(sh, Yf, XtYf, fs):
        acc = 0
        for va_g in sh["va_gs"]:
            acc = acc + _score_inner_fold_from_gram(
                sh["X"], Yf, va_g, sh["lo_g"], sh["G_tr"], XtYf,
                sh["alphas"], normalpha, use_corr, fs, voxel_chunk_size)
        return acc / len(sh["va_gs"])

    def all_scores(fs):
        return _cat_parts([inner_scores(sh, sh["Y"], sh["XtY_tr"], fs)
                           for sh in shards])

    with _search_span(inner_splits, alphas, Yp, voxel_chunk_size):
        mean_corrs = all_scores(bool(fast_scan))
        if fast_scan == "auto":
            # The fold's calibration: its downdated XtY restricted to the
            # calibration columns (every op is columnwise).
            calib = _calib_voxels(mean_corrs.shape[1])
            mc_cal = inner_scores(
                shards[0], _take_columns([sh["Y"] for sh in shards], calib),
                _take_columns([sh["XtY_tr"] for sh in shards], calib), False)
            if _fast_scan_accept(
                    mean_corrs, mc_cal, calib,
                    label=f" (fused full-CV fold {fold_idx + 1})"):
                paths["fast_scan"] = "auto_accepted"
            else:
                paths["fast_scan"] = "auto_rejected"
                mean_corrs = all_scores(False)
        best_valphas = _select_best_alphas(mean_corrs, alphas, single_alpha)
        del mean_corrs
    # The refit uses the whole outer-train Gram/XtY: inner-leftover rows are
    # training rows of this fold.
    wts, corrs, perm_ps = [], [], []
    lo = 0
    with annotate("litcoder.fit.refit"):
        for sh in shards:
            hi = lo + sh["Y"].shape[1]
            wt, corr, perm_p = _refit_score_from_gram(
                sh["G_tr"], sh["XtY_tr"], sh["X"][sh["te"]], sh["Y"],
                sh["te"],
                torch.as_tensor(best_valphas[lo:hi], device=sh["X"].device),
                singcutoff, normalpha, return_weights, perm_offsets,
                voxel_chunk_size)
            wts.append(wt)
            corrs.append(to_numpy(corr))
            perm_ps.append(None if perm_p is None else to_numpy(perm_p))
            lo = hi
    return (best_valphas,
            (wts[0] if len(wts) == 1 else np.concatenate(wts, axis=1))
            if return_weights else None,
            np.concatenate(corrs),
            None if perm_offsets is None
            else np.concatenate(perm_ps).astype(np.float64))


# The fit runs in full fp32 (the JAX package's Precision.HIGHEST) and gives
# the caller back its TF32 setting on return, exceptions included; a fast
# scan turns TF32 on around its own products only.
@matmul_tf32(False)
@annotate("litcoder.fit")
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
    fast_scan: Union[bool, str] = False,
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
    `voxel_chunk_size` bounds device memory by streaming voxel columns;
    `fast_scan` (False, True or 'auto') runs the alpha search's voxel-side
    products with TF32; `significance='permutation'` gives one-sided
    circular-shift p-values from `n_permutations` shifts per fold, floored
    at 1/(n_permutations + 1), and adds metrics['significance_method'].
    `mesh`/`n_devices` (a 1-D voxel Mesh, or a device count: the first n
    cards, or n entries of the CPU for a CPU fit) shard the voxel axis and
    replace voxel chunking; the log says "voxel-sharded fit: V voxels (+P
    pad) over N devices".

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
    from litcoder_core_torch.parallel.mesh import resolve_voxel_mesh

    dev = resolve_device(device)
    vox_mesh = resolve_voxel_mesh(mesh, n_devices, "fit_nested_cv", dev)
    n_perm = n_permutations if significance == "permutation" else 0
    paths: Dict[str, str] = {}
    if alphas is None:
        alphas = np.logspace(-1, 8, 10)
    alphas = np.asarray(alphas, np.float32)
    normalize = normalize_features or normalize_targets

    X = as_f32(features, dev)
    n_voxels_orig = targets.shape[1]
    if vox_mesh is None:
        Y = as_f32(targets, dev)
    else:
        if voxel_chunk_size is not None:
            logger.info(
                "mesh sharding replaces voxel chunking (per-device memory "
                "is already V/%d); ignoring voxel_chunk_size=%d",
                vox_mesh.size, voxel_chunk_size,
            )
            voxel_chunk_size = None
        X, Y = _shard_fit_inputs(X, targets, vox_mesh)
        logger.info(
            "voxel-sharded fit: %d voxels (+%d pad) over %d devices",
            n_voxels_orig, sum(y.shape[1] for y in Y) - n_voxels_orig,
            vox_mesh.size,
        )
    search = dict(alphas=alphas, single_alpha=single_alpha,
                  normalpha=normalpha, use_corr=use_corr,
                  singcutoff=singcutoff, voxel_chunk_size=voxel_chunk_size,
                  method=method, fast_scan=fast_scan, paths=paths)
    Xp, Yp = _as_parts(X, Y)

    def strip(*arrays):
        # The sharding pad goes BEFORE any decision statistic: padded zero
        # columns carry p=1 and would move the BH threshold.
        return [None if a is None else a[..., :n_voxels_orig]
                for a in arrays]

    def normalized(parts):
        """Per-shard (X_train, y_train, X_te, y_te), z-scored with the
        training statistics when asked (columnwise in V)."""
        out = []
        for x_tr, y_tr, x_te, y_te in parts:
            if normalize:
                normalizer = DataNormalizer(normalize_features,
                                            normalize_targets)
                x_tr, y_tr = normalizer.fit_transform(x_tr, y_tr)
                x_te, y_te = normalizer.transform(x_te, y_te)
            out.append((x_tr, y_tr, x_te, y_te))
        return [list(t) for t in zip(*out)]

    if X_test is not None and y_test is not None:
        logger.info("Running in train-test mode with provided test set")
        paths["mode"] = "train_test"
        X_te = as_f32(X_test, dev)
        if vox_mesh is None:
            Xtp, Ytp = [X_te], [as_f32(y_test, dev)]
        else:
            Xtp, Ytp = _shard_fit_inputs(X_te, y_test, vox_mesh)
        Xp, Yp, Xtp, Ytp = normalized(zip(Xp, Yp, Xtp, Ytp))
        if inner_splits is None:
            inner_splits = create_folds(Xp[0].shape[0], folding_type,
                                        n_inner_folds, chunk_length, None,
                                        groups, seed=seed)
        best_valphas = _find_best_alphas(Xp, Yp, inner_splits, **search)
        wt, correlations, pvalues = _fit_and_score(
            Xp, Yp, Xtp, Ytp, best_valphas, normalpha, singcutoff,
            voxel_chunk_size, method, return_weights=return_weights,
            perm_offsets=(_permutation_offsets(seed, None, n_perm,
                                               Ytp[0].shape[0])
                          if n_perm else None),
        )
        with annotate("litcoder.fit.host_stats"):
            wt, correlations, pvalues, best_valphas = strip(
                wt, correlations, pvalues, best_valphas)
            significant, corrected_pvals = bh_fdrcorrection_np(
                pvalues, alpha=alpha_fdr)
            n_significant = int(np.sum(significant))
            metrics = _create_metrics_dict(
                list(correlations), list(pvalues), corrected_pvals,
                significant, best_valphas, n_significant,
            )
        if n_perm:
            metrics["significance_method"] = "permutation"
        metrics["solver_paths"] = paths
        logger.info("Median correlation: %.3f", metrics["median_score"])
        return metrics, wt, best_valphas

    # ---------------- full nested-CV mode ----------------
    logger.info("Running in full nested CV mode")
    n_rows = Xp[0].shape[0]
    if outer_splits is None:
        outer_splits = create_folds(n_rows, folding_type, n_outer_folds,
                                    chunk_length, None, groups, seed=seed)
    inner_per_fold = _inner_splits_per_fold(
        outer_splits, inner_splits, groups, folding_type, n_inner_folds,
        chunk_length, seed)
    fused = _full_cv_fused_eligible(
        method, normalpha, alphas, singcutoff, normalize_features,
        normalize_targets, outer_splits, inner_per_fold, Xp[0].shape[1])
    if fused:
        logger.info("full-CV path: fused outer-fold streaming (one union "
                    "Gram/XtY downdated per fold)")
        paths.update(mode="full_cv_fused", alpha_search="fused_chol",
                     fast_scan=("auto" if fast_scan == "auto"
                                else ("bf16" if fast_scan else "off")))
        # Rows outside the fold-scheme union (the chunking remainder) are in
        # no fold: downdated away once, so G/XtY describe exactly the union.
        union = np.unique(np.concatenate(
            [np.concatenate([tr, te]) for tr, te in outer_splits]))
        leftover = np.setdiff1d(np.arange(n_rows), union, assume_unique=True)
        G_full, XtY_full = [], []
        for x, y in zip(Xp, Yp):
            with annotate("litcoder.fit.gram"):
                g, xty = x.T @ x, x.T @ y
            if leftover.size:
                g, xty = _downdate_outer(
                    x, y, g, xty, torch.as_tensor(leftover, device=x.device))
            G_full.append(g)
            XtY_full.append(xty)
    else:
        logger.info("full-CV path: per-fold (fused ineligible; see "
                    "_full_cv_fused_eligible for the gates)")
        paths["mode"] = "full_cv_per_fold"

    fold_scores, fold_pvalues, fold_valphas = [], [], []
    fold_significant_masks, fold_weights = [], []
    n_outer = len(outer_splits)  # may differ from n_outer_folds if injected
    for fold_idx, (train_idx, test_idx) in enumerate(outer_splits):
        logger.info("Processing fold %d/%d", fold_idx + 1, n_outer)
        offsets = (_permutation_offsets(seed, fold_idx, n_perm, len(test_idx))
                   if n_perm else None)
        if fused:
            best_valphas, wt, correlations, pvalues = _fused_outer_fold(
                Xp, Yp, G_full, XtY_full, train_idx, test_idx,
                inner_per_fold[fold_idx], alphas, single_alpha, normalpha,
                use_corr, singcutoff, return_weights, voxel_chunk_size,
                fast_scan, offsets, fold_idx, paths)
        else:
            parts = []
            for x, y in zip(Xp, Yp):
                tr = torch.as_tensor(np.asarray(train_idx), device=x.device)
                te = torch.as_tensor(np.asarray(test_idx), device=x.device)
                parts.append((x[tr], y[tr], x[te], y[te]))
            X_train, y_train, X_te, y_te = normalized(parts)
            best_valphas = _find_best_alphas(
                X_train, y_train, inner_per_fold[fold_idx], **search)
            wt, correlations, pvalues = _fit_and_score(
                X_train, y_train, X_te, y_te, best_valphas, normalpha,
                singcutoff, voxel_chunk_size, method,
                return_weights=return_weights, perm_offsets=offsets)
            del X_train, X_te, y_train, y_te, parts
        with annotate("litcoder.fit.host_stats"):
            if pvalues is None:
                pvalues = pearson_pvalues_f64(correlations, len(test_idx))
            wt, correlations, pvalues, best_valphas = strip(
                wt, correlations, pvalues, best_valphas)
            fold_valphas.append(best_valphas)
            if return_weights:
                fold_weights.append(wt)
            fold_scores.append(correlations)
            fold_pvalues.append(pvalues)
            significant, _ = bh_fdrcorrection_np(pvalues, alpha=alpha_fdr)
            fold_significant_masks.append(significant)
            logger.info("Fold %d/%d - median r: %.3f, significant: %d/%d",
                        fold_idx + 1, n_outer,
                        float(np.median(correlations)),
                        int(np.sum(significant)), len(significant))

    with annotate("litcoder.fit.host_stats"):
        all_correlations = np.mean(fold_scores, axis=0)
        all_pvalues = fisher_combine_pvalues_f64(np.stack(fold_pvalues))
        significant_mask, corrected_pvalues = bh_fdrcorrection_np(
            all_pvalues, alpha=alpha_fdr)
        n_significant = int(np.sum(significant_mask))
        significance_counts = np.sum(fold_significant_masks, axis=0)
        majority_significant_mask = significance_counts >= (n_outer // 2 + 1)
        n_majority_significant = int(np.sum(majority_significant_mask))
        mean_valphas = np.mean(fold_valphas, axis=0)
        mean_weights = (np.mean(fold_weights, axis=0) if return_weights
                        else None)

        metrics = _create_full_cv_metrics_dict(
            all_correlations, all_pvalues, corrected_pvalues,
            significant_mask, majority_significant_mask, mean_valphas,
            n_significant, n_majority_significant,
        )
    if n_perm:
        metrics["significance_method"] = "permutation"
    metrics["solver_paths"] = paths
    logger.info("Median correlation: %.3f", metrics["median_score"])
    return metrics, mean_weights, mean_valphas


class NestedCVModel(BasePredictivityModel):
    """Nested-CV ridge model on `device` (reference NestedCVModel API);
    `mesh`/`n_devices` shard the fit's voxel axis (see fit_nested_cv)."""

    def __init__(self, model_name: str = "ridge_regression", seed: int = 0,
                 voxel_chunk_size: Optional[int] = None, mesh=None,
                 n_devices: Optional[int] = None, device="cuda"):
        super().__init__(model_name)
        self.seed = seed
        self.voxel_chunk_size = voxel_chunk_size
        self.mesh = mesh
        self.n_devices = n_devices
        self.device = device

    def fit_predict(self, features, targets, X_test=None, y_test=None,
                    groups=None, **kwargs):
        kwargs.setdefault("seed", self.seed)
        kwargs.setdefault("voxel_chunk_size", self.voxel_chunk_size)
        kwargs.setdefault("mesh", self.mesh)
        kwargs.setdefault("n_devices", self.n_devices)
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

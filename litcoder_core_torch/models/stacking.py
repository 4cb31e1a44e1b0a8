"""Stacked regression across feature spaces (twin of
litcoder_core_tpu/models/stacking.py).

One ridge model per feature space; their out-of-fold predictions P (T, S)
on the training data give, per voxel, the convex blend

    min_w || y - P w ||^2   s.t.  w >= 0,  sum(w) = 1,

whose weights read as each space's share of the voxel's explained signal.
The data enter the per-voxel QP only through A = P^T P (S, S) and
b = P^T y (S,), accumulated fold by fold, so no (S, T, V) stack exists;
`simplex_lsq` solves all voxels' QPs at once by FISTA with the exact
per-voxel step and Duchi et al.'s simplex projection (a sort over S).

The out-of-fold refits are eigensolve-free under the standard gates
(normalpha, min(alpha) >= 0.03, singcutoff <= 1e-10, spaces no wider than
the smallest training fold): voxels are grouped by their selected alpha and
each group is one Cholesky solve against the gathered columns of X^T Y
(`oof_refit` 'grouped_chol'); otherwise one spectral factorization per
(fold, space) ('spectral'). When the (T, chunk) transient budget caps the
voxel chunk below V, or the caller asks for a chunk, every stage after the
per-space alpha searches streams through voxel chunks, reusing the
per-(fold, space) Grams ('grouped_chol_chunked'). Products run in fp32 with
TF32 off. `mesh`/`n_devices` shard the voxel axis over a 1-D device mesh
(parallel/mesh.py): the searches' scores meet for the argmax and every
later stage runs shard by shard, the refits by per-voxel-index Cholesky
('pervoxel_chol').
"""

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from litcoder_core_torch.models.banded import (
    _bucket_width,
    _chol_L,
    _cholesky_solve,
)
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.nested_cv import (
    _create_metrics_dict,
    _find_best_alphas,
)
from litcoder_core_torch.models.ridge import (
    lmax_dense,
    predict,
    ridge_fit_from_svd,
    ridge_svd,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    pearson_pvalues_f64,
    pearson_r,
)
from litcoder_core_torch.utils.device import (
    as_f32,
    matmul_tf32,
    resolve_device,
    synchronizer,
    to_numpy,
)
from litcoder_core_torch.utils.profiling import StageTimer

logger = logging.getLogger(__name__)


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of v (..., S) onto the probability simplex
    (Duchi et al. 2008): sort, find the largest k with
    u_k - (cumsum(u)_k - 1)/k > 0, clip."""
    s = v.shape[-1]
    u = torch.flip(torch.sort(v, dim=-1).values, dims=[-1])   # descending
    css = torch.cumsum(u, dim=-1) - 1.0
    k = torch.arange(1, s + 1, dtype=v.dtype, device=v.device)
    rho = torch.sum(u - css / k > 0, dim=-1, keepdim=True)    # last valid k
    theta = torch.gather(css, -1, rho - 1) / rho.to(v.dtype)
    return torch.clamp(v - theta, min=0.0)


def simplex_lsq(A: torch.Tensor, b: torch.Tensor,
                n_iter: int = 1500) -> torch.Tensor:
    """Batched min_w ||y - P w||^2 on the simplex from A = P^T P (V, S, S)
    and b = P^T y (V, S): FISTA with the exact per-voxel Lipschitz step
    1 / lambda_max(A) (a batched eigvalsh of the (S, S) systems) and a
    fixed iteration count, which the JAX package locks against scipy's
    SLSQP on correlated spaces, where the weights' optimum is flat.

    The momentum scalar t stays a Python float (rounded to float32 each
    step, as the JAX loop carries it), so the loop never waits for the
    card."""
    s = A.shape[-1]
    step = 1.0 / torch.clamp(torch.linalg.eigvalsh(A)[..., -1], min=1e-12)
    w = torch.full(A.shape[:-1], 1.0 / s, dtype=A.dtype, device=A.device)
    z = w
    t = np.float32(1.0)
    for _ in range(n_iter):
        grad = (A @ z[..., None])[..., 0] - b
        w_prev, w = w, project_simplex(z - step[:, None] * grad)
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        z = w + float((t - np.float32(1.0)) / t_next) * (w - w_prev)
        t = t_next
    return w


def _chol_pred_pervoxel(G: torch.Tensor, XtY: torch.Tensor,
                        Xpred: torch.Tensor, alphas_grid: torch.Tensor,
                        best_idx: torch.Tensor,
                        normalpha: bool) -> torch.Tensor:
    """(Tpred, V) ridge predictions with per-voxel alphas chosen by index
    into the grid: every alpha's predictions on all voxels, kept by an
    elementwise where on `best_idx` (columnwise in V: the refit of a
    voxel-sharded fit)."""
    s0 = (torch.sqrt(torch.clamp(lmax_dense(G), min=0.0)) if normalpha
          else torch.ones((), dtype=torch.float32, device=G.device))
    pred = torch.zeros((Xpred.shape[0], XtY.shape[1]), dtype=torch.float32,
                       device=G.device)
    for a in range(alphas_grid.shape[0]):
        Z = _cholesky_solve(_chol_L(G, alphas_grid[a] * s0), Xpred.T)
        pred = torch.where(best_idx[None, :] == a, Z.T @ XtY, pred)
    return pred


def _pervoxel_chol_pred(Xtr: torch.Tensor, Xpred: torch.Tensor,
                        Ytr: torch.Tensor, alphas, best_idx: torch.Tensor,
                        normalpha: bool) -> torch.Tensor:
    """_grouped_chol_pred's math with the per-voxel alpha selected by index
    (see _chol_pred_pervoxel)."""
    return _chol_pred_pervoxel(
        Xtr.T @ Xtr, Xtr.T @ Ytr, Xpred,
        torch.as_tensor(np.asarray(alphas, np.float32), device=Xtr.device),
        best_idx, normalpha)


def _chol_pred_group(G: torch.Tensor, XtY: torch.Tensor, Xva: torch.Tensor,
                     idx: torch.Tensor, na) -> torch.Tensor:
    """One alpha group's predictions Xva (G + na^2 I)^-1 (X^T Y)[:, idx]."""
    return Xva @ _cholesky_solve(_chol_L(G, na), XtY[:, idx])


def _grouped_chol_pred_cols(G: torch.Tensor, XtY: torch.Tensor,
                            Xpred: torch.Tensor, best: np.ndarray,
                            s0) -> torch.Tensor:
    """(Tpred, V) grouped-Cholesky predictions from a precomputed Gram and
    cross-product: voxels grouped by selected alpha, one Cholesky per
    distinct alpha, each group gathered at the JAX package's bucket width
    (padded with repeats of its first voxel, sliced off after)."""
    dev = G.device
    pred = torch.zeros((Xpred.shape[0], XtY.shape[1]), dtype=torch.float32,
                       device=dev)
    for a in np.unique(best):
        vox = np.nonzero(best == a)[0]
        idx = np.full(_bucket_width(vox.size), vox[0], np.int64)
        idx[:vox.size] = vox
        pg = _chol_pred_group(G, XtY, Xpred, torch.as_tensor(idx, device=dev),
                              float(a) * s0)
        pred[:, torch.as_tensor(vox, device=dev)] = pg[:, :vox.size]
    return pred


def _normalpha_scale(G: torch.Tensor, normalpha: bool):
    return (torch.sqrt(torch.clamp(lmax_dense(G), min=0.0)) if normalpha
            else 1.0)


def _grouped_chol_pred(Xtr: torch.Tensor, Xpred: torch.Tensor,
                       Ytr: torch.Tensor, best: np.ndarray,
                       normalpha: bool) -> torch.Tensor:
    """(Tpred, V) ridge predictions with per-voxel alphas, voxels grouped
    by selected alpha: the out-of-fold refits (fold train/val rows) and the
    full-train test refit (X, X_test)."""
    G = Xtr.T @ Xtr
    return _grouped_chol_pred_cols(G, Xtr.T @ Ytr, Xpred, best,
                                   _normalpha_scale(G, normalpha))


def _space_test_pred(X: torch.Tensor, Y: torch.Tensor, X_test: torch.Tensor,
                     best: np.ndarray, alphas, normalpha: bool,
                     singcutoff: float, method: str, chol_refit: bool,
                     pervoxel: bool) -> torch.Tensor:
    """One feature space's full-train refit at its selected per-voxel
    alphas, predicting the test rows (Tp, V): grouped Cholesky under the
    gates (per-voxel-index Cholesky when `pervoxel`, the voxel-sharded
    route), spectral otherwise."""
    if chol_refit and pervoxel:
        return _pervoxel_chol_pred(X, X_test, Y, alphas,
                                   _best_index(best, alphas, X.device),
                                   normalpha)
    if chol_refit:
        return _grouped_chol_pred(X, X_test, Y, best, normalpha)
    best_t = torch.as_tensor(best, device=X.device)
    svd_full = ridge_svd(X, None, singcutoff=singcutoff,
                         method="auto" if method in ("chol", "dual")
                         else method)
    nal = best_t * svd_full.S[0] if normalpha else best_t
    return predict(X_test, ridge_fit_from_svd(svd_full, Y, nal))


def _best_index(best: np.ndarray, alphas, device) -> torch.Tensor:
    """(V,) index of each voxel's selected alpha in the grid (the first
    match)."""
    alphas = np.asarray(alphas, np.float32)
    return torch.as_tensor(
        np.argmax(alphas[None, :] == np.asarray(best)[:, None], axis=1),
        device=device)


def _colwise_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(V,) per-voxel dot over time: sum_t a[t, v] * b[t, v]."""
    return torch.sum(a * b, dim=0)


def _stacked_chunk_cap(t_rows: int, n_vox: int,
                       budget_bytes: int = 1536 * 2**20) -> int:
    """Voxel-chunk cap of the stacked fit's refit/QP/test stages: the
    (T, chunk) response slice stays under `budget_bytes` (the JAX package's
    budget); returns n_vox when the whole (T, V) slice fits."""
    cap = max(512, (budget_bytes // (4 * t_rows)) // 512 * 512)
    return cap if cap < n_vox else n_vox


def _cols(M: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """(T, width) column view starting at `lo`."""
    return M[:, lo:lo + width]


def _xty_rows(X: torch.Tensor, Y_c: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """X[rows]^T Y_c[rows] (D, Vc)."""
    return X[rows].T @ Y_c[rows]


def _accumulate_qp(A_sv: torch.Tensor, b_sv: torch.Tensor, preds,
                   Yva: torch.Tensor) -> None:
    """Add one fold's pairwise QP terms, voxel-last: b[i] += <p_i, y>,
    A[i, j] = A[j, i] += <p_i, p_j>."""
    S = len(preds)
    for i in range(S):
        b_sv[i] += _colwise_dot(preds[i], Yva)
        for j in range(i, S):
            aij = _colwise_dot(preds[i], preds[j])
            A_sv[i, j] += aij
            if j > i:
                A_sv[j, i] += aij


def _stack_summary(stack_weights: np.ndarray, paths: Dict[str, str]) -> Dict:
    """Per-space weight summaries (the full (V, S) array is a return
    value, not a metrics payload)."""
    S = stack_weights.shape[1]
    V = stack_weights.shape[0]
    dominant = np.bincount(np.argmax(stack_weights, axis=1),
                           minlength=S) / max(V, 1)
    return {
        "solver_paths": paths,
        "stack_weights_mean": stack_weights.mean(axis=0).tolist(),
        "stack_weights_median": np.median(stack_weights, axis=0).tolist(),
        "stack_dominant_share": dominant.tolist(),
    }


def _test_metrics(metrics: Dict, corr: np.ndarray, per_space, n_test: int,
                  best_alphas: np.ndarray, alpha_fdr: float,
                  label: str) -> None:
    pval = pearson_pvalues_f64(corr, n_test)
    significant, corrected = bh_fdrcorrection_np(pval, alpha=alpha_fdr)
    metrics.update(_create_metrics_dict(corr, pval, corrected, significant,
                                        best_alphas, int(significant.sum())))
    metrics["per_space_test_r"] = [p.tolist() for p in per_space]
    logger.info(
        "stacked ridge%s: median r = %.3f (spaces alone: %s), %d/%d "
        "significant", label, metrics["median_score"],
        ["%.3f" % float(np.median(p)) for p in per_space],
        metrics["n_significant"], corr.size,
    )


def _fit_stacked_chunked(Xs_j, Y_j: torch.Tensor, X_tests_j, y_test,
                         alphas, fold_splits, normalpha: bool,
                         use_corr: bool, singcutoff: float, method: str,
                         n_iter: int, chunk: int, alpha_fdr: float,
                         search_chunk: int, timer: StageTimer, V: int,
                         paths: Dict[str, str]):
    """fit_stacked_ridge with every stage after the per-space alpha search
    streamed through voxel chunks (all of them are columnwise in V, so the
    chunks are exact): nothing of size (Tva, V) or (Tp, V) exists. The
    per-(fold, space) Grams and normalpha scales are computed once and
    reused by every chunk; needs the grouped-Cholesky gates. Returns
    (metrics, stack_weights, best_alphas) as the unchunked route does."""
    dev = Y_j.device
    S = len(Xs_j)
    T = Y_j.shape[0]
    alphas = np.asarray(alphas, np.float32)
    with timer.stage("per_space_search"):
        all_alphas = [
            _find_best_alphas(X_j, Y_j, fold_splits, alphas, False,
                              normalpha, use_corr, singcutoff, search_chunk,
                              method, False, paths)
            for X_j in Xs_j
        ]

    with timer.stage("fold_grams_precompute"):
        va_rows = [torch.as_tensor(np.asarray(va), device=dev)
                   for _, va in fold_splits]
        tr_rows = [torch.as_tensor(np.asarray(tr), device=dev)
                   for tr, _ in fold_splits]
        G_fold, s0_fold = [], []
        for tr in tr_rows:
            Gs = [X_j[tr].T @ X_j[tr] for X_j in Xs_j]
            G_fold.append(Gs)
            s0_fold.append([_normalpha_scale(G, normalpha) for G in Gs])
        Xva_fold = [[X_j[va] for X_j in Xs_j] for va in va_rows]
        G_full, s0_full = [], []
        if X_tests_j is not None:
            G_full = [X_j.T @ X_j for X_j in Xs_j]
            s0_full = [_normalpha_scale(G, normalpha) for G in G_full]

    n_rows_used = sum(len(va) for _, va in fold_splits)
    w_chunks, corr_chunks = [], []
    per_space_chunks = [[] for _ in range(S)]
    for lo in range(0, V, chunk):
        width = min(chunk, V - lo)
        best_c = [b[lo:lo + width] for b in all_alphas]
        Y_c = _cols(Y_j, lo, width)                              # (T, Vc)
        with timer.stage("oof_refits_and_qp_accumulation"):
            A_sv = torch.zeros((S, S, width), dtype=torch.float32,
                               device=dev)
            b_sv = torch.zeros((S, width), dtype=torch.float32, device=dev)
            for f in range(len(fold_splits)):
                preds = [_grouped_chol_pred_cols(
                    G_fold[f][s], _xty_rows(X_j, Y_c, tr_rows[f]),
                    Xva_fold[f][s], best_c[s], s0_fold[f][s])
                    for s, X_j in enumerate(Xs_j)]
                _accumulate_qp(A_sv, b_sv, preds, Y_c[va_rows[f]])
        with timer.stage("blend_fista"):
            w_c = simplex_lsq(A_sv.permute(2, 0, 1), b_sv.T,
                              n_iter=n_iter)                     # (Vc, S)
            w_chunks.append(to_numpy(w_c))
        if X_tests_j is not None:
            with timer.stage("test_refit_and_scoring"):
                tests_c = [_grouped_chol_pred_cols(
                    G_full[s], X_j.T @ Y_c, X_tests_j[s], best_c[s],
                    s0_full[s]) for s, X_j in enumerate(Xs_j)]  # (Tp, Vc)
                y_pred_c = sum(w_c[:, s][None, :] * tests_c[s]
                               for s in range(S))
                y_test_c = as_f32(y_test[:, lo:lo + width], dev)
                corr_chunks.append(to_numpy(pearson_r(y_test_c, y_pred_c)))
                for s in range(S):
                    per_space_chunks[s].append(
                        to_numpy(pearson_r(y_test_c, tests_c[s])))

    if n_rows_used < T:
        logger.info("stacking: %d/%d training rows outside all validation "
                    "folds are excluded from the blend fit",
                    T - n_rows_used, T)
    stack_weights = np.concatenate(w_chunks, axis=0)            # (V, S)
    best_alphas = np.stack(all_alphas)                          # (S, V)
    paths["oof_refit"] = "grouped_chol_chunked"
    metrics = _stack_summary(stack_weights, paths)
    if X_tests_j is not None:
        _test_metrics(metrics, np.concatenate(corr_chunks),
                      [np.concatenate(c) for c in per_space_chunks],
                      int(y_test.shape[0]), best_alphas, alpha_fdr,
                      " (chunked)")
    metrics["stage_seconds"] = timer.report()
    return metrics, stack_weights, best_alphas


# The fit runs in full fp32 (the JAX package's Precision.HIGHEST) and gives
# the caller back its TF32 setting on return.
@matmul_tf32(False)
def fit_stacked_ridge(
    Xs: Sequence,
    Y,
    X_tests: Optional[Sequence] = None,
    y_test=None,
    alphas: Optional[Sequence[float]] = None,
    folding_type: str = "chunked",
    n_inner_folds: int = 5,
    chunk_length: int = 20,
    alpha_fdr: float = 0.05,
    normalpha: bool = True,
    use_corr: bool = True,
    singcutoff: float = 1e-10,
    seed: int = 0,
    method: str = "auto",
    n_iter: int = 1500,
    voxel_chunk_size: Optional[int] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    device="cuda",
) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """Stacked ridge across feature spaces with per-voxel simplex weights,
    on `device`.

    Args:
        Xs: list of (T, D_s) training feature spaces (numpy or tensors).
        X_tests / y_test: matching test spaces / (Tp, V) responses.
        voxel_chunk_size: streams each space's alpha search through voxel
            chunks (and, on the grouped-Cholesky route, every later stage).
        mesh / n_devices: a 1-D voxel mesh (or a device count to build
            one; n entries of the CPU for a CPU fit): zero-padded voxel
            shards, each fitted on its device after the shared argmax; it
            replaces voxel chunking.
        Others: the contracts of fit_nested_cv / fit_banded_ridge.

    Returns:
        (metrics, stack_weights (V, S), best_alphas (S, V)) on the host.
        With a test set the metrics are the train/test nested-CV dict
        ('best_alphas' holds the (S, V) selections) plus
        'stack_weights_mean'/'_median', 'stack_dominant_share' and the
        per-space test correlations 'per_space_test_r'.
    """
    paths: Dict[str, str] = {}
    if method not in ("auto", "chol", "dual", "eigh", "svd"):
        raise ValueError(
            f"method must be one of 'auto', 'chol', 'dual', 'eigh', "
            f"'svd'; got {method!r}"
        )
    if len(Xs) < 2:
        raise ValueError("stacking needs >= 2 feature spaces")
    if (X_tests is None) != (y_test is None):
        raise ValueError("X_tests and y_test must be given together")
    T = Xs[0].shape[0]
    V = Y.shape[1]
    for s, X in enumerate(Xs):
        if X.shape[0] != T or Y.shape[0] != T:
            raise ValueError(
                f"feature space {s} has {X.shape[0]} rows; expected "
                f"{T} (= Y rows {Y.shape[0]})"
            )
    if X_tests is not None:
        if len(X_tests) != len(Xs):
            raise ValueError(
                f"{len(X_tests)} test spaces for {len(Xs)} train spaces"
            )
        for s, Xt in enumerate(X_tests):
            if Xt.shape[0] != y_test.shape[0]:
                raise ValueError(
                    f"test space {s} has {Xt.shape[0]} rows; y_test has "
                    f"{y_test.shape[0]}"
                )
            if Xt.shape[1] != Xs[s].shape[1]:
                raise ValueError(
                    f"test space {s} has {Xt.shape[1]} features; train "
                    f"space has {Xs[s].shape[1]}"
                )
    from litcoder_core_torch.parallel.mesh import (
        replicate,
        resolve_voxel_mesh,
        shard_padded,
    )

    dev = resolve_device(device)
    vox_mesh = resolve_voxel_mesh(mesh, n_devices, "fit_stacked_ridge", dev)
    if alphas is None:
        alphas = np.logspace(-1, 8, 10)
    alphas = np.asarray(alphas, np.float32)
    Xs_j = [as_f32(X, dev) for X in Xs]
    X_tests_j = ([as_f32(Xt, dev) for Xt in X_tests]
                 if X_tests is not None else None)
    timer = StageTimer(sync_fn=synchronizer(dev))

    fold_splits = create_folds(T, folding_type, n_inner_folds, chunk_length,
                               seed=seed)
    min_tr = min(len(tr) for tr, _ in fold_splits)
    chol_oof = bool(
        method in ("auto", "chol", "dual") and normalpha
        and singcutoff <= 1e-10 and alphas.size
        and float(alphas.min()) >= 0.03
        and all(X.shape[1] <= min_tr for X in Xs)
    )
    svd_method = "auto" if method in ("chol", "dual") else method

    # A mesh replaces chunking entirely, as in fit_nested_cv.
    if vox_mesh is None and chol_oof:
        cap = _stacked_chunk_cap(T, V)
        chunk_eff = (min(int(voxel_chunk_size), cap)
                     if voxel_chunk_size else cap)
        if chunk_eff < V:
            logger.info(
                "stacked fit: streaming refit/QP/blend/test through "
                "%d-voxel chunks (%d voxels)", chunk_eff, V)
            return _fit_stacked_chunked(
                Xs_j, as_f32(Y, dev), X_tests_j, y_test, alphas,
                fold_splits, normalpha, use_corr, singcutoff, method, n_iter,
                chunk_eff, alpha_fdr, voxel_chunk_size or chunk_eff, timer,
                V, paths)

    # The voxel axis as column blocks (one, or a mesh's shards): every
    # stage after the per-space argmax is columnwise, so each block runs
    # on its own device and the host concatenates.
    if vox_mesh is None:
        parts = [dict(Xs=Xs_j, Y=as_f32(Y, dev), X_tests=X_tests_j,
                      y_test=(None if y_test is None
                              else as_f32(y_test, dev)))]
    else:
        if voxel_chunk_size is not None:
            logger.info(
                "mesh sharding replaces voxel chunking; ignoring "
                "voxel_chunk_size=%d (each device holds 1/%d of the "
                "voxel axis)", voxel_chunk_size, vox_mesh.size,
            )
            voxel_chunk_size = None

        X_rep = [replicate(X, vox_mesh) for X in Xs_j]
        Xt_rep = ([replicate(Xt, vox_mesh) for Xt in X_tests_j]
                  if X_tests_j is not None else None)
        yt_shards = (shard_padded(y_test, vox_mesh).shards
                     if y_test is not None else None)
        parts = [dict(Xs=[r[y.device] for r in X_rep], Y=y,
                      X_tests=(None if Xt_rep is None
                               else [r[y.device] for r in Xt_rep]),
                      y_test=None if yt_shards is None else yt_shards[i])
                 for i, y in enumerate(shard_padded(Y, vox_mesh).shards)]
        logger.info(
            "stacked voxel-sharded fit: %d voxels (+%d pad) over %d "
            "devices", V, sum(p["Y"].shape[1] for p in parts) - V,
            vox_mesh.size,
        )
    pervoxel = vox_mesh is not None
    bounds = np.cumsum([0] + [p["Y"].shape[1] for p in parts])
    S = len(Xs)

    all_alphas = []
    with timer.stage("per_space_search_and_test_refit"):
        for s in range(S):
            best = _find_best_alphas(
                [p["Xs"][s] for p in parts], [p["Y"] for p in parts],
                fold_splits, alphas, False, normalpha, use_corr, singcutoff,
                voxel_chunk_size, method, False, paths)
            all_alphas.append(best)
            for p, lo, hi in zip(parts, bounds[:-1], bounds[1:]):
                p.setdefault("tests", []).append(
                    None if p["X_tests"] is None else _space_test_pred(
                        p["Xs"][s], p["Y"], p["X_tests"][s], best[lo:hi],
                        alphas, normalpha, singcutoff, method, chol_oof,
                        pervoxel))

    # The QP terms accumulate fold by fold (validation sets are disjoint,
    # so the fold sums equal the concatenated out-of-fold Grams) and
    # pairwise per space: no (S, Tva, V) stack exists.
    n_rows_used = sum(len(va) for _, va in fold_splits)
    with timer.stage("oof_refits_and_qp_accumulation"):
        for p, lo, hi in zip(parts, bounds[:-1], bounds[1:]):
            pdev = p["Y"].device
            p["A"] = torch.zeros((S, S, hi - lo), dtype=torch.float32,
                                 device=pdev)
            p["b"] = torch.zeros((S, hi - lo), dtype=torch.float32,
                                 device=pdev)
            for tr_np, va_np in fold_splits:
                tr = torch.as_tensor(np.asarray(tr_np), device=pdev)
                va = torch.as_tensor(np.asarray(va_np), device=pdev)
                preds = []
                for s, X_j in enumerate(p["Xs"]):
                    best = all_alphas[s][lo:hi]
                    if chol_oof and pervoxel:
                        preds.append(_pervoxel_chol_pred(
                            X_j[tr], X_j[va], p["Y"][tr], alphas,
                            _best_index(best, alphas, pdev), normalpha))
                    elif chol_oof:
                        preds.append(_grouped_chol_pred(
                            X_j[tr], X_j[va], p["Y"][tr], best, normalpha))
                    else:
                        best_t = torch.as_tensor(best, device=pdev)
                        svd = ridge_svd(X_j[tr], None, singcutoff=singcutoff,
                                        method=svd_method)
                        nal = best_t * svd.S[0] if normalpha else best_t
                        preds.append(predict(
                            X_j[va], ridge_fit_from_svd(svd, p["Y"][tr],
                                                        nal)))
                _accumulate_qp(p["A"], p["b"], preds, p["Y"][va])
    if n_rows_used < T:
        logger.info("stacking: %d/%d training rows outside all validation "
                    "folds are excluded from the blend fit",
                    T - n_rows_used, T)
    with timer.stage("blend_fista"):
        for p in parts:
            p["w"] = simplex_lsq(p.pop("A").permute(2, 0, 1), p.pop("b").T,
                                 n_iter=n_iter)
        stack_weights = np.concatenate([to_numpy(p["w"]) for p in parts])[:V]
    best_alphas = np.stack(all_alphas)[:, :V]                    # (S, V)

    paths["oof_refit"] = ("pervoxel_chol" if chol_oof and pervoxel
                          else "grouped_chol" if chol_oof else "spectral")
    metrics = _stack_summary(stack_weights, paths)
    if X_tests is not None:
        with timer.stage("test_scoring"):
            corr, per_space = [], [[] for _ in range(S)]
            for p in parts:
                w, tests = p["w"], p["tests"]
                y_pred = sum(w[:, s][None, :] * tests[s] for s in range(S))
                corr.append(to_numpy(pearson_r(p["y_test"], y_pred)))
                for s in range(S):
                    per_space[s].append(to_numpy(pearson_r(p["y_test"],
                                                           tests[s])))
            corr = np.concatenate(corr)[:V]
            per_space = [np.concatenate(c)[:V] for c in per_space]
        _test_metrics(metrics, corr, per_space, int(y_test.shape[0]),
                      best_alphas, alpha_fdr, "")
    metrics["stage_seconds"] = timer.report()
    return metrics, stack_weights, best_alphas


class StackedRidgeModel:
    """Object API over fit_stacked_ridge on `device`: fit_predict takes
    feature spaces and returns (metrics, stack_weights (V, S),
    best_alphas (S, V)); `mesh`/`n_devices` shard the voxel axis."""

    def __init__(self, model_name: str = "stacked_ridge", seed: int = 0,
                 mesh=None, n_devices: Optional[int] = None, device="cuda"):
        self.model_name = model_name
        self.seed = seed
        self.mesh = mesh
        self.n_devices = n_devices
        self.device = device

    def fit_predict(self, feature_spaces, targets, X_tests=None,
                    y_test=None, **kwargs):
        kwargs.setdefault("seed", self.seed)
        kwargs.setdefault("mesh", self.mesh)
        kwargs.setdefault("n_devices", self.n_devices)
        kwargs.setdefault("device", self.device)
        return fit_stacked_ridge(feature_spaces, targets, X_tests=X_tests,
                                 y_test=y_test, **kwargs)

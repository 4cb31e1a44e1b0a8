"""The fused nested-CV step (twin of litcoder_core_tpu/parallel/step.py).

`nested_cv_step` is the whole train/test fit on tensors: the inner-fold
alpha scan, the per-voxel argmax, the full-train refit, the held-out
prediction and the voxelwise Pearson r and p. The JAX package traces it
into one XLA program and vmaps the folds; here it is a sequence of torch
ops with a Python loop over the folds, so each fold's buffers are freed
before the next fold's exist.

With complementary equal-size folds (each fold's train rows are the union
of every val block minus its own) the scan works from the union Gram:
  'woodbury' - one eigh of the union Gram, then per (fold, alpha) a
               (Tva, Tva) Cholesky (ridge.score_alpha_grid_woodbury);
               the refit reuses that eigendecomposition, rank-k corrected
               for the k rows outside the union (_refit_union_woodbury);
  'chol'     - per (fold, alpha) a Cholesky of the downdated Gram;
  'eigh'     - per fold an eigh of the downdated Gram.
Other folds take one spectral state per fold (ridge_svd). The stage
functions `_scan_best_alphas`, `_refit_union_woodbury`, `_refit_full` and
`_predict_and_score` are the pieces bench.py times.

Everything runs in fp32 with TF32 off (the JAX package's
Precision.HIGHEST), except the scan products that `fast_scan` puts in TF32.
`make_nested_cv_step(mesh=...)` runs the step over a 1-D voxel mesh
(parallel/mesh.py): the X side once per distinct device, the voxel side
shard by shard.
"""

import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from litcoder_core_torch.models.nested_cv import (
    _complement_fold_factors,
    _fold_spectral_states,
    _fold_states_complement,
    _score_all_complement,
    _score_chunk_with_states,
    _score_fold_voxel_chunks,
)
from litcoder_core_torch.models.ridge import (
    lmax_downdate,
    lmax_update,
    ridge_fit_from_svd,
    ridge_svd,
    score_alpha_grid_woodbury,
)
from litcoder_core_torch.ops.stats import pearson_pvalues, pearson_r
from litcoder_core_torch.parallel.mesh import (  # noqa: F401 (pad_voxels)
    VoxelShards,
    pad_voxels,
    replicate,
    resolve_voxel_mesh,
    shard_padded,
)
from litcoder_core_torch.utils.device import (
    as_f32,
    matmul_tf32,
    resolve_device,
    to_numpy,
)

logger = logging.getLogger(__name__)


class NestedCVResult(NamedTuple):
    correlations: torch.Tensor   # (V,) held-out Pearson r per voxel
    pvalues: torch.Tensor        # (V,) two-sided p per voxel
    best_alphas: torch.Tensor    # (V,) selected (un-normalized) alphas
    weights: torch.Tensor        # (D, V) refit ridge weights


def _folds_are_complementary(train_idx, val_idx) -> bool:
    """True iff every fold's train rows are exactly (union of all val rows)
    minus its own val rows, with no duplicate val rows — the structure the
    complement-Gram scans assume (equal_size_folds guarantees it; trimmed
    or injected folds may not)."""
    train_idx = np.asarray(train_idx)
    val_idx = np.asarray(val_idx)
    union = np.sort(val_idx.ravel())
    if len(np.unique(union)) != union.size:
        return False
    for f in range(val_idx.shape[0]):
        both = np.sort(np.concatenate([train_idx[f], val_idx[f]]))
        if both.size != union.size or not np.array_equal(both, union):
            return False
    return True


def _index(idx, device: torch.device) -> torch.Tensor:
    """int64 index tensor on `device` from an array or tensor."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def _step_route(X, alphas, train_idx, val_idx, normalpha: bool,
                singcutoff: float, method: str, fast_scan):
    """(complement, scan) of a step call, after checking its options."""
    if not isinstance(fast_scan, bool):
        raise ValueError(
            "nested_cv_step takes a boolean fast_scan; the guarded "
            "'auto' mode lives in models.nested_cv.fit_nested_cv (it "
            "needs a second calibration dispatch, which this single-"
            "program step deliberately avoids)"
        )
    if method not in ("auto", "chol", "dual", "eigh", "svd", "woodbury"):
        raise ValueError(
            f"method must be one of 'auto', 'chol', 'dual', 'eigh', "
            f"'svd', 'woodbury'; got {method!r}"
        )
    complement = (method in ("auto", "eigh", "woodbury", "chol")
                  and train_idx.shape[1] >= X.shape[1])
    if complement:
        complement = _folds_are_complementary(to_numpy(train_idx),
                                              to_numpy(val_idx))
    if method in ("woodbury", "chol") and not complement:
        raise ValueError(
            f"method={method!r} requires complementary equal-size folds "
            "with tall training blocks (each fold's train rows = union of "
            "all val rows minus its own, and Ttr >= D); these folds are "
            "ineligible — use method='auto' to fall back automatically"
        )
    scan = _resolve_scan_method(method, complement, alphas, normalpha,
                                singcutoff)
    return complement, scan


def nested_cv_step(
    X, Y, X_test, Y_test, alphas, train_idx, val_idx,
    normalpha: bool = True, use_corr: bool = True,
    single_alpha: bool = False, singcutoff: float = 1e-10,
    method: str = "auto", fast_scan: bool = False,
    voxel_shards: int = 1, device="cuda",
) -> NestedCVResult:
    """Full train/test nested-CV ridge fit on `device`.

    Args:
        X: (T, D) training stimuli.  Y: (T, V) training responses.
        X_test: (Tp, D).  Y_test: (Tp, V).
        alphas: (A,) grid.
        train_idx: (F, Ttr) per-fold training rows (equal-size folds).
        val_idx: (F, Tva) per-fold validation rows.
        device: where the fit runs ('cuda' by default; with no card it
            raises). Arrays or tensors are accepted and moved there.

    The complement-Gram scans need complementary folds with Ttr >= D
    (checked on the index arrays); other folds take the per-fold spectral
    scan. `method` 'woodbury'/'chol' force those scans and raise on
    ineligible folds.

    Returns:
        NestedCVResult(correlations, pvalues, best_alphas, weights), tensors
        on `device`.
    """
    complement, scan = _step_route(X, alphas, train_idx, val_idx, normalpha,
                                   singcutoff, method, fast_scan)
    dev = resolve_device(device)
    return _nested_cv_step_impl(
        as_f32(X, dev), as_f32(Y, dev), as_f32(X_test, dev),
        as_f32(Y_test, dev), as_f32(alphas, dev), _index(train_idx, dev),
        _index(val_idx, dev), normalpha=normalpha, use_corr=use_corr,
        single_alpha=single_alpha, singcutoff=singcutoff, method=method,
        complement=complement, scan=scan, fast_scan=fast_scan,
        voxel_shards=voxel_shards,
    )


def _woodbury_alpha_batch(n_folds: int, t_va: int, n_vox: int, a_n: int,
                          budget_bytes: float = 3.0e9,
                          voxel_shards: int = 1) -> int:
    """How many alphas the woodbury scan factors, solves and scores
    together: a 3 GB budget against an (F, Ab, Tva, V) f32 prediction block
    plus 50% for the scoring temporaries (the JAX package's formula, which
    vmaps the folds; the port's fold loop holds one fold's block, 1/F of
    that, at a time)."""
    per_alpha = (n_folds * t_va * (n_vox / max(voxel_shards, 1))
                 * 4.0 * 1.5)
    return max(1, min(a_n, int(budget_bytes // max(per_alpha, 1.0))))


def _resolve_scan_method(method: str, complement: bool, alphas,
                         normalpha: bool,
                         singcutoff: float = 1e-10) -> str:
    """The complement scan: 'woodbury' for method 'auto' with normalpha, a
    negligible singcutoff and every alpha >= 0.03 (I - K_a has condition
    ~1/a^2, so this keeps f32 solves accurate, and the eigh scan's masking
    of S <= singcutoff matches the full-spectrum Cholesky only below f32
    noise); a forced 'woodbury'/'chol' as asked; 'eigh' otherwise."""
    if not complement:
        return "eigh"
    if method in ("woodbury", "chol"):
        return method
    if method == "auto" and normalpha and singcutoff <= 1e-10:
        a = to_numpy(alphas)
        if a.size and np.all(a >= 0.03):
            return "woodbury"
    return "eigh"


@matmul_tf32(False)
def _scan_best_alphas(
    X, Y, alphas, train_idx, val_idx,
    normalpha: bool, use_corr: bool, single_alpha: bool, singcutoff: float,
    method: str, complement: bool, scan: str = "eigh",
    fast_scan: bool = False,
) -> torch.Tensor:
    """(V,) selected alphas: the SCAN stage alone (fold scan + argmax)."""
    return _scan_core(X, Y, alphas, train_idx, val_idx, normalpha, use_corr,
                      single_alpha, singcutoff, method, complement, scan,
                      fast_scan)[0]


def _once(memo, key, fn):
    """fn(), computed once per `memo`: under a mesh each distinct device has
    one memo, so the X-side work its shards share runs once there. With
    memo None it is computed on every call."""
    if memo is None:
        return fn()
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _scan_core(
    X, Y, alphas, train_idx, val_idx,
    normalpha: bool, use_corr: bool, single_alpha: bool, singcutoff: float,
    method: str, complement: bool, scan: str = "eigh",
    fast_scan: bool = False, voxel_shards: int = 1,
):
    """Fold scan + per-voxel argmax, returning (best_alphas, aux): aux is
    the woodbury scan's union products (lam_u, Q, XtY_u, union) for the
    refit, None on every other scan."""
    mean_corrs, aux = _fold_scan(
        X, Y, alphas, train_idx, val_idx, normalpha, use_corr, singcutoff,
        method, complement, scan, fast_scan, voxel_shards=voxel_shards)
    alphas = torch.as_tensor(alphas, dtype=torch.float32,
                             device=mean_corrs.device)
    # torch.argmax returns the first maximum, as jnp.argmax does.
    if single_alpha:
        best_idx = torch.argmax(torch.mean(mean_corrs, dim=1))
        best_alphas = alphas[best_idx].repeat(mean_corrs.shape[1])
    else:
        best_alphas = alphas[torch.argmax(mean_corrs, dim=0)]
    return best_alphas, aux


def _fold_scan(
    X, Y, alphas, train_idx, val_idx,
    normalpha: bool, use_corr: bool, singcutoff: float,
    method: str, complement: bool, scan: str = "eigh",
    fast_scan: bool = False, voxel_shards: int = 1, memo=None,
    n_vox=None,
):
    """(mean fold scores (A, V), aux) of the scan; aux as in _scan_core.
    `memo` keeps the X-side products (Grams, eigendecompositions, solve
    factors) for the next shard on the same device; `n_vox` is the voxel
    count the woodbury alpha batch is sized for (default: Y's)."""
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    dev = X.device
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    train_idx = _index(train_idx, dev)
    val_idx = _index(val_idx, dev)
    n_folds = val_idx.shape[0]
    aux = None

    if complement and scan == "eigh":
        # Per-fold eigh of G_union - Xva^T Xva (nested_cv's complement scan).
        union = torch.sort(val_idx.reshape(-1)).values
        states = _once(memo, "states", lambda: _fold_states_complement(
            X, union, val_idx, singcutoff))
        mean_corrs = _score_all_complement(
            states, _once(memo, "Xu", lambda: X[union]), Y, union,
            torch.searchsorted(union, val_idx), alphas, normalpha, use_corr,
            None, fast_scan)
    elif complement:
        union = torch.sort(val_idx.reshape(-1)).values
        Xu = _once(memo, "Xu", lambda: X[union])
        G_union = _once(memo, "G_union", lambda: Xu.T @ Xu)
        XtY_u = Xu.T @ Y[union]
        fold_sum = 0
        if scan == "woodbury":
            lam_u, Q = _once(memo, "eigh_union",
                             lambda: torch.linalg.eigh(G_union))
            aux = (lam_u, Q, XtY_u, union)
            ab = _woodbury_alpha_batch(
                n_folds, val_idx.shape[1],
                Y.shape[1] if n_vox is None else n_vox, alphas.shape[0],
                voxel_shards=voxel_shards)

            def fold_factors(va):
                P = X[va] @ Q
                nal = alphas
                if normalpha:
                    nal = alphas * torch.sqrt(torch.clamp(
                        lmax_downdate(lam_u, P), min=0.0))
                return P, nal

            for f, va in enumerate(val_idx):
                Xva, Yva = X[va], Y[va]
                P, nal = _once(memo, ("woodbury", f),
                               lambda: fold_factors(va))
                UR0 = Q.T @ (XtY_u - Xva.T @ Yva)
                fold_sum = fold_sum + score_alpha_grid_woodbury(
                    lam_u, P, UR0, Yva, nal, use_corr=use_corr,
                    fast_scan=fast_scan, alpha_batch=ab)
                del P, UR0
        else:
            # 'chol': a Cholesky per (fold, alpha) of G_union - Xva^T Xva,
            # normalpha from lmax_dense; the downdated X^T Y joins fast_scan.
            for f, va in enumerate(val_idx):
                Z_all = _once(memo, ("chol", f),
                              lambda: _complement_fold_factors(
                                  X[va], G_union, alphas, normalpha))
                fold_sum = fold_sum + _score_fold_voxel_chunks(
                    Z_all, Y, use_corr, None, fast_scan, form="complement",
                    X=X, va=va, XtY_base=XtY_u)
                del Z_all
        mean_corrs = fold_sum / n_folds
    else:
        # 'woodbury'/'chol' name complement scans: the per-fold spectral
        # states pick eigh or dual by shape.
        svd_method = "auto" if method in ("woodbury", "chol") else method
        states = _once(memo, "spectral", lambda: _fold_spectral_states(
            X, train_idx, val_idx, singcutoff, svd_method))
        mean_corrs = _score_chunk_with_states(states, Y, train_idx, val_idx,
                                              alphas, normalpha, use_corr)
    return mean_corrs, aux


@matmul_tf32(False)
def _refit_union_woodbury(X, Y, lam_u, Q, XtY_u, union, best_alphas,
                          alphas, normalpha: bool,
                          memo=None) -> torch.Tensor:
    """(D, V) per-voxel refit weights from the woodbury scan's union
    products: no second eigensolve, no X^T Y recompute.

    The full training Gram is the union Gram plus the k = T - |union| rows
    outside every val block. In the union eigenbasis
        w_v = Q (diag(lam) + nal_v^2 I + Pr^T Pr)^-1 q_v,
    with Pr = X_rem Q (k, D) and q = Q^T XtY_u + Pr^T Y_rem; Woodbury on the
    rank-k term leaves elementwise shrinkage plus one (k, k) system per grid
    alpha, S_a = I + Pr diag(d_a) Pr^T, each voxel taking its own alpha's.
    S_a is applied by cholesky_solve against the (k, V) right-hand side
    (the JAX package forms an explicit inverse, which suits a voxel-sharded
    right-hand side; with one card the solve is as cheap and no less
    accurate: S_a >= I). normalpha's scale comes from lmax_update. `memo`
    keeps the X-side factors for the next shard on the device."""
    t_all = X.shape[0]
    k = t_all - int(union.shape[0])
    lam = torch.clamp(lam_u, min=0.0)
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=X.device)

    if k > 0:
        def remainder():
            # Remainder rows = arange(T) minus the union, ascending (the
            # JAX package's stable argsort of the union mask).
            in_union = torch.zeros(t_all, dtype=torch.bool, device=X.device)
            in_union[union] = True
            rem = torch.nonzero(~in_union).squeeze(1)
            Pr = X[rem] @ Q                                   # (k, D)
            return rem, Pr, torch.sqrt(torch.clamp(lmax_update(lam, Pr),
                                                   min=0.0))

        rem, Pr, s0 = _once(memo, "refit_remainder", remainder)
        q = Q.T @ XtY_u + Pr.T @ Y[rem]                       # (D, V)
    else:
        q = Q.T @ XtY_u
        s0 = torch.sqrt(torch.max(lam))

    nal_v = best_alphas * s0 if normalpha else best_alphas    # (V,)
    dinv = 1.0 / (lam[:, None] + (nal_v * nal_v)[None, :])    # (D, V)
    t1 = dinv * q
    if k == 0:
        return Q @ t1

    def rank_k_factors():
        nal_a = alphas * s0 if normalpha else alphas          # (A,)
        d_a = 1.0 / (lam[None, :] + (nal_a * nal_a)[:, None])  # (A, D)
        S = (torch.eye(k, dtype=torch.float32, device=X.device)[None]
             + (Pr[None, :, :] * d_a[:, None, :]) @ Pr.T)     # (A, k, k)
        return torch.linalg.cholesky(S)

    L = _once(memo, "refit_chol", rank_k_factors)
    Zb = torch.cholesky_solve(Pr @ t1, L)                     # (A, k, V)
    # Each voxel's own alpha: the FIRST grid match (argmax semantics, so a
    # repeated grid value takes its first position).
    sel = torch.argmax((best_alphas[None, :] == alphas[:, None]).to(
        torch.uint8), dim=0)                                  # (V,)
    z = torch.take_along_dim(Zb, sel[None, None, :], dim=0)[0]  # (k, V)
    return Q @ (t1 - dinv * (Pr.T @ z))


@matmul_tf32(False)
def _refit_full(X, Y, best_alphas, normalpha: bool, singcutoff: float,
                method: str, memo=None) -> torch.Tensor:
    """(D, V) full-train per-voxel-alpha refit weights — the REFIT stage
    (one spectral factorization of X, kept in `memo` for the next shard on
    the device, and the dense shrinkage solve)."""
    svd_method = "auto" if method in ("woodbury", "chol") else method
    svd_full = _once(memo, "refit_svd", lambda: ridge_svd(
        X.to(torch.float32), None, singcutoff=singcutoff,
        method=svd_method))
    nal = best_alphas * svd_full.S[0] if normalpha else best_alphas
    return ridge_fit_from_svd(svd_full, Y.to(torch.float32), nal)


@matmul_tf32(False)
def _predict_and_score(X_test, Y_test, weights):
    """(corr, p): held-out prediction and voxelwise Pearson — the SCORE
    stage."""
    correlations = pearson_r(Y_test, X_test.to(torch.float32) @ weights)
    return correlations, pearson_pvalues(correlations, Y_test.shape[0])


@matmul_tf32(False)
def _nested_cv_step_impl(
    X, Y, X_test, Y_test, alphas, train_idx, val_idx,
    normalpha: bool, use_corr: bool, single_alpha: bool, singcutoff: float,
    method: str, complement: bool, scan: str = "eigh",
    fast_scan: bool = False, voxel_shards: int = 1,
) -> NestedCVResult:
    """scan -> refit -> score."""
    best_alphas, aux = _scan_core(
        X, Y, alphas, train_idx, val_idx, normalpha, use_corr,
        single_alpha, singcutoff, method, complement, scan, fast_scan,
        voxel_shards=voxel_shards,
    )
    union_refit = _union_refit(X, aux, singcutoff)
    logger.info("nested_cv_step: %s scan, %s refit",
                scan if complement else "per_fold",
                "union_woodbury" if union_refit else "full")
    weights = _refit(X, Y, aux, union_refit, best_alphas, alphas, normalpha,
                     singcutoff, method)
    correlations, pvalues = _predict_and_score(X_test, Y_test, weights)
    return NestedCVResult(correlations, pvalues, best_alphas, weights)


def _union_refit(X, aux, singcutoff: float) -> bool:
    """The woodbury scan's union eigendecomposition doubles as the refit's
    factorization, rank-k corrected; a large remainder outside the fold
    union (hand-built folds only) or a negative one (overlapping val
    blocks) takes the standalone spectral refit."""
    if aux is None or singcutoff > 1e-10:
        return False
    k_rem = X.shape[0] - aux[3].shape[0]
    return 0 <= k_rem <= max(256, X.shape[0] // 8)


def _refit(X, Y, aux, union_refit: bool, best_alphas, alphas,
           normalpha: bool, singcutoff: float, method: str, memo=None):
    """(D, V) refit weights on the route _union_refit chose."""
    if union_refit:
        lam_u, Q, XtY_u, union = aux
        return _refit_union_woodbury(X, Y, lam_u, Q, XtY_u, union,
                                     best_alphas, alphas, normalpha, memo)
    return _refit_full(X, Y, best_alphas, normalpha, singcutoff, method,
                       memo)


@matmul_tf32(False)
def _nested_cv_step_sharded(
    mesh, X, Y, X_test, Y_test, alphas, train_idx, val_idx,
    normalpha: bool = True, use_corr: bool = True,
    single_alpha: bool = False, singcutoff: float = 1e-10,
    method: str = "auto", fast_scan: bool = False,
    voxel_shards: int = 1, device="cuda",
) -> NestedCVResult:
    """nested_cv_step over a 1-D voxel mesh: Y and Y_test shard on the
    voxel axis (already-sharded VoxelShards are used as they are), X and
    X_test replicate once per distinct device. Each device runs the X-side
    work (Grams, eigendecompositions, solve factors, the refit's
    factorization) once, in a memo its shards share; the voxel side runs
    shard by shard. The per-voxel argmax needs no other shard; only
    single_alpha sums each shard's (A,) fold scores on the first device.
    The result's fields are VoxelShards."""
    complement, scan = _step_route(X, alphas, train_idx, val_idx, normalpha,
                                   singcutoff, method, fast_scan)
    # V divides the mesh (checked by the caller), so shard_padded pads
    # nothing here.
    Y_sh, Yt_sh = (a if isinstance(a, VoxelShards) else shard_padded(a, mesh)
                   for a in (Y, Y_test))
    X_rep, Xt_rep = (replicate(as_f32(a, mesh.devices.flat[0]), mesh)
                     for a in (X, X_test))
    memos = {d: {} for d in X_rep}
    n_vox = Y_sh.shape[-1]
    scans = [_fold_scan(X_rep[y.device], y, as_f32(alphas, y.device),
                        train_idx, val_idx, normalpha, use_corr, singcutoff,
                        method, complement, scan, fast_scan,
                        voxel_shards=voxel_shards, memo=memos[y.device],
                        n_vox=n_vox)
             for y in Y_sh.shards]
    first = Y_sh.shards[0].device
    if single_alpha:
        # The one cross-shard reduction: each shard's (A,) score sums.
        for mc, _ in scans:
            mesh.transfers.append(("reduce", (mc.shape[0],)))
        total = sum(mc.sum(dim=1).to(first) for mc, _ in scans)
        best_idx = int(torch.argmax(total / n_vox))
    union_refit = _union_refit(X_rep[first], scans[0][1], singcutoff)
    logger.info("nested_cv_step: %s scan, %s refit over %d voxel shards",
                scan if complement else "per_fold",
                "union_woodbury" if union_refit else "full", mesh.size)
    out = []
    for y, yt, (mc, aux) in zip(Y_sh.shards, Yt_sh.shards, scans):
        d = y.device
        a_d = as_f32(alphas, d)
        best = (a_d[best_idx].repeat(y.shape[1]) if single_alpha
                else a_d[torch.argmax(mc, dim=0)])
        del mc
        w = _refit(X_rep[d], y, aux, union_refit, best, a_d, normalpha,
                   singcutoff, method, memos[d])
        corr, p = _predict_and_score(Xt_rep[d], yt, w)
        out.append((corr, p, best, w))
    return NestedCVResult(*(VoxelShards(list(parts), mesh)
                            for parts in zip(*out)))


def make_nested_cv_step(mesh=None, **static_kwargs):
    """nested_cv_step with its options bound (and optionally a mesh).

    With a 1-D voxel mesh the returned step places its inputs before
    running: Y and Y_test shard over the voxel axis, which must be
    divisible by the mesh size (use pad_voxels first), X and X_test
    replicate, and `voxel_shards` defaults to the mesh size. It returns a
    NestedCVResult of VoxelShards (see _nested_cv_step_sharded). Without a
    mesh, inputs run on `device`."""
    if mesh is None:
        return functools.partial(nested_cv_step, **static_kwargs)

    def step(X, Y, X_test, Y_test, *args, **kwargs):
        kw = {**static_kwargs, **kwargs}
        n = resolve_voxel_mesh(mesh, None, "make_nested_cv_step",
                               resolve_device(kw.get("device", "cuda"))).size
        if Y.shape[-1] % n:
            raise ValueError(
                f"voxel axis ({Y.shape[-1]}) not divisible by mesh size "
                f"({n}); use pad_voxels first")
        kw.setdefault("voxel_shards", n)
        return _nested_cv_step_sharded(mesh, X, Y, X_test, Y_test, *args,
                                       **kw)

    return step


def equal_size_folds(n_samples: int, n_folds: int, chunk_length: int,
                     seed: int = 0):
    """Equal-size chunked folds as dense index matrices for the step.

    Returns (train_idx (F, Ttr), val_idx (F, Tva)) int32 arrays: the chunk
    shuffle of models.folding.create_chunked_folds with the remainder
    chunks dropped, so every fold has the same shape.
    """
    n_chunks = n_samples // chunk_length
    usable = (n_chunks // n_folds) * n_folds
    chunk_ids = np.arange(n_chunks)
    np.random.default_rng(seed).shuffle(chunk_ids)
    chunk_ids = chunk_ids[:usable]
    per_fold = usable // n_folds

    val_idx, train_idx = [], []
    for f in range(n_folds):
        va = np.sort(chunk_ids[f * per_fold:(f + 1) * per_fold])
        tr = np.sort(np.concatenate(
            [chunk_ids[:f * per_fold], chunk_ids[(f + 1) * per_fold:]]
        ))
        val_idx.append(
            (va[:, None] * chunk_length + np.arange(chunk_length)).ravel()
        )
        train_idx.append(
            (tr[:, None] * chunk_length + np.arange(chunk_length)).ravel()
        )
    return (np.stack(train_idx).astype(np.int32),
            np.stack(val_idx).astype(np.int32))

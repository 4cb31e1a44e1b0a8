"""Banded (grouped) ridge regression (twin of
litcoder_core_tpu/models/banded.py).

One regularizer per feature space (band): scaling band b's features by
sqrt(gamma_b) and fitting ordinary ridge is the same as a per-band alpha,
with gamma_b the band's share of the prior variance (la Tour et al. 2022).
`sample_gammas` draws the candidate gamma vectors (the uniform one first);
for each candidate the whole alpha grid is scored on the inner folds, and
each voxel takes the (gamma, alpha) pair with the best mean fold score.

The scan takes the JAX package's routes, in its gate order, recorded in
metrics['solver_paths']['banded_scan']:
- 'chol' (tall folds, normalpha, min alpha >= 0.03, singcutoff <= 1e-10, or
  method='chol'): the union Gram downdated per fold and scaled by s s^T per
  gamma, a Lanczos lambda-max per gamma, one Cholesky per alpha. With
  `voxel_chunk_size` on complementary folds the scan is Python-level
  (fold, gamma, voxel-chunk) loops whose (A, D, Tva) solve factors are
  computed once per (fold, gamma); with a host response (a numpy Y, or a
  tensor that is not on `device`) the (D, V) cross-product is built once
  from pinned host column chunks and per fold only the validation rows go
  to the card;
- 'dual' (wide folds or method='dual'): per-band kernels formed once, each
  gamma a weighted sum of them, one Cholesky per (gamma, alpha);
- 'svd_fallback' (method='svd', or wide folds without the gates): one
  ridge_svd per (gamma, fold);
- 'eigh' (tall folds without the gates): one eigh per (gamma, fold).
The refit ('banded_refit') is 'grouped_chol' under the same gates on a tall
design (voxels grouped by their winning (gamma, alpha), one Cholesky per
group against the gathered columns of s * X^T Y) and 'spectral' otherwise.

All products run in fp32 with TF32 off (the JAX package's
Precision.HIGHEST); `fast_scan` turns TF32 on around the scan's V-scaled
products only, and the refit always runs in fp32. The host computes the
float64 p-values and BH-FDR. `mesh`/`n_devices` shard the scan's voxel
axis over a 1-D device mesh (parallel/mesh.py).
"""

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.nested_cv import (
    _calib_voxels,
    _cholesky_solve_all,
    _fast_scan_accept,
    _folds_cover_all_rows,
    _permutation_offsets,
    _score_alphas_from_factors,
    _score_fold_voxel_chunks,
    _shifted_cholesky,
    _voxel_chunks,
)
from litcoder_core_torch.models.ridge import (
    _score_predictions,
    lmax_dense,
    ridge_corr_from_svd,
    ridge_fit_from_svd,
    ridge_svd,
    score_alpha_grid,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    pearson_pvalues_f64,
    pearson_r,
    permutation_pvalues,
    zscore,
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


def sample_gammas(n_bands: int, n_gammas: int, seed: int = 0,
                  concentration: float = 1.0) -> np.ndarray:
    """(n_gammas, n_bands) candidate band-variance shares; row 0 is uniform."""
    rng = np.random.default_rng(seed)
    gammas = rng.dirichlet([concentration] * n_bands,
                           size=max(n_gammas - 1, 0))
    uniform = np.full((1, n_bands), 1.0 / n_bands)
    out = np.vstack([uniform, gammas]) if n_gammas > 1 else uniform
    return out.astype(np.float32)


def _scale_vector(widths: Sequence[int], gamma,
                  device: torch.device) -> torch.Tensor:
    """(D_total,) per-feature sqrt(gamma_band), the square root taken in
    float32 as the JAX package does."""
    return torch.cat([
        torch.full((w,), float(np.sqrt(np.float32(g))), dtype=torch.float32,
                   device=device)
        for w, g in zip(widths, gamma)
    ])


def _index(rows, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows), device=device)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 copy of a host array on `device`: through pinned memory with a
    non-blocking copy on a card (torch's pinned allocator keeps the staging
    buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _score_gammas(Xs, Y, gammas, inner_splits, alphas, normalpha: bool,
                  use_corr: bool, singcutoff: float, method: str,
                  paths: Dict[str, str], fast_scan: bool = False,
                  voxel_chunk: Optional[int] = None,
                  Xc: torch.Tensor = None,
                  G_precomputed: Optional[torch.Tensor] = None,
                  XtY_precomputed: Optional[torch.Tensor] = None,
                  total_voxels: Optional[int] = None
                  ) -> torch.Tensor:
    """(G, A, V) mean inner-fold scores for every gamma candidate.

    Xs gives the band widths; the features are `Xc`, their concatenation
    on the fit's device. Y is a tensor on that device, or a host numpy
    array in host-streaming mode, which needs `XtY_precomputed`. Folds are
    grouped by (train, val) shape and each group's mean is weighted by its
    size, as in the JAX package. `total_voxels` (default Y's width) is the
    voxel count the chol scan's solve side follows: a voxel shard's whole
    axis, as the JAX package's sharded program sees it.
    """
    widths = [X.shape[1] for X in Xs]
    dev = Xc.device
    D = Xc.shape[1]
    alphas_t = torch.as_tensor(np.asarray(alphas, np.float32), device=dev)

    tall = (min((len(tr) for tr, _ in inner_splits), default=0) >= D)
    a_np = np.asarray(alphas)
    gates_ok = bool(normalpha and singcutoff <= 1e-10
                    and a_np.size and np.all(a_np >= 0.03))
    scan = "chol" if (method in ("auto", "chol") and gates_ok) else "eigh"
    dual_scan = (method == "dual"
                 or (not tall and method in ("auto", "chol") and gates_ok))
    V_in = Y.shape[1]
    chunk_ok = bool(voxel_chunk and V_in > int(voxel_chunk))

    if method == "svd" or (not tall and not dual_scan):
        if fast_scan:
            logger.warning(
                "banded fast_scan requested but the direct per-(gamma, "
                "fold) fallback engaged (method='svd' / fat design); "
                "running the fp32 scan"
            )
        paths["banded_scan"] = "svd_fallback"
        Y = as_f32(Y, dev)
        svd_method = "auto" if method == "chol" else method
        all_scores = []
        for g in gammas:
            Xg = Xc * _scale_vector(widths, g, dev)[None, :]
            corr_sum = torch.zeros((len(alphas_t), V_in), dtype=torch.float32,
                                   device=dev)
            for train_idx, val_idx in inner_splits:
                tr, va = _index(train_idx, dev), _index(val_idx, dev)
                svd = ridge_svd(Xg[tr], Xg[va], singcutoff=singcutoff,
                                method=svd_method)
                nal = alphas_t * svd.S[0] if normalpha else alphas_t
                corr_sum += ridge_corr_from_svd(svd, Y[tr], Y[va], nal,
                                                use_corr=use_corr)
            all_scores.append(corr_sum / len(inner_splits))
        return torch.stack(all_scores)

    groups: Dict[Tuple[int, int], list] = {}
    for tr, va in inner_splits:
        groups.setdefault((len(tr), len(va)), []).append((tr, va))

    def _grouped(group_scores):
        """Shape-grouped fold means, reweighted by group size."""
        if len(groups) == 1:
            return group_scores(inner_splits)
        total = None
        for folds in groups.values():
            s = group_scores(folds) * float(len(folds))
            total = s if total is None else total + s
        return total / float(len(inner_splits))

    if dual_scan:
        chunk = int(voxel_chunk) if chunk_ok else None
        offs = np.cumsum([0] + widths)
        Kbands = torch.stack([Xc[:, lo:hi] @ Xc[:, lo:hi].T
                              for lo, hi in zip(offs[:-1], offs[1:])])
        gammas_t = torch.as_tensor(np.asarray(gammas, np.float32),
                                   device=dev)
        logger.info(
            "banded scan path: dual cholesky (kernel-ridge; wide design)")
        paths["banded_scan"] = "dual"
        Y = as_f32(Y, dev)
        return _grouped(lambda folds: _score_gammas_dual(
            Kbands, Y, gammas_t, folds, alphas_t, normalpha, use_corr,
            fast_scan, chunk))

    paths["banded_scan"] = scan
    scales = torch.stack([_scale_vector(widths, g, dev) for g in gammas])

    # Complement identity: when every fold's train rows are all rows minus
    # its val rows, G_tr = G_all - Xva^T Xva and X_tr^T Y_tr = XtY_all -
    # Xva^T Yva, with no (T_tr, .) train gathers.
    complement = _folds_cover_all_rows(inner_splits, Xc.shape[0])
    chunk = None
    if chunk_ok:
        if scan == "chol":
            chunk = int(voxel_chunk)
        else:
            logger.warning(
                "voxel_chunk_size requires the Cholesky scan (normalpha, "
                "alpha >= 0.03, singcutoff <= 1e-10); running unchunked"
            )

    G_all = XtY_all = None
    if complement:
        G_all = G_precomputed if G_precomputed is not None else Xc.T @ Xc
        if XtY_precomputed is not None:
            XtY_all = XtY_precomputed
        elif chunk is None:
            # The chunked scan derives its cross-product chunk by chunk:
            # no persistent (D, V) buffer.
            with matmul_tf32(fast_scan):
                XtY_all = Xc.T @ Y

    if chunk is not None and complement:
        return _chol_scan_chunked(Xc, Y, scales, inner_splits, alphas_t,
                                  normalpha, use_corr, fast_scan, G_all,
                                  XtY_all, chunk)
    # Only the chunked complement scan streams a host response.
    Y = as_f32(Y, dev)
    return _grouped(lambda folds: _score_gammas_fast(
        Xc, Y, scales, folds, alphas_t, normalpha, use_corr, singcutoff,
        scan, fast_scan, complement, G_all, XtY_all, chunk, total_voxels))


def _chol_L(Gg: torch.Tensor, na) -> torch.Tensor:
    """Cholesky factor of (Gg + na^2 I), NaN where the matrix is not
    positive definite (jnp.linalg.cholesky's result there)."""
    eye = torch.eye(Gg.shape[0], dtype=torch.float32, device=Gg.device)
    L, info = torch.linalg.cholesky_ex(Gg + (na * na) * eye)
    return torch.where(info > 0, float("nan"), L)


def _cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 B by two triangular solves."""
    Z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, Z, upper=True)


def _predict_group(X_test: torch.Tensor, s_vec: torch.Tensor,
                   wg: torch.Tensor) -> torch.Tensor:
    """Test predictions of one refit group: (X_test * s) wg."""
    return (X_test * s_vec[None, :]) @ wg


def _refit_gamma_predict(G_shared: torch.Tensor, XtY_full: torch.Tensor,
                         X_test: torch.Tensor, s_vec: torch.Tensor,
                         alphas: torch.Tensor, flat_base: int,
                         pair_sel: torch.Tensor, has_winner: np.ndarray,
                         pred_acc: torch.Tensor) -> torch.Tensor:
    """Test predictions for all of one gamma candidate's winning voxels
    (prediction-only refits): for each alpha that won a voxel under this
    gamma, C_a = (Gg + nal^2 I)^-1 (X_test * s)^T (D, Tp), its predictions
    ((C_a * s)^T) XtY_full for every voxel, kept where the voxel's winning
    pair index `pair_sel` (best_gamma * A + best_alpha) matches. Extra
    memory is one (D, D) factor and one (Tp, V) prediction, whatever the
    group sizes."""
    Gg = G_shared * (s_vec[:, None] * s_vec[None, :])
    s0 = torch.sqrt(torch.clamp(lmax_dense(Gg), min=0.0))  # normalpha scale
    Xts = (X_test * s_vec[None, :]).T                      # (D, Tp)
    for a in np.flatnonzero(has_winner):
        C = _cholesky_solve(_chol_L(Gg, alphas[a] * s0), Xts)
        pred_a = (C * s_vec[:, None]).T @ XtY_full          # (Tp, V)
        mask = pair_sel == (flat_base + int(a))
        pred_acc = torch.where(mask[None, :], pred_a, pred_acc)
    return pred_acc


def _chol_solve_gather(L: torch.Tensor, s_vec: torch.Tensor,
                       XtY_full: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Refit weights of one (gamma, alpha) voxel group:
    (Gg + na^2 I)^-1 (s * X^T Y)[:, idx]. The JAX package pads `idx` to a
    _bucket_width for XLA's compile reuse; the port gathers the exact
    columns."""
    return _cholesky_solve(L, s_vec[:, None] * XtY_full[:, idx])


def _bucket_width(n: int, minimum: int = 128) -> int:
    """A refit-group voxel count rounded up to a power-of-2 bucket (the JAX
    package's jit-signature reuse; stacking pads its groups with it)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _chol_scan_solves(Xc: torch.Tensor, G_all: torch.Tensor,
                      s: torch.Tensor, va: torch.Tensor,
                      alphas: torch.Tensor, normalpha: bool) -> torch.Tensor:
    """(A, D, Tva) voxel-independent solve factors of one (fold, gamma):
    Z_a = (Gg + nal_a^2 I)^-1 (Xva * s)^T, Gg the gamma-scaled
    complement-downdated training Gram. Shared by every voxel chunk."""
    Xva = Xc[va]
    Gg = (G_all - Xva.T @ Xva) * (s[:, None] * s[None, :])
    L, _ = _shifted_cholesky(Gg, alphas, normalpha)
    return _cholesky_solve_all(L, (Xva * s[None, :]).T)


def _alpha_batched_scores(Z_all: torch.Tensor, sXtY_c: torch.Tensor,
                          Yc: torch.Tensor, use_corr: bool, fast_scan: bool,
                          alpha_batch: int) -> torch.Tensor:
    """(A, chunk) scores from the per-alpha solve factors, `alpha_batch`
    alphas per batched (ab, Tva, D) @ (D, chunk) product, so the (A, Tva,
    chunk) prediction block never exists whole."""
    zPc = zscore(Yc, dim=0)
    a_n = Z_all.shape[0]
    ab = alpha_batch if 0 < alpha_batch < a_n else a_n
    out = []
    for lo in range(0, a_n, ab):
        with matmul_tf32(fast_scan):
            pred = Z_all[lo:lo + ab].mT @ sXtY_c[None]         # (ab, Tva, c)
        out.extend(_score_predictions(p, Yc, zPc, use_corr) for p in pred)
    return torch.stack(out)


def _chol_scan_score_chunk(Xc: torch.Tensor, Y: torch.Tensor,
                           XtY_all: Optional[torch.Tensor],
                           Z_all: torch.Tensor, s: torch.Tensor,
                           va: torch.Tensor, c0: int, chunk: int,
                           use_corr: bool, fast_scan: bool,
                           alpha_batch: int = 0) -> torch.Tensor:
    """(A, chunk) scores of one (fold, gamma, voxel-chunk) step with the
    response on the card: the chunk's full-row cross-product (from XtY_all,
    or from the (T, chunk) column view when there is none) downdated by the
    val rows."""
    Ycol = Y[:, c0:c0 + chunk]
    Yc = Ycol[va]
    with matmul_tf32(fast_scan):
        full_c = (Xc.T @ Ycol if XtY_all is None
                  else XtY_all[:, c0:c0 + chunk])
        XtY_c = full_c - Xc[va].T @ Yc
    return _alpha_batched_scores(Z_all, s[:, None] * XtY_c, Yc, use_corr,
                                 fast_scan, alpha_batch)


def _chol_scan_score_chunk_tr(XtY_tr: torch.Tensor, Yva: torch.Tensor,
                              Z_all: torch.Tensor, s: torch.Tensor, c0: int,
                              chunk: int, use_corr: bool, fast_scan: bool,
                              alpha_batch: int = 0) -> torch.Tensor:
    """(A, chunk) scores of one (fold, gamma, voxel-chunk) step in
    host-streaming mode: the fold's downdated train cross-product and its
    uploaded val rows are the only response-sized inputs."""
    sXtY_c = s[:, None] * XtY_tr[:, c0:c0 + chunk]
    return _alpha_batched_scores(Z_all, sXtY_c, Yva[:, c0:c0 + chunk],
                                 use_corr, fast_scan, alpha_batch)


def _scan_chunk_cap(t_rows: int, chunk: int,
                    budget_bytes: int = 512 * 2**20) -> int:
    """Cap the scan's voxel chunk so the (T, chunk) response column slice
    stays under `budget_bytes` (the JAX package's budget, unchanged)."""
    cap = max(512, (budget_bytes // (4 * t_rows)) // 512 * 512)
    return min(chunk, cap)


def _scan_alpha_batch(a_n: int, t_va: int, chunk: int,
                      budget_bytes: int = 256 * 2**20) -> int:
    """Largest divisor of the alpha-grid size whose (ab, Tva, chunk)
    prediction block fits `budget_bytes`."""
    per_alpha = 4 * t_va * chunk
    best = 1
    for ab in range(1, a_n + 1):
        if a_n % ab == 0 and ab * per_alpha <= budget_bytes:
            best = ab
    return best


def _chol_scan_chunked(Xc: torch.Tensor, Y, scales: torch.Tensor,
                       inner_splits, alphas: torch.Tensor, normalpha: bool,
                       use_corr: bool, fast_scan, G_all: torch.Tensor,
                       XtY_all: Optional[torch.Tensor],
                       chunk: int) -> torch.Tensor:
    """(G, A, V) chunked Cholesky scan as loops fold -> gamma -> voxel
    chunk: the (A, D, Tva) solve factors once per (fold, gamma), reused by
    every chunk. The chunk is capped and the alpha axis batched by the JAX
    package's memory budgets.

    Two response layouts: a tensor on the card, sliced (T, chunk) per step;
    or a host numpy Y (needs the (D, V) XtY_all from _xty_streamed), whose
    val rows go to the card once per fold with the fold's downdated train
    cross-product, both freed before the next fold."""
    fast = bool(fast_scan)
    dev = Xc.device
    n_g = scales.shape[0]
    v_in, t_rows = Y.shape[1], Y.shape[0]
    host_Y = isinstance(Y, np.ndarray)
    if host_Y and XtY_all is None:
        raise ValueError(
            "host-streaming chunked scan requires the precomputed (D, V) "
            "cross-product (fit_banded_ridge builds it via _xty_streamed)"
        )
    cap_rows = (max(len(va) for _, va in inner_splits) if host_Y
                else t_rows)
    chunk_eff = _scan_chunk_cap(cap_rows, chunk)
    if chunk_eff != chunk:
        logger.info(
            "banded chunked scan: voxel_chunk %d capped to %d "
            "((T, chunk) slice transient budget)", chunk, chunk_eff)
    chunk = chunk_eff
    a_n = alphas.shape[0]
    fold_sum = None
    for _tr, va_np in inner_splits:
        va = _index(va_np, dev)
        Yva = XtY_tr = None
        if host_Y:
            Yva = _to_device(Y[np.asarray(va_np)], dev)
            with matmul_tf32(fast):
                XtY_tr = XtY_all - Xc[va].T @ Yva
        per_gamma = []
        for s in scales:
            Z_all = None  # free the last gamma's factors before solving
            Z_all = _chol_scan_solves(Xc, G_all, s, va, alphas, normalpha)
            parts = []
            for c0, c1 in _voxel_chunks(v_in, chunk):
                ab = _scan_alpha_batch(a_n, len(va_np), c1 - c0)
                if host_Y:
                    parts.append(_chol_scan_score_chunk_tr(
                        XtY_tr, Yva, Z_all, s, c0, c1 - c0, use_corr, fast,
                        ab))
                else:
                    parts.append(_chol_scan_score_chunk(
                        Xc, Y, XtY_all, Z_all, s, va, c0, c1 - c0, use_corr,
                        fast, ab))
            per_gamma.append(torch.cat(parts, dim=-1))             # (A, V)
        del Z_all, Yva, XtY_tr
        fold_sc = torch.stack(per_gamma)                           # (G, A, V)
        fold_sum = fold_sc if fold_sum is None else fold_sum + fold_sc
    return fold_sum / float(len(inner_splits))


def _xty_streamed(Xc: torch.Tensor, Y_host: np.ndarray,
                  col_chunk: int = 4096) -> torch.Tensor:
    """(D, V) fp32 cross-product of the card's feature concatenation with a
    host response, built from (T, col_chunk) pinned column uploads: no
    (T, V) buffer ever exists on the card."""
    dev = Xc.device
    v = Y_host.shape[1]
    out = torch.empty((Xc.shape[1], v), dtype=torch.float32, device=dev)
    for c0 in range(0, v, col_chunk):
        Ycol = _to_device(Y_host[:, c0:c0 + col_chunk], dev)
        out[:, c0:c0 + Ycol.shape[1]] = Xc.T @ Ycol
    return out


def _score_gammas_fast(Xc: torch.Tensor, Y: torch.Tensor,
                       scales: torch.Tensor, folds, alphas: torch.Tensor,
                       normalpha: bool, use_corr: bool, singcutoff: float,
                       scan: str = "eigh", fast_scan: bool = False,
                       complement: bool = False,
                       G_all: Optional[torch.Tensor] = None,
                       XtY_all: Optional[torch.Tensor] = None,
                       chunk: Optional[int] = None,
                       total_voxels: Optional[int] = None) -> torch.Tensor:
    """(G, A, V) mean scores over `folds` with shared per-fold Grams and
    cross-products; each gamma only rescales them (G_g = s s^T * G,
    X_g^T Y = s * X^T Y).

    scan='chol': per alpha a Cholesky and two triangular solves, against the
    smaller side: Xva^T (D, Tva) at full voxel counts, s X^T Y (D, V) when
    V < Tva (the fast_scan='auto' calibration subset). `chunk` (chol scan,
    gather-form folds) streams the voxel side per column chunk after the
    factors are solved. scan='eigh': one eigh per (fold, gamma) and the
    spectral alpha grid. fast_scan runs the V-scaled products with TF32."""
    dev = Xc.device
    chunked = chunk is not None
    acc = 0
    for train_idx, val_idx in folds:
        tr, va = _index(train_idx, dev), _index(val_idx, dev)
        Xva = Xc[va]
        if complement:
            G_tr = G_all - Xva.T @ Xva
        else:
            Xtr = Xc[tr]
            G_tr = Xtr.T @ Xtr
        if not chunked:
            Yva = Y[va]
            with matmul_tf32(fast_scan):
                XtY = (XtY_all - Xva.T @ Yva if complement
                       else Xtr.T @ Y[tr])                      # (D, V)
        per_gamma = []
        for s in scales:
            Gg = G_tr * (s[:, None] * s[None, :])
            Xva_s = Xva * s[None, :]
            if scan == "chol":
                L, _ = _shifted_cholesky(Gg, alphas, normalpha)
                if chunked:
                    Z_all = _cholesky_solve_all(L, Xva_s.T)   # (A, D, Tva)

                    def one_chunk(c0, c1):
                        Ycol = Y[:, c0:c1]
                        with matmul_tf32(fast_scan):
                            XtY_c = Xtr.T @ Ycol[tr]
                        return _score_alphas_from_factors(
                            Z_all, s[:, None] * XtY_c, Ycol[va], use_corr,
                            fast_scan)

                    per_gamma.append(torch.cat(
                        [one_chunk(c0, c1)
                         for c0, c1 in _voxel_chunks(Y.shape[1], chunk)],
                        dim=-1))
                elif (Y.shape[1] if total_voxels is None
                      else total_voxels) < Xva.shape[0]:      # voxel side
                    zP = zscore(Yva, dim=0)
                    out = []
                    for Z in _cholesky_solve_all(L, s[:, None] * XtY):
                        with matmul_tf32(fast_scan):
                            pred = Xva_s @ Z
                        out.append(_score_predictions(pred, Yva, zP,
                                                      use_corr))
                    per_gamma.append(torch.stack(out))
                else:
                    per_gamma.append(_score_alphas_from_factors(
                        _cholesky_solve_all(L, Xva_s.T), s[:, None] * XtY,
                        Yva, use_corr, fast_scan))
            else:
                evals, evecs = torch.linalg.eigh(Gg)           # ascending
                S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]),
                                           min=0.0))
                Vh = torch.flip(evecs, dims=[1]).T
                good = S > singcutoff
                inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0),
                                    0.0)
                with matmul_tf32(fast_scan):
                    UR = inv_s[:, None] * (Vh @ (s[:, None] * XtY))
                nal = alphas * S[0] if normalpha else alphas
                per_gamma.append(score_alpha_grid(
                    S, good, Xva_s @ Vh.T, UR, Yva, nal, use_corr=use_corr,
                    fast_scan=fast_scan))
        acc = acc + torch.stack(per_gamma)
    return acc / float(len(folds))


def _score_gammas_dual(Kbands: torch.Tensor, Y: torch.Tensor,
                       gammas: torch.Tensor, folds, alphas: torch.Tensor,
                       normalpha: bool, use_corr: bool,
                       fast_scan: bool = False,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """(G, A, V) mean scores over `folds` by the dual (kernel-ridge)
    identity for wide designs: Kbands (B, T, T) holds K_b = X_b X_b^T,
    formed once; gamma g's kernel is sum_b g_b K_b. Per (fold, gamma) one
    Cholesky per alpha gives M_a = (K_tr + nal_a^2 I)^-1 K_tr,va and the
    predictions M_a^T Y_tr, voxel chunk by voxel chunk (`chunk`)."""
    dev = Kbands.device
    acc = 0
    for train_idx, val_idx in folds:
        tr, va = _index(train_idx, dev), _index(val_idx, dev)
        Kb_tr = Kbands[:, tr[:, None], tr[None, :]]             # (B, Ttr, Ttr)
        Kb_trva = Kbands[:, tr[:, None], va[None, :]]           # (B, Ttr, Tva)
        per_gamma = []
        for g in gammas:
            L, _ = _shifted_cholesky(torch.tensordot(g, Kb_tr, dims=1),
                                     alphas, normalpha)
            M_all = _cholesky_solve_all(L, torch.tensordot(g, Kb_trva,
                                                           dims=1))
            per_gamma.append(_score_fold_voxel_chunks(
                M_all, Y, use_corr, chunk, fast_scan, form="dual", tr=tr,
                va=va))
        acc = acc + torch.stack(per_gamma)
    return acc / float(len(folds))


def _is_host(Y, device: torch.device) -> bool:
    """A numpy response, or a tensor that is not on the fit's device."""
    if isinstance(Y, torch.Tensor):
        return Y.device.type != device.type or (
            device.index is not None and Y.device.index != device.index)
    return True


# The fit runs in full fp32 (the JAX package's Precision.HIGHEST) and gives
# the caller back its TF32 setting on return; a fast scan turns TF32 on
# around its own products only.
@matmul_tf32(False)
def fit_banded_ridge(
    Xs: Sequence,
    Y,
    X_tests: Optional[Sequence] = None,
    y_test=None,
    alphas: Optional[Sequence[float]] = None,
    n_gammas: int = 10,
    folding_type: str = "chunked",
    n_inner_folds: int = 5,
    chunk_length: int = 20,
    alpha_fdr: float = 0.05,
    normalpha: bool = True,
    use_corr: bool = True,
    singcutoff: float = 1e-10,
    seed: int = 0,
    method: str = "auto",
    mesh=None,
    n_devices: Optional[int] = None,
    fast_scan=False,
    significance: str = "parametric",
    n_permutations: int = 1000,
    voxel_chunk_size: Optional[int] = None,
    return_weights: bool = True,
    device="cuda",
) -> Tuple[Dict, Optional[np.ndarray], np.ndarray, np.ndarray]:
    """Banded ridge with per-voxel (gamma, alpha) selection by inner CV, on
    `device`.

    Args:
        Xs: list of (T, D_b) training feature spaces (numpy or tensors).
        Y: (T, V) training responses. A numpy Y (or a tensor that is not on
            `device`) with `voxel_chunk_size` and the Cholesky-scan gates
            stays on the host: the scan streams it.
        X_tests / y_test: list of (Tp, D_b) test spaces and (Tp, V) test
            responses, given together.
        fast_scan: False (fp32 scan), True (TF32 on the scan's V-scaled
            products) or 'auto' (the TF32 scan, accepted when its per-voxel
            (gamma, alpha) argmax agrees with an fp32 scan of a calibration
            voxel subset; otherwise the scan reruns in fp32). The refit is
            always fp32.
        significance / n_permutations: 'parametric' (float64 Pearson tail)
            or 'permutation' (circular-shift nulls, one offset draw for all
            voxels, p-values floored at 1/(n_permutations + 1)).
        voxel_chunk_size: stream the scan's voxel-dependent work through
            voxel chunks (chol scan only; ignored with a warning otherwise).
        return_weights: False returns None for the weights (the test set is
            still scored).
        mesh / n_devices: a 1-D voxel mesh (or a device count to build
            one; n entries of the CPU for a CPU fit): the (gamma, alpha)
            scan runs shard by shard on zero-padded voxel shards and
            replaces voxel chunking; the fast-scan calibration, the refit
            (spectral under a mesh) and the test scoring read the whole Y.

    Returns:
        (metrics, weights (sum D_b, V) or None, best_alphas (V,),
        best_gammas (V, B)), on the host. Metrics keys are the train/test
        nested-CV dict's plus 'best_gammas'.
    """
    paths: Dict[str, str] = {}
    if fast_scan not in (True, False, "auto"):
        raise ValueError(
            f"fast_scan must be True, False or 'auto', got {fast_scan!r}"
        )
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
    if (X_tests is None) != (y_test is None):
        raise ValueError("X_tests and y_test must be given together")
    if alphas is None:
        alphas = np.logspace(-1, 8, 10)
    alphas = np.asarray(alphas, np.float32)
    n_bands = len(Xs)
    T = Xs[0].shape[0]
    if Y.shape[0] != T:
        raise ValueError(
            f"Y has {Y.shape[0]} rows; feature spaces have {T}"
        )
    if X_tests is not None:
        if len(X_tests) != n_bands:
            raise ValueError(
                f"{len(X_tests)} test spaces for {n_bands} train spaces"
            )
        for b, (Xt, Xb) in enumerate(zip(X_tests, Xs)):
            if Xt.shape[0] != y_test.shape[0]:
                raise ValueError(
                    f"test space {b} has {Xt.shape[0]} rows; y_test has "
                    f"{y_test.shape[0]}"
                )
            if Xt.shape[1] != Xb.shape[1]:
                raise ValueError(
                    f"test space {b} has {Xt.shape[1]} features; train "
                    f"space has {Xb.shape[1]}"
                )
    from litcoder_core_torch.parallel.mesh import (
        replicate,
        resolve_voxel_mesh,
        shard_padded,
    )

    dev = resolve_device(device)
    vox_mesh = resolve_voxel_mesh(mesh, n_devices, "fit_banded_ridge", dev)
    V = Y.shape[1]
    D_total = sum(X.shape[1] for X in Xs)

    # Host-streaming mode: a host response with voxel chunking under the
    # Cholesky-scan gates never goes to the card whole; the scan reads a
    # (D, V) cross-product built once from column chunks (the refit reuses
    # it) and per fold the val rows.
    stream_host = bool(
        voxel_chunk_size and vox_mesh is None and _is_host(Y, dev)
        and V > int(voxel_chunk_size)
        and method in ("auto", "chol") and normalpha
        and singcutoff <= 1e-10
        and alphas.size and float(alphas.min()) >= 0.03
        and T >= D_total
    )
    if stream_host:
        Y_j = np.ascontiguousarray(to_numpy(Y), dtype=np.float32)
        logger.info(
            "banded host-streaming scan: response stays host-side "
            "(%.1f GB); XtY + per-fold val rows stream to device",
            Y_j.nbytes / 2**30,
        )
    else:
        # Y_j stays whole on the fit's device under a mesh too: the
        # calibration scan, the spectral refit and the test scoring read it.
        Y_j = as_f32(Y, dev)
    Y_shards = None
    if vox_mesh is not None:
        Y_shards = shard_padded(Y_j, vox_mesh).shards
        logger.info(
            "banded voxel-sharded scan: %d voxels (+%d pad) over %d devices",
            V, sum(y.shape[1] for y in Y_shards) - V, vox_mesh.size,
        )
        if voxel_chunk_size:
            logger.info(
                "mesh sharding replaces voxel chunking; voxel_chunk_size "
                "ignored (each device holds 1/%d of the voxel axis)",
                vox_mesh.size,
            )

    gammas = sample_gammas(n_bands, n_gammas, seed=seed)
    inner_splits = create_folds(T, folding_type, n_inner_folds, chunk_length,
                                seed=seed)

    # Cholesky refit gate (the chol scan's conditions on a tall design),
    # decided before the scan so both share the (D, D) Gram.
    # With a voxel-sharded Y the refit's (D, V) X^T Y would be sharded too
    # and each (gamma, alpha) group would gather columns across shards:
    # mesh fits keep the spectral refit, as the JAX package's do.
    chol_refit = bool(
        method in ("auto", "chol") and normalpha and singcutoff <= 1e-10
        and alphas.size and float(alphas.min()) >= 0.03
        and T >= D_total and vox_mesh is None
    )
    Xc = torch.cat([as_f32(X, dev) for X in Xs], dim=1)
    G_shared = Xc.T @ Xc if chol_refit else None

    timer = StageTimer(sync_fn=synchronizer(dev))
    XtY_shared = None
    if stream_host:
        with timer.stage("xty_stream"):
            XtY_shared = _xty_streamed(Xc, Y_j)

    def _scan(Y_in, fast: bool):
        main = Y_in is Y_j
        if main and Y_shards is not None:
            # Shard by shard on each shard's device (Xc replicated once
            # per device); the scores meet on the fit's device and the
            # pad columns go before the argmax.
            Xc_rep = replicate(Xc, vox_mesh)
            total = sum(y.shape[1] for y in Y_shards)
            parts = [_score_gammas(
                Xs, y, gammas, inner_splits, alphas, normalpha, use_corr,
                singcutoff, method, paths, fast_scan=fast,
                Xc=Xc_rep[y.device], total_voxels=total)
                for y in Y_shards]
            return torch.cat([p.to(dev) for p in parts], dim=-1)[..., :V]
        return _score_gammas(
            Xs, Y_in, gammas, inner_splits, alphas, normalpha, use_corr,
            singcutoff, method, paths, fast_scan=fast,
            voxel_chunk=voxel_chunk_size if main else None, Xc=Xc,
            G_precomputed=G_shared,
            XtY_precomputed=XtY_shared if main else None,
        )

    if fast_scan == "auto":
        with timer.stage("scan_bf16"):
            scores = _scan(Y_j, True)
        calib = _calib_voxels(V)
        with timer.stage("scan_calibration_fp32"):
            cal_cols = (as_f32(Y_j[:, calib], dev) if stream_host
                        else Y_j[:, torch.as_tensor(calib, device=dev)])
            s_cal = _scan(cal_cols, False)
        if not _fast_scan_accept(scores, s_cal, calib, label=" (banded)"):
            with timer.stage("scan_fp32_fallback"):
                scores = _scan(Y_j, False)
    else:
        with timer.stage("scan"):
            scores = _scan(Y_j, bool(fast_scan))

    # Joint argmax over (gamma, alpha) per voxel; ties go to the first.
    best_flat = to_numpy(torch.argmax(scores.reshape(-1, V), dim=0))
    del scores
    a_n = len(alphas)
    best_g = best_flat // a_n
    best_a = best_flat % a_n
    best_alphas = alphas[best_a]
    best_gammas = gammas[best_g]                              # (V, B)

    widths = [X.shape[1] for X in Xs]
    weights = None
    X_test_dev = None
    if X_tests is not None:
        X_test_dev = torch.cat([as_f32(X, dev) for X in X_tests], dim=1)
    pred_nat = None  # (Tp, V) test predictions in natural voxel order
    with timer.stage("refit"):
        group_vox, group_preds, group_wts = [], [], []
        if chol_refit and (return_weights or X_tests is not None):
            # The stream's cross-product is fp32 and reused; a card-side
            # one is recomputed in fp32 (the scan's may have been TF32).
            XtY_full = (XtY_shared if XtY_shared is not None
                        else Xc.T @ Y_j)                     # (D, V)
        if chol_refit and not return_weights and X_tests is not None:
            alphas_t = torch.as_tensor(alphas, device=dev)
            pair_sel = torch.as_tensor(best_flat, device=dev)
            pred_nat = torch.zeros((X_test_dev.shape[0], V),
                                   dtype=torch.float32, device=dev)
            for g_idx in np.unique(best_g):
                has_winner = np.zeros(a_n, bool)
                has_winner[np.unique(best_a[best_g == g_idx])] = True
                pred_nat = _refit_gamma_predict(
                    G_shared, XtY_full, X_test_dev,
                    _scale_vector(widths, gammas[g_idx], dev), alphas_t,
                    int(g_idx) * a_n, pair_sel, has_winner, pred_nat)
        for g_idx in (np.unique(best_g)
                      if (return_weights
                          or (X_tests is not None and not chol_refit))
                      else ()):
            sel = np.nonzero(best_g == g_idx)[0]
            s_vec = _scale_vector(widths, gammas[g_idx], dev)
            if chol_refit:
                Gg = G_shared * (s_vec[:, None] * s_vec[None, :])
                s0 = torch.sqrt(torch.clamp(lmax_dense(Gg), min=0.0))
                for a_idx in np.unique(best_a[sel]):
                    vox = sel[best_a[sel] == a_idx]
                    L = _chol_L(Gg, float(alphas[a_idx]) * s0)
                    wg = _chol_solve_gather(L, s_vec, XtY_full,
                                            _index(vox, dev))
                    group_vox.append(vox)
                    if X_test_dev is not None:
                        group_preds.append(_predict_group(X_test_dev, s_vec,
                                                          wg))
                    if return_weights:
                        # Weights of the raw features: w_raw = sqrt(g) w.
                        group_wts.append(wg * s_vec[:, None])
                continue
            Xg = Xc * s_vec[None, :]
            svd_method = "auto" if method in ("chol", "dual") else method
            svd = ridge_svd(Xg, None, singcutoff=singcutoff,
                            method=svd_method)
            val = torch.as_tensor(best_alphas[sel], device=dev)
            nal = val * svd.S[0] if normalpha else val
            wt = ridge_fit_from_svd(svd, Y_j[:, _index(sel, dev)], nal)
            group_vox.append(sel)
            if X_test_dev is not None:
                group_preds.append(_predict_group(X_test_dev, s_vec, wt))
            if return_weights:
                group_wts.append(wt * s_vec[:, None])
        if group_vox:
            order = np.concatenate(group_vox)
            if group_preds:
                pred_nat = torch.zeros(
                    (X_test_dev.shape[0], V), dtype=torch.float32,
                    device=dev)
                pred_nat[:, _index(order, dev)] = torch.cat(group_preds,
                                                            dim=1)
            if return_weights:
                weights = np.zeros((D_total, V), np.float32)
                weights[:, order] = to_numpy(torch.cat(group_wts, dim=1))
        elif return_weights:
            weights = np.zeros((D_total, V), np.float32)
    XtY_full = XtY_shared = None

    paths["banded_refit"] = "grouped_chol" if chol_refit else "spectral"
    metrics: Dict = {"best_gammas": best_gammas.tolist(),
                     "solver_paths": paths}
    if X_tests is not None and y_test is not None:
        with timer.stage("test_scoring"):
            y_test_j = as_f32(y_test, dev)
            corr = to_numpy(pearson_r(y_test_j, pred_nat))
            if significance == "permutation":
                p_dev, _ = permutation_pvalues(
                    y_test_j, pred_nat,
                    _permutation_offsets(seed, None, n_permutations,
                                         y_test_j.shape[0]))
                pval = to_numpy(p_dev).astype(np.float64)
            else:
                pval = pearson_pvalues_f64(corr, y_test.shape[0])
            significant, corrected = bh_fdrcorrection_np(pval,
                                                         alpha=alpha_fdr)
            n_sig = int(significant.sum())
            metrics.update({
                "median_score": float(np.median(corr)),
                "mean_score": float(np.mean(corr)),
                "std_score": float(np.std(corr)),
                "min_score": float(np.min(corr)),
                "max_score": float(np.max(corr)),
                "correlations": corr.tolist(),
                "p_values": pval.tolist(),
                "corrected_p_values": corrected.tolist(),
                "significant_mask": significant.tolist(),
                "n_significant": n_sig,
                "percent_significant": float(n_sig / V * 100),
                "best_alphas": best_alphas.tolist(),
            })
            if significance == "permutation":
                metrics["significance_method"] = "permutation"
        logger.info("Banded ridge: median r = %.3f, %d/%d significant",
                    metrics["median_score"], n_sig, V)
    metrics["stage_seconds"] = timer.report()
    return metrics, weights, best_alphas, best_gammas


class BandedRidgeModel:
    """Object API over fit_banded_ridge on `device` (the JAX package's
    BandedRidgeModel); `mesh`/`n_devices` shard the scan's voxel axis."""

    def __init__(self, model_name: str = "banded_ridge", seed: int = 0,
                 n_gammas: int = 10, mesh=None,
                 n_devices: Optional[int] = None, device="cuda"):
        self.model_name = model_name
        self.seed = seed
        self.n_gammas = n_gammas
        self.mesh = mesh
        self.n_devices = n_devices
        self.device = device

    def fit_predict(self, feature_spaces, targets, X_tests=None, y_test=None,
                    **kwargs):
        kwargs.setdefault("seed", self.seed)
        kwargs.setdefault("n_gammas", self.n_gammas)
        kwargs.setdefault("mesh", self.mesh)
        kwargs.setdefault("n_devices", self.n_devices)
        kwargs.setdefault("device", self.device)
        return fit_banded_ridge(feature_spaces, targets, X_tests=X_tests,
                                y_test=y_test, **kwargs)

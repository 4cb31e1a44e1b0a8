"""Ridge regression core on tensors (twin of litcoder_core_tpu/models/ridge.py).

- `ridge_svd` is the spectral stage: 'svd' is an economy SVD with the
  singular values at or below `singcutoff` masked (zeroed in every
  product) rather than truncated; 'eigh' eigendecomposes the (D, D) Gram
  (U is never formed), 'dual' the (T, T) kernel; 'auto' picks eigh when
  T >= D. Both eigensolvers return ascending values, so the spectra are
  flipped to descending.
- `score_alpha_grid` scores a whole alpha grid from one spectral state,
  one (Tp, V) prediction alive at a time; `ridge_corr_from_svd`,
  `ridge_fit_from_svd` and the one-call wrappers `ridge_fit`, `ridge_corr`,
  `ridge_corr_pred` build on it (the reference's ridge_regression.py API).
- `score_alpha_grid_woodbury` scores the grid of one fold of the fused
  step (parallel/step.py) from the eigenbasis of the fold-union Gram: a
  (Tva, Tva) Cholesky per alpha instead of a per-fold eigensolve.
- `lmax_dense` gives the `normalpha` scale without an eigendecomposition:
  m-step Lanczos with full reorthogonalisation and the f32 breakdown test.
  `lmax_downdate`/`lmax_update` give it for diag(lam) -/+ P^T P, the fused
  step's fold and full training Grams in the union eigenbasis. The JAX
  fori_loop is a Python loop here: a step is the operator's matvec and
  ops.lanczos_step, its torch ops on the CPU and one hand-written kernel
  launch on CUDA. Every step stays on the device.

All products are float32 with TF32 off (the JAX package's
Precision.HIGHEST: the fit scopes the flag, utils.device.matmul_tf32),
except the alpha-grid prediction products of a fast scan, which run with
TF32 on.

Spans (utils.profiling.annotate): `litcoder.fit.gram` where ridge_svd
forms its Gram or kernel and where the eigh path forms X^T Y;
`litcoder.fit.lmax` around each lmax_* call (counts `steps`, the m run;
`fallback`, 1 where the Ritz value of the whole tridiagonal was not
usable and the leading blocks were searched; `fused`, the steps the
kernel ran).
"""

from typing import NamedTuple, Optional

import torch

from litcoder_core_torch.ops import lanczos_step
from litcoder_core_torch.ops.stats import signed_square_corr, zscore
from litcoder_core_torch.utils.device import matmul_tf32
from litcoder_core_torch.utils.profiling import annotate


class RidgeSVD(NamedTuple):
    """Spectral state of one design."""

    U: Optional[torch.Tensor]    # (T, k) left vectors, or None (eigh path)
    S: torch.Tensor              # (k,) singular values
    Vh: torch.Tensor             # (k, D) right vectors
    good: torch.Tensor           # (k,) bool mask: S > singcutoff
    PVh: Optional[torch.Tensor]  # (Tp, k) validation stimuli in that basis
    X: Optional[torch.Tensor]    # (T, D) training stimuli (U-free products)


def svd_masked(X: torch.Tensor, singcutoff: float = 1e-10):
    """(U, S, Vh, good): economy SVD of (T, D) with good = S > singcutoff;
    downstream products multiply by `good`, so masked components contribute
    nothing (the reference truncates them, ridge_utils.py:44-47)."""
    U, S, Vh = torch.linalg.svd(X.to(torch.float32), full_matrices=False)
    return U, S, Vh, S > singcutoff


def ridge_svd(Rstim: torch.Tensor, Pstim: Optional[torch.Tensor] = None,
              singcutoff: float = 1e-10, method: str = "auto") -> RidgeSVD:
    """Spectral stage: factor the training stimuli, project validation ones."""
    Rstim = Rstim.to(torch.float32)
    T, D = Rstim.shape
    if method == "auto":
        method = "eigh" if T >= D else "dual"

    if method == "dual":
        with annotate("litcoder.fit.gram"):
            K = Rstim @ Rstim.T
        evals, evecs = torch.linalg.eigh(K)  # ascending
        S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
        U = torch.flip(evecs, dims=[1])
        good = S > singcutoff
        inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
        Vh = inv_s[:, None] * (U.T @ Rstim)
        keepX = None
    elif method == "eigh":
        with annotate("litcoder.fit.gram"):
            G = Rstim.T @ Rstim
        evals, evecs = torch.linalg.eigh(G)  # ascending
        S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
        Vh = torch.flip(evecs, dims=[1]).T
        good = S > singcutoff
        U = None
        keepX = Rstim
    elif method == "svd":
        U, S, Vh, good = svd_masked(Rstim, singcutoff)
        keepX = None
    else:
        raise ValueError(f"ridge_svd method must be 'auto', 'eigh', 'dual' "
                         f"or 'svd'; got {method!r}")

    PVh = None if Pstim is None else Pstim.to(torch.float32) @ Vh.T
    return RidgeSVD(U, S, Vh, good, PVh, keepX)


def _ur_product(svd: RidgeSVD, Rresp: torch.Tensor) -> torch.Tensor:
    """U^T Y: direct on the svd and dual paths; S^-1 V^T (X^T Y) on the
    eigh path."""
    Rresp = Rresp.to(torch.float32)
    if svd.U is not None:
        return svd.U.T @ Rresp
    with annotate("litcoder.fit.gram"):
        XtY = svd.X.T @ Rresp
    VtXtY = svd.Vh @ XtY
    inv_s = torch.where(svd.good, 1.0 / torch.where(svd.good, svd.S, 1.0),
                        0.0)
    return inv_s[:, None] * VtXtY


def _normalize_alphas(alphas, svd: RidgeSVD, normalpha: bool) -> torch.Tensor:
    """Alphas as float32 on the state's device, times S[0] under normalpha."""
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=svd.S.device)
    return alphas * svd.S[0] if normalpha else alphas


def _shrinkage_per_voxel(svd: RidgeSVD, nalphas: torch.Tensor) -> torch.Tensor:
    """(k, V) ridge diagonal S / (S^2 + a^2) for per-voxel alphas."""
    S = svd.S[:, None]
    return torch.where(svd.good[:, None],
                       S / (S**2 + nalphas[None, :] ** 2), 0.0)


def ridge_corr_from_svd(svd: RidgeSVD, Rresp: torch.Tensor,
                        Presp: torch.Tensor, nalphas: torch.Tensor,
                        use_corr: bool = True) -> torch.Tensor:
    """(A, Vc) scores of a pre-normalised alpha grid for one voxel chunk,
    from the fold's spectral state (PVh required)."""
    return score_alpha_grid(svd.S, svd.good, svd.PVh, _ur_product(svd, Rresp),
                            Presp, nalphas, use_corr=use_corr)


def score_alpha_grid(S: torch.Tensor, good: torch.Tensor, PVh: torch.Tensor,
                     UR: torch.Tensor, Presp: torch.Tensor,
                     nalphas: torch.Tensor, use_corr: bool = True,
                     fast_scan: bool = False) -> torch.Tensor:
    """(A, Vc) alpha-grid scores from spectral products: per alpha,
    pred_a = (PVh * D_a) @ UR scored against Presp (NaN -> 0), one
    prediction alive at a time. fast_scan runs the prediction products with
    TF32 on (the JAX package's default-precision MXU passes); the alpha
    argmax tolerates it, and the refit stays fp32."""
    Presp = Presp.to(torch.float32)
    zPresp = zscore(Presp, dim=0)
    nalphas = torch.as_tensor(nalphas, dtype=torch.float32, device=S.device)
    out = []
    for na in nalphas:
        D = torch.where(good, S / (S**2 + na**2), 0.0)
        with matmul_tf32(fast_scan):
            pred = (PVh * D[None, :]) @ UR
        out.append(_score_predictions(pred, Presp, zPresp, use_corr))
    return torch.stack(out)


def _score_predictions(pred: torch.Tensor, Presp: torch.Tensor,
                       zPresp: torch.Tensor, use_corr: bool) -> torch.Tensor:
    """Correlation (or signed R^2) of one alpha's predictions, NaN -> 0."""
    if use_corr:
        rcorr = torch.mean(zPresp * zscore(pred, dim=0), dim=0)
    else:
        rcorr = signed_square_corr(Presp, pred)
    return torch.nan_to_num(rcorr, nan=0.0, posinf=0.0, neginf=0.0)


def score_alpha_grid_woodbury(lam_u: torch.Tensor, P: torch.Tensor,
                              UR0: torch.Tensor, Presp: torch.Tensor,
                              nalphas: torch.Tensor, use_corr: bool = True,
                              fast_scan: bool = False,
                              alpha_batch: Optional[int] = None
                              ) -> torch.Tensor:
    """(A, Vc) alpha-grid scores of one fold without a per-fold eigensolve.

    With the union Gram G_u = Q diag(lam_u) Q^T, P = Xva Q (Tva, D) and
    UR0 = Q^T XtY_tr (D, Vc), the Woodbury identity for the fold's training
    Gram G_u - Xva^T Xva gives
        pred_a = (I - K_a)^-1 P diag(d_a) UR0,  d_a = 1 / (lam_u + a^2),
        K_a = P diag(d_a) P^T,
    so each alpha costs one (Tva, Tva) Cholesky and two triangular solves.
    I - K_a is positive definite for every a > 0; the caller gates on the
    grid (parallel/step._resolve_scan_method). `alpha_batch` alphas are
    factored, solved and predicted together as one (Ab Tva, D) @ (D, Vc)
    product (None: one at a time); the scores do not depend on it. Only
    that product joins `fast_scan` (TF32); K_a and the solves stay fp32.
    A factor that is not positive definite (torch raises where JAX returns
    NaN) is made NaN, so its alpha scores 0 as in the JAX package."""
    Presp = Presp.to(torch.float32)
    zPresp = zscore(Presp, dim=0)
    lam = torch.clamp(lam_u.to(torch.float32), min=0.0)
    t_va, d_dim = P.shape
    eye = torch.eye(t_va, dtype=torch.float32, device=P.device)
    nalphas = torch.as_tensor(nalphas, dtype=torch.float32, device=P.device)
    a_n = nalphas.shape[0]
    ab = 1 if alpha_batch is None else max(1, min(int(alpha_batch), a_n))
    out = []
    for lo in range(0, a_n, ab):
        nal_b = nalphas[lo:lo + ab]
        d = 1.0 / (lam[None, :] + (nal_b * nal_b)[:, None])  # (Ab, D)
        Pt = P[None, :, :] * d[:, None, :]                   # (Ab, Tva, D)
        L, info = torch.linalg.cholesky_ex(eye[None] - Pt @ P.T)
        L = torch.where((info > 0)[:, None, None], float("nan"), L)
        M = torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, Pt, upper=False),
            upper=True)                                      # (Ab, Tva, D)
        with matmul_tf32(fast_scan):
            pred = M.reshape(-1, d_dim) @ UR0                # (Ab Tva, Vc)
        for p in pred.reshape(-1, t_va, pred.shape[-1]):
            out.append(_score_predictions(p, Presp, zPresp, use_corr))
    return torch.stack(out)


def _lanczos_tridiagonal(matvec, v0: torch.Tensor, m: int):
    """(diag, off, fused) of m Lanczos steps from v0 with full
    reorthogonalisation: per step the operator's matvec, then
    ops.lanczos_step, the plain torch ops on the CPU and one kernel launch
    on CUDA; fused counts the steps the kernel ran."""
    n = v0.shape[0]
    dev = v0.device
    v = v0 / torch.clamp(torch.linalg.norm(v0), min=1e-30)
    diag = torch.zeros(m, dtype=torch.float32, device=dev)
    off = torch.zeros(m, dtype=torch.float32, device=dev)
    steps = lanczos_step.LanczosSteps(
        v, torch.zeros_like(v),
        torch.zeros((m, n), dtype=torch.float32, device=dev), diag, off,
        torch.zeros(2, dtype=torch.float32, device=dev))  # (b_prev, scale)
    for i in range(m):
        steps(matvec(steps.v), i)
    return diag, off, m if steps.fused else 0


def _lanczos_lmax(matvec, v0: torch.Tensor, m: int, bound: torch.Tensor,
                  counts: Optional[dict] = None) -> torch.Tensor:
    """Largest eigenvalue of a symmetric operator by m-step Lanczos with full
    reorthogonalisation. Deterministic (fixed start, fixed step count); m is
    clamped to the dimension, and after Krylov breakdown (beta ~ f32 noise)
    the remaining steps write zeros instead of normalising the noise.

    The f32 breakdown test can miss: on a rank-deficient matrix the spent
    Krylov space's residual may sit just above it, and normalising that
    noise feeds the three-term recurrence junk whose betas grow until the
    tridiagonal overflows (NaN) or its Ritz value leaves the spectrum.
    `bound` is an upper bound of the spectrum (Gershgorin). Wherever the
    whole tridiagonal's Ritz value is finite and within it, that value is
    the result; otherwise it is the largest Ritz value of the longest
    finite leading block that stays within the bound. Leading blocks'
    largest Ritz values never decrease with the block size (interlacing),
    so that block is the last one before the junk took over. `counts`
    (a span's) gets `steps`, the m run, `fallback`, 1 where that search of
    the leading blocks ran, and `fused`, the steps the kernel ran (m on
    CUDA, 0 on the CPU)."""
    n = v0.shape[0]
    m = min(m, n)
    diag, off, fused = _lanczos_tridiagonal(matvec, v0, m)
    if counts is not None:
        counts.update(steps=m, fallback=0, fused=fused)

    def ritz_max(k: int) -> torch.Tensor:
        tri = (torch.diag(diag[:k]) + torch.diag(off[:k - 1], 1)
               + torch.diag(off[:k - 1], -1))
        return torch.linalg.eigvalsh(tri)[-1]

    def in_range(theta: torch.Tensor) -> bool:
        return bool(torch.isfinite(theta) & (theta <= bound))

    lmax = ritz_max(m) if bool(torch.isfinite(diag).all()
                               & torch.isfinite(off).all()) else None
    if lmax is not None and in_range(lmax):
        return lmax
    if counts is not None:
        counts["fallback"] = 1
    finite = torch.isfinite(diag) & torch.isfinite(off)
    k = int(torch.cumprod(finite.to(torch.int32), 0).sum())
    # Row k may hold a finite diagonal whose beta overflowed: the block of
    # the first k rows uses only off[:k - 1].
    k = min(k + 1, m) if k < m and bool(torch.isfinite(diag[k])) else k
    for size in range(k, 0, -1):
        lmax = ritz_max(size)
        if in_range(lmax):
            return lmax
    return torch.clamp(diag[0], max=bound)


def _gershgorin_bound(G: torch.Tensor) -> torch.Tensor:
    """Upper bound of a symmetric matrix's spectrum, with a relative slack
    for f32 Ritz values of matrices that meet it (all-equal row sums)."""
    return torch.abs(G).sum(dim=1).max() * (1.0 + 1e-4)


def lmax_dense(G: torch.Tensor, m: int = 64) -> torch.Tensor:
    """Largest eigenvalue of a dense symmetric PSD matrix by Lanczos, cold
    started from one power step on the all-ones vector."""
    with annotate("litcoder.fit.lmax") as span:
        G = G.to(torch.float32)
        v0 = G @ torch.ones(G.shape[0], dtype=torch.float32, device=G.device)
        return _lanczos_lmax(lambda w: torch.mv(G, w), v0, m,
                             _gershgorin_bound(G), span.counts)


def _top_basis_vector(lam: torch.Tensor) -> torch.Tensor:
    """The basis vector of argmax(lam): the union Gram's top eigendirection
    in its own eigenbasis, the warm start of lmax_downdate/lmax_update (a
    fold's downdate or the remainder's update barely rotates it)."""
    v0 = torch.zeros_like(lam)
    v0[torch.argmax(lam)] = 1.0
    return v0


def lmax_downdate(lam_u: torch.Tensor, P: torch.Tensor,
                  m: int = 24) -> torch.Tensor:
    """Largest eigenvalue of diag(lam_u) - P^T P (a fold's training Gram in
    the union eigenbasis) by Lanczos: the fused step's per-fold `normalpha`
    scale. diag(lam_u) - P^T P <= diag(lam_u), so max(lam_u) bounds it."""
    with annotate("litcoder.fit.lmax") as span:
        lam = lam_u.to(torch.float32)
        return _lanczos_lmax(lambda w: lam * w - P.T @ (P @ w),
                             _top_basis_vector(lam), m,
                             torch.max(lam) * (1.0 + 1e-4), span.counts)


def lmax_update(lam_u: torch.Tensor, P: torch.Tensor,
                m: int = 24) -> torch.Tensor:
    """Largest eigenvalue of diag(lam_u) + P^T P (the full training Gram when
    P holds the rows outside the fold union in the union eigenbasis) by
    Lanczos: the union refit's `normalpha` scale, bounded by
    max(lam_u) + ||P||_F^2."""
    with annotate("litcoder.fit.lmax") as span:
        lam = lam_u.to(torch.float32)
        return _lanczos_lmax(lambda w: lam * w + P.T @ (P @ w),
                             _top_basis_vector(lam), m,
                             (torch.max(lam) + torch.sum(P * P))
                             * (1.0 + 1e-4), span.counts)


def ridge_fit_from_svd(svd: RidgeSVD, Rresp: torch.Tensor,
                       nalphas: torch.Tensor) -> torch.Tensor:
    """(D, V) weights for pre-normalised per-voxel alphas."""
    UR = _ur_product(svd, Rresp)
    D = _shrinkage_per_voxel(svd, nalphas.to(torch.float32))
    return svd.Vh.T @ (D * UR)


# --- one-call forms of the reference's ridge_regression.py -----------------


def ridge_fit(Rstim, Rresp, valphas, singcutoff: float = 1e-30,
              normalpha: bool = False, method: str = "svd") -> torch.Tensor:
    """(D, V) ridge weights for a scalar or per-voxel alphas (ridge_torch,
    encoding/models/ridge_regression.py:9-63)."""
    Rresp = torch.as_tensor(Rresp, dtype=torch.float32)
    svd = ridge_svd(torch.as_tensor(Rstim, device=Rresp.device), None,
                    singcutoff=singcutoff, method=method)
    valphas = torch.atleast_1d(torch.as_tensor(
        valphas, dtype=torch.float32, device=Rresp.device))
    if valphas.shape[0] == 1:
        valphas = valphas.expand(Rresp.shape[1])
    return ridge_fit_from_svd(svd, Rresp,
                              _normalize_alphas(valphas, svd, normalpha))


def ridge_corr(Rstim, Pstim, Rresp, Presp, alphas, singcutoff: float = 1e-30,
               use_corr: bool = True, normalpha: bool = False,
               method: str = "svd") -> torch.Tensor:
    """(A, V) alpha-grid scores (ridge_corr_torch,
    encoding/models/ridge_regression.py:66-141)."""
    svd = ridge_svd(torch.as_tensor(Rstim), torch.as_tensor(Pstim),
                    singcutoff=singcutoff, method=method)
    return ridge_corr_from_svd(svd, torch.as_tensor(Rresp),
                               torch.as_tensor(Presp),
                               _normalize_alphas(alphas, svd, normalpha),
                               use_corr=use_corr)


def ridge_corr_pred(Rstim, Pstim, Rresp, Presp, valphas,
                    singcutoff: float = 1e-30, use_corr: bool = True,
                    normalpha: bool = True, method: str = "svd"
                    ) -> torch.Tensor:
    """(V,) held-out scores with per-voxel alphas (ridge_corr_pred_torch,
    encoding/models/ridge_regression.py:144-216)."""
    svd = ridge_svd(torch.as_tensor(Rstim), torch.as_tensor(Pstim),
                    singcutoff=singcutoff, method=method)
    return _ridge_corr_pred_from_svd(
        svd, torch.as_tensor(Rresp, dtype=torch.float32),
        torch.as_tensor(Presp, dtype=torch.float32),
        _normalize_alphas(valphas, svd, normalpha), use_corr)


def _ridge_corr_pred_from_svd(svd: RidgeSVD, Rresp: torch.Tensor,
                              Presp: torch.Tensor, nalphas: torch.Tensor,
                              use_corr: bool = True) -> torch.Tensor:
    pred = svd.PVh @ (_shrinkage_per_voxel(svd, nalphas)
                      * _ur_product(svd, Rresp))  # (Tp, V)
    return _score_predictions(pred, Presp, zscore(Presp, dim=0), use_corr)


def predict(Pstim: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """X_test @ weights in float32."""
    return Pstim.to(torch.float32) @ wt.to(torch.float32)

"""Ridge regression core on tensors (twin of litcoder_core_tpu/models/ridge.py).

- `ridge_svd` factors the small side of the design: 'eigh' eigendecomposes
  the (D, D) Gram (U is never formed), 'dual' the (T, T) kernel; 'auto'
  picks eigh when T >= D. Both eigensolvers return ascending values, so
  the spectra are flipped to descending.
- `lmax_dense` gives the `normalpha` scale without an eigendecomposition:
  m-step Lanczos with full reorthogonalisation and the f32 breakdown test.
  The JAX fori_loop is a Python loop here; every step stays on the device.

All products are float32; the fit turns TF32 off at its entry, which
matches the JAX package's Precision.HIGHEST.
"""

from typing import NamedTuple, Optional

import torch

from litcoder_core_torch.ops.stats import zscore


class RidgeSVD(NamedTuple):
    """Spectral state of one design."""

    U: Optional[torch.Tensor]    # (T, k) left vectors, or None (eigh path)
    S: torch.Tensor              # (k,) singular values
    Vh: torch.Tensor             # (k, D) right vectors
    good: torch.Tensor           # (k,) bool mask: S > singcutoff
    PVh: Optional[torch.Tensor]  # (Tp, k) validation stimuli in that basis
    X: Optional[torch.Tensor]    # (T, D) training stimuli (U-free products)


def ridge_svd(Rstim: torch.Tensor, Pstim: Optional[torch.Tensor] = None,
              singcutoff: float = 1e-10, method: str = "auto") -> RidgeSVD:
    """Spectral stage: factor the training stimuli, project validation ones."""
    Rstim = Rstim.to(torch.float32)
    T, D = Rstim.shape
    if method == "auto":
        method = "eigh" if T >= D else "dual"

    if method == "dual":
        evals, evecs = torch.linalg.eigh(Rstim @ Rstim.T)  # ascending
        S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
        U = torch.flip(evecs, dims=[1])
        good = S > singcutoff
        inv_s = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
        Vh = inv_s[:, None] * (U.T @ Rstim)
        keepX = None
    elif method == "eigh":
        evals, evecs = torch.linalg.eigh(Rstim.T @ Rstim)  # ascending
        S = torch.sqrt(torch.clamp(torch.flip(evals, dims=[0]), min=0.0))
        Vh = torch.flip(evecs, dims=[1]).T
        good = S > singcutoff
        U = None
        keepX = Rstim
    else:
        raise NotImplementedError(
            f"ridge_svd method {method!r} is not ported to litcoder_core_torch "
            "yet (see ROADMAP.md, queue A); use 'auto', 'eigh' or 'dual'"
        )

    PVh = None if Pstim is None else Pstim.to(torch.float32) @ Vh.T
    return RidgeSVD(U, S, Vh, good, PVh, keepX)


def _ur_product(svd: RidgeSVD, Rresp: torch.Tensor) -> torch.Tensor:
    """U^T Y: direct on the dual path; S^-1 V^T (X^T Y) on the eigh path."""
    Rresp = Rresp.to(torch.float32)
    if svd.U is not None:
        return svd.U.T @ Rresp
    VtXtY = svd.Vh @ (svd.X.T @ Rresp)
    inv_s = torch.where(svd.good, 1.0 / torch.where(svd.good, svd.S, 1.0),
                        0.0)
    return inv_s[:, None] * VtXtY


def _shrinkage_per_voxel(svd: RidgeSVD, nalphas: torch.Tensor) -> torch.Tensor:
    """(k, V) ridge diagonal S / (S^2 + a^2) for per-voxel alphas."""
    S = svd.S[:, None]
    return torch.where(svd.good[:, None],
                       S / (S**2 + nalphas[None, :] ** 2), 0.0)


def _score_predictions(pred: torch.Tensor, Presp: torch.Tensor,
                       zPresp: torch.Tensor, Prespvar: torch.Tensor,
                       use_corr: bool) -> torch.Tensor:
    """Correlation (or signed R^2) of one alpha's predictions, NaN -> 0."""
    if use_corr:
        rcorr = torch.mean(zPresp * zscore(pred, dim=0), dim=0)
    else:
        resvar = torch.var(Presp - pred, dim=0, correction=1)
        rsq = 1.0 - resvar / Prespvar
        rcorr = torch.sqrt(torch.abs(rsq)) * torch.sign(rsq)
    return torch.nan_to_num(rcorr, nan=0.0, posinf=0.0, neginf=0.0)


def _lanczos_lmax(matvec, v0: torch.Tensor, m: int) -> torch.Tensor:
    """Largest eigenvalue of a symmetric operator by m-step Lanczos with full
    reorthogonalisation. Deterministic (fixed start, fixed step count); m is
    clamped to the dimension, and after Krylov breakdown (beta ~ f32 noise)
    the remaining steps write zeros instead of normalising the noise."""
    n = v0.shape[0]
    m = min(m, n)
    dev = v0.device
    v = v0 / torch.clamp(torch.linalg.norm(v0), min=1e-30)
    basis = torch.zeros((m, n), dtype=torch.float32, device=dev)
    diag = torch.zeros(m, dtype=torch.float32, device=dev)
    off = torch.zeros(m, dtype=torch.float32, device=dev)
    v_prev = torch.zeros_like(v)
    b_prev = torch.zeros((), dtype=torch.float32, device=dev)
    scale = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        w = matvec(v)
        a = torch.dot(w, v)
        w = w - a * v - b_prev * v_prev
        w = w - basis.T @ (basis @ w)
        b = torch.linalg.norm(w)
        scale = torch.maximum(scale, torch.abs(a))
        alive = b > 1e-6 * torch.clamp(scale, min=1.0)
        v_next = torch.where(alive, w / torch.clamp(b, min=1e-30), 0.0)
        b = torch.where(alive, b, 0.0)
        basis[i] = v
        diag[i] = a
        off[i] = b
        v_prev, v, b_prev = v, v_next, b
    tri = (torch.diag(diag) + torch.diag(off[:m - 1], 1)
           + torch.diag(off[:m - 1], -1))
    return torch.linalg.eigvalsh(tri)[-1]


def lmax_dense(G: torch.Tensor, m: int = 64) -> torch.Tensor:
    """Largest eigenvalue of a dense symmetric PSD matrix by Lanczos, cold
    started from one power step on the all-ones vector."""
    G = G.to(torch.float32)
    v0 = G @ torch.ones(G.shape[0], dtype=torch.float32, device=G.device)
    return _lanczos_lmax(lambda w: G @ w, v0, m)


def ridge_fit_from_svd(svd: RidgeSVD, Rresp: torch.Tensor,
                       nalphas: torch.Tensor) -> torch.Tensor:
    """(D, V) weights for pre-normalised per-voxel alphas."""
    UR = _ur_product(svd, Rresp)
    D = _shrinkage_per_voxel(svd, nalphas.to(torch.float32))
    return svd.Vh.T @ (D * UR)


def predict(Pstim: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """X_test @ weights in float32."""
    return Pstim.to(torch.float32) @ wt.to(torch.float32)

"""Plain banded ridge: a per-voxel (gamma, alpha) chosen by inner folds.

Written from its definition in float32, TF32 left to the caller. The
feature spaces (bands) are the column blocks of X of the given widths. A
gamma candidate gives each band a share of the variance: band b's columns
are scaled by sqrt(gamma_b). The candidates are the uniform shares first,
then n_gammas - 1 draws of Dirichlet(1, ..., 1) from
numpy.random.default_rng(seed), in float32. For each gamma the scaled
design goes through reference/ridge.py's search (per fold and alpha a
ridge solve, the validation score averaged over folds); each voxel takes
the (gamma, alpha) of its best mean score, first on ties in gamma-major
order; the refit on every training row at that pair gives the held-out
Pearson r.

The penalty's scale is the one the Cholesky routes define for normalpha:
the largest Ritz value of 64 Lanczos steps (full reorthogonalisation,
started from G 1) on the scaled training Gram G, here in float64, where
reference/ridge.py takes G's exact largest eigenvalue. The top of a
random design's spectrum is clustered, so after 64 steps the two differ
by up to 2.3e-5 relative on these Grams, which moves a refit's r by up to
3.7e-5, as far as TF32 moves it.
"""

from typing import List, Sequence

import numpy as np
import torch

from cardbench.reference import ridge


def sample_gammas(n_bands: int, n_gammas: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    draws = rng.dirichlet([1.0] * n_bands, size=max(n_gammas - 1, 0))
    uniform = np.full((1, n_bands), 1.0 / n_bands)
    out = np.vstack([uniform, draws]) if n_gammas > 1 else uniform
    return out.astype(np.float32)


def scales(widths: Sequence[int], gamma, device) -> torch.Tensor:
    """(sum widths,) sqrt(gamma_b) on band b's columns."""
    return torch.cat([torch.full((w,), float(np.sqrt(np.float32(g))),
                                 dtype=torch.float32, device=device)
                      for w, g in zip(widths, gamma)])


LANCZOS_STEPS = 64


def lanczos_top(M: torch.Tensor) -> torch.Tensor:
    """The largest Ritz value of LANCZOS_STEPS Lanczos steps on the
    symmetric M, each new vector orthogonalised twice against all before
    it, started from M 1; float64."""
    A = M.double()
    n = A.shape[0]
    m = min(LANCZOS_STEPS, n)
    v = A @ torch.ones(n, dtype=A.dtype, device=A.device)
    v = v / v.norm()
    basis, diag, off = [], [], []
    for i in range(m):
        basis.append(v)
        w = A @ v
        diag.append(v @ w)
        Q = torch.stack(basis)
        for _ in range(2):                 # twice is enough (Kahan)
            w = w - Q.T @ (Q @ w)
        b = w.norm()
        if i == m - 1 or b == 0:
            break
        off.append(b)
        v = w / b
    k = len(diag)
    tri = torch.diag(torch.stack(diag))
    if k > 1:
        o = torch.stack(off[:k - 1])
        tri = tri + torch.diag(o, 1) + torch.diag(o, -1)
    return torch.linalg.eigvalsh(tri)[-1]


class LanczosRidge(ridge.RidgeOperator):
    """reference/ridge.py's operator on a tall design, its penalty scaled
    by lanczos_top of the training Gram."""

    def __init__(self, Xtr: torch.Tensor, Xp: torch.Tensor):
        self.Xtr = Xtr
        self.tall = True
        self.M = Xtr.T @ Xtr
        self.rhs = Xp.T
        self.scale2 = lanczos_top(self.M).float().clamp(min=0.0)


def search_scores(X: torch.Tensor, Y: torch.Tensor, widths: List[int],
                  gammas: np.ndarray, folds, alphas, block: int
                  ) -> torch.Tensor:
    """(G, A, V) validation scores averaged over the folds."""
    dev = X.device
    total = torch.zeros((len(gammas), len(alphas), Y.shape[1]),
                        dtype=torch.float32, device=dev)
    for train, val in folds:
        tr = torch.as_tensor(train, device=dev)
        va = torch.as_tensor(val, device=dev)
        for gi, g in enumerate(gammas):
            s = scales(widths, g, dev)[None]
            op_of = LanczosRidge(X[tr] * s, X[va] * s)
            ops = [op_of.op(a) for a in alphas]
            for lo in range(0, Y.shape[1], block):
                Yb = Y[:, lo:lo + block]
                side = op_of.side(Yb[tr])
                for ai, op in enumerate(ops):
                    total[gi, ai, lo:lo + block] += ridge.validation_score(
                        op @ side, Yb[va])
            del op_of, ops
    return total / len(folds)


def best_pairs(scores: torch.Tensor):
    """(gamma index (V,), alpha index (V,)) of each voxel's best score."""
    G, A, V = scores.shape
    flat = torch.argmax(scores.reshape(G * A, V), dim=0).cpu().numpy()
    return flat // A, flat % A


def refit_r(X, Y, Xte, Yte, widths, gammas, g_idx, a_idx, alphas,
            block: int) -> torch.Tensor:
    """(V,) held-out r of each voxel's refit at its (gamma, alpha)."""
    r = torch.zeros(Y.shape[1], dtype=torch.float32, device=X.device)
    alphas = np.asarray(alphas, np.float32)
    for g in np.unique(g_idx):
        s = scales(widths, gammas[g], X.device)[None]
        op_of = LanczosRidge(X * s, Xte * s)
        for a in np.unique(a_idx[g_idx == g]):
            op = op_of.op(float(alphas[a]))
            cols = np.nonzero((g_idx == g) & (a_idx == a))[0]
            for lo in range(0, cols.size, block):
                idx = torch.as_tensor(cols[lo:lo + block], device=X.device)
                pred = op @ op_of.side(Y[:, idx])
                r[idx] = ridge.pearson_r(Yte[:, idx], pred)
    return r

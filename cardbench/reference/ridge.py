"""Plain ridge regression with a per-voxel alpha chosen by inner folds.

Written from the textbook formulas in float32, TF32 left to the caller (the
benchmark runs it with TF32 off; its control runs it with TF32 on). For
training rows Xtr, responses Ytr and a penalty lam = (alpha * s)^2, where
s^2 is the largest eigenvalue of Xtr^T Xtr (`normalpha`), the prediction
of rows Xva is
    tall (rows >= columns): Xva (Xtr^T Xtr + lam I)^-1 Xtr^T Ytr
    wide (rows <  columns): Xva Xtr^T (Xtr Xtr^T + lam I)^-1 Ytr
(the same matrix either way; the smaller system is solved, by LU). A
validation score is the mean over rows of the product of the z-scored
prediction and the z-scored response (ddof 1, eps 1e-8; NaN -> 0), and a
held-out score is the Pearson r. Voxels are taken in column blocks so the
whole-brain problem fits beside its responses.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Fold = Tuple[np.ndarray, np.ndarray]


def _zs(x: torch.Tensor) -> torch.Tensor:
    return (x - x.mean(0)) / (x.std(0, correction=1) + 1e-8)


def validation_score(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num((_zs(y) * _zs(pred)).mean(0), nan=0.0,
                            posinf=0.0, neginf=0.0)


def pearson_r(y: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    yc = y - y.mean(0)
    pc = pred - pred.mean(0)
    r = (yc * pc).sum(0) / torch.sqrt((yc * yc).sum(0) * (pc * pc).sum(0))
    return torch.nan_to_num(r, nan=0.0, posinf=0.0, neginf=0.0)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


class RidgeOperator:
    """Predictions of the rows `Xp` from training rows `Xtr` at penalties
    lams: pred_a = op(a) @ side(Ytr), with side(Ytr) = Xtr^T Ytr (tall) or
    Ytr (wide)."""

    def __init__(self, Xtr: torch.Tensor, Xp: torch.Tensor):
        self.Xtr = Xtr
        self.tall = Xtr.shape[0] >= Xtr.shape[1]
        if self.tall:
            self.M = Xtr.T @ Xtr
            self.rhs = Xp.T                       # (D, Tp)
        else:
            self.M = Xtr @ Xtr.T
            self.rhs = Xtr @ Xp.T                 # (Ttr, Tp)
        self.scale2 = torch.linalg.eigvalsh(self.M)[-1].clamp(min=0.0)

    def op(self, alpha: float) -> torch.Tensor:
        """(Tp, side rows) for the normalised alpha."""
        lam = float(alpha) ** 2 * self.scale2
        A = self.M + lam * _eye(self.M.shape[0], self.M)
        return torch.linalg.solve(A, self.rhs).T

    def side(self, Ytr: torch.Tensor) -> torch.Tensor:
        return self.Xtr.T @ Ytr if self.tall else Ytr


def _blocks(n: int, block: int):
    return [(lo, min(lo + block, n)) for lo in range(0, n, block)]


def search_scores(X: torch.Tensor, Y: torch.Tensor, folds: List[Fold],
                  alphas: Sequence[float], block: int) -> torch.Tensor:
    """(A, V) validation scores averaged over the folds."""
    dev = X.device
    total = torch.zeros((len(alphas), Y.shape[1]), dtype=torch.float32,
                        device=dev)
    for train, val in folds:
        tr = torch.as_tensor(train, device=dev)
        va = torch.as_tensor(val, device=dev)
        ridge = RidgeOperator(X[tr], X[va])
        ops = [ridge.op(a) for a in alphas]
        for lo, hi in _blocks(Y.shape[1], block):
            Yb = Y[:, lo:hi]
            side = ridge.side(Yb[tr])
            Yva = Yb[va]
            for i, op in enumerate(ops):
                total[i, lo:hi] += validation_score(op @ side, Yva)
        del ridge, ops
    return total / len(folds)


def circular_offsets(seed: int, n_permutations: int,
                     n_samples: int) -> torch.Tensor:
    """The permutation test's shifts, drawn as the fit defines them: a CPU
    torch.Generator seeded with numpy's SeedSequence([seed]) state, then
    n_permutations offsets uniform on [1, n_samples)."""
    state = np.random.SeedSequence([seed]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    return torch.randint(1, n_samples, (n_permutations,), generator=gen)


def exceedances(y: torch.Tensor, pred: torch.Tensor, offsets: torch.Tensor,
                block: int = 64) -> torch.Tensor:
    """(V,) how many of the circular shifts k of the prediction (rows t - k)
    correlate with y at least as much as the prediction itself (float64)."""
    T = y.shape[0]
    rows = (torch.arange(T, device=y.device)[None, :]
            - offsets.to(y.device)[:, None]) % T          # (n, T)
    out = []
    for lo, hi in _blocks(y.shape[1], block):
        yc = y[:, lo:hi].double() - y[:, lo:hi].double().mean(0)
        pc = pred[:, lo:hi].double() - pred[:, lo:hi].double().mean(0)
        den = torch.sqrt((yc * yc).sum(0) * (pc * pc).sum(0))
        obs = (yc * pc).sum(0) / den
        null = torch.einsum("tv,ntv->nv", yc, pc[rows]) / den
        out.append((torch.nan_to_num(null, nan=0.0) >= obs).sum(0))
    return torch.cat(out)


def refit_r(X: torch.Tensor, Y: torch.Tensor, Xte: torch.Tensor,
            Yte: torch.Tensor, voxel_alphas: np.ndarray, block: int,
            offsets: Optional[torch.Tensor] = None):
    """(V,) held-out Pearson r of the refit on all training rows, each voxel
    at its own alpha; with circular-shift `offsets`, (r, one-sided
    permutation p-values (1 + exceedances) / (n + 1))."""
    ridge = RidgeOperator(X, Xte)
    r = torch.zeros(Y.shape[1], dtype=torch.float32, device=X.device)
    hits = torch.zeros(Y.shape[1], dtype=torch.int64, device=X.device)
    voxel_alphas = np.asarray(voxel_alphas, np.float32)
    for a in np.unique(voxel_alphas):
        op = ridge.op(float(a))
        cols = np.nonzero(voxel_alphas == a)[0]
        for lo, hi in _blocks(cols.size, block):
            idx = torch.as_tensor(cols[lo:hi], device=X.device)
            pred = op @ ridge.side(Y[:, idx])
            r[idx] = pearson_r(Yte[:, idx], pred)
            if offsets is not None:
                hits[idx] = exceedances(Yte[:, idx], pred, offsets)
    if offsets is None:
        return r
    p = (1.0 + hits.double()) / (offsets.numel() + 1.0)
    return r, p


def best_alphas(scores: torch.Tensor, alphas: Sequence[float],
                single_alpha: bool) -> np.ndarray:
    """Per-voxel argmax (or the argmax of the voxel mean), first on ties."""
    a = np.asarray(alphas, np.float32)
    if single_alpha:
        return np.full(scores.shape[1], a[int(torch.argmax(scores.mean(1)))],
                       np.float32)
    return a[torch.argmax(scores, dim=0).cpu().numpy()]


def full_cv(X, Y, outer: List[Fold], inner_of, alphas, block: int,
            single_alpha: bool):
    """Per outer fold (train, test): inner folds `inner_of(n_train)` on its
    training rows, the search, the refit and the test r. Returns
    (mean alphas (V,), r per fold (k, V) on the host, test sizes)."""
    chosen_all, r_all, sizes = [], [], []
    for train, test in outer:
        tr = torch.as_tensor(train, device=X.device)
        te = torch.as_tensor(test, device=X.device)
        Xtr, Ytr = X[tr], Y[tr]
        scores = search_scores(Xtr, Ytr, inner_of(len(train)), alphas, block)
        chosen = best_alphas(scores, alphas, single_alpha)
        del scores
        r_all.append(refit_r(Xtr, Ytr, X[te], Y[te], chosen, block)
                     .cpu().numpy())
        chosen_all.append(chosen)
        sizes.append(len(test))
        del Xtr, Ytr
    return np.mean(chosen_all, axis=0), np.stack(r_all), sizes

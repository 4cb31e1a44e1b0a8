"""Linear predictivity model (twin of litcoder_core_tpu/models/linear.py;
reference encoding/models/linear.py:11-163).

The same API (config dict, fit/predict/save/load, GroupKFold folds, the
best fold's model kept) and the same metrics. Each fold's solve is a
minimum-norm least-squares fit on `device` (config key 'device', 'cuda' by
default; without a card it raises): the thin SVD of the centred design,
singular values under eps(float32) * max(T, D) * s_max dropped, as
jnp.linalg.lstsq solves it (cuSOLVER's gesvd on the card).
torch.linalg.lstsq is not used: on CUDA it has only the QR driver, which
assumes full rank. Products run in fp32 with TF32 off (the JAX package's
Precision.HIGHEST). The folds are models.folding.group_kfold_splits,
scikit-learn's GroupKFold assignment, so scikit-learn is not needed. Like
the reference, this is a `fit` model; the trainers do not use it.
"""

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.folding import group_kfold_splits
from litcoder_core_torch.ops.stats import pearson_r
from litcoder_core_torch.utils.device import (
    as_f32,
    matmul_tf32,
    resolve_device,
    to_numpy,
)

logger = logging.getLogger(__name__)


def _lstsq_fit(X: torch.Tensor, y: torch.Tensor):
    """Least squares with intercept on X's device: (coef (D, V), intercept
    (V,)), the minimum-norm solution for a rank-deficient design."""
    with matmul_tf32(False):
        x_mean = X.mean(dim=0, keepdim=True)
        y_mean = y.mean(dim=0, keepdim=True)
        Xc = X - x_mean
        # On the card: cuSOLVER's gesvd (Householder bidiagonalization),
        # not torch's default iterative Jacobi gesvdj, whose float32 stopping
        # tolerance loosens the singular values the cutoff reads.
        driver = "gesvd" if Xc.is_cuda else None
        u, s, vh = torch.linalg.svd(Xc, full_matrices=False, driver=driver)
        rcond = torch.finfo(torch.float32).eps * max(Xc.shape)
        keep = (s > 0) & (s >= rcond * s[0])
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        coef = vh.T @ (s_inv[:, None] * (u.T @ (y - y_mean)))
        intercept = (y_mean - x_mean @ coef).squeeze(0)
    return coef, intercept


class LinearPredictivityModel(BasePredictivityModel):
    """Linear regression under GroupKFold with best-fold retention."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config.get("model_name", "linear"))
        self.config = config
        self.n_folds = config.get("n_folds", 1)
        self.output_dir = config.get("output_dir")
        self.device = config.get("device", "cuda")
        self.best_model = None  # (coef, intercept)
        self.best_score = -np.inf
        self.scores = []
        self.models = []

    def fit_predict(self, features, targets, groups=None, **kwargs):
        """BasePredictivityModel interface: delegates to fit()."""
        return self.fit(features, targets, groups=groups, **kwargs)

    def fit(self, features, targets, groups: Optional[np.ndarray] = None,
            **kwargs) -> Dict[str, Any]:
        """Features and targets are numpy arrays or tensors; both go to
        the device once and each fold gathers its rows there."""
        dev = resolve_device(self.device)
        if groups is None:
            groups = np.zeros(len(features))
        n_splits = max(self.n_folds, 1)
        if n_splits < 2 or len(np.unique(groups)) < n_splits:
            # GroupKFold needs n_splits >= 2 and >= n_splits groups;
            # degenerate cases (n_folds=1, single group) -> fit on everything
            # and score in-sample (reference behavior with dummy groups).
            splits = [(np.arange(len(features)), np.arange(len(features)))]
        else:
            splits = group_kfold_splits(groups, n_splits)

        X = as_f32(features, dev)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        Y = as_f32(targets, dev)
        for fold_idx, (train_idx, test_idx) in enumerate(splits):
            tr = torch.as_tensor(np.asarray(train_idx), device=dev)
            te = torch.as_tensor(np.asarray(test_idx), device=dev)
            coef, intercept = _lstsq_fit(X[tr], Y[tr])
            with matmul_tf32(False):
                preds = X[te] @ coef + intercept
            fold_scores = to_numpy(pearson_r(Y[te], preds))
            del preds
            median_score = float(np.median(fold_scores))
            logger.info("Fold %d/%d - Median score: %.3f", fold_idx + 1,
                        len(splits), median_score)

            self.scores.append(fold_scores.tolist())
            self.models.append((to_numpy(coef), to_numpy(intercept)))
            if median_score > self.best_score:
                self.best_score = median_score
                self.best_model = self.models[-1]

        final_scores = np.array(self.scores).mean(axis=0)
        return {
            "median_score": float(np.median(final_scores)),
            "mean_score": float(np.mean(final_scores)),
            "std_score": float(np.std(final_scores)),
            "correlations": final_scores.tolist(),
        }

    def predict(self, features: np.ndarray) -> np.ndarray:
        """Host numpy prediction with the best fold's model."""
        if self.best_model is None:
            raise ValueError("Model has not been fitted yet")
        features = np.asarray(features)
        if features.ndim == 1:
            features = features.reshape(-1, 1)
        coef, intercept = self.best_model
        return features @ coef + intercept

    def save(self, path: Path) -> None:
        if self.best_model is None:
            raise ValueError("No model to save")
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        coef, intercept = self.best_model
        # Reference stores sklearn's (V, D) coef_ layout (linear.py:138).
        np.save(path / "best_model_coefficients.npy", coef.T)
        np.save(path / "best_model_intercept.npy", intercept)

    def load(self, path: Path) -> None:
        path = Path(path)
        coef_path = path / "best_model_coefficients.npy"
        if not coef_path.exists():
            raise FileNotFoundError(f"No model found at {coef_path}")
        coef = np.load(coef_path).T
        intercept_path = path / "best_model_intercept.npy"
        intercept = (np.load(intercept_path) if intercept_path.exists()
                     else np.zeros(coef.shape[1]))
        self.best_model = (coef, intercept)

"""Train-statistics z-scoring (twin of litcoder_core_tpu/models/normalizer.py).

Means and standard deviations come from the training split, with ddof=1
(`correction=1`) and 1e-8 added to the std, and are applied unchanged to
the held-out split.
"""

from typing import Optional, Tuple

import torch


def fit_normalizer_stats(X_train: torch.Tensor, y_train: torch.Tensor,
                         normalize_features: bool = True,
                         normalize_targets: bool = True):
    """(feature_mean, feature_std, target_mean, target_std) of the training
    split, each (1, n); None for an axis that is not normalized."""
    f_mean = f_std = t_mean = t_std = None
    if normalize_features:
        X_train = X_train.to(torch.float32)
        f_mean = torch.mean(X_train, dim=0, keepdim=True)
        f_std = torch.std(X_train, dim=0, keepdim=True, correction=1)
    if normalize_targets:
        y_train = y_train.to(torch.float32)
        t_mean = torch.mean(y_train, dim=0, keepdim=True)
        t_std = torch.std(y_train, dim=0, keepdim=True, correction=1)
    return f_mean, f_std, t_mean, t_std


def apply_normalizer_stats(X: torch.Tensor, y: torch.Tensor, stats,
                           eps: float = 1e-8):
    """Apply precomputed stats to (X, y); identity on axes with None stats."""
    f_mean, f_std, t_mean, t_std = stats
    if f_mean is not None:
        X = (X.to(torch.float32) - f_mean) / (f_std + eps)
    if t_mean is not None:
        y = (y.to(torch.float32) - t_mean) / (t_std + eps)
    return X, y


class DataNormalizer:
    """fit/transform/fit_transform over the functions above."""

    def __init__(self, normalize_features: bool = True,
                 normalize_targets: bool = True, eps: float = 1e-8):
        self.normalize_features = normalize_features
        self.normalize_targets = normalize_targets
        self.eps = eps
        self._stats: Optional[Tuple] = None

    def fit(self, X_train: torch.Tensor,
            y_train: torch.Tensor) -> "DataNormalizer":
        self._stats = fit_normalizer_stats(
            X_train, y_train, self.normalize_features, self.normalize_targets)
        return self

    def transform(self, X: torch.Tensor, y: torch.Tensor):
        if self._stats is None:
            raise ValueError("Must call fit() before transform()")
        return apply_normalizer_stats(X, y, self._stats, self.eps)

    def fit_transform(self, X: torch.Tensor, y: torch.Tensor):
        return self.fit(X, y).transform(X, y)

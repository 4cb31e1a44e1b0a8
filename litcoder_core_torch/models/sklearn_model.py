"""Generic scikit-learn estimator wrapper (twin of
litcoder_core_tpu/models/sklearn_model.py; reference
encoding/models/sklearn_model.py:13-297).

Host-side by design: the estimators (linear, ridge, lasso) and
GridSearchCV tuning stay scikit-learn's on the host; the voxelwise Pearson
r of each fold runs on `device` (config key 'device', 'cuda' by default;
without a card it raises). scikit-learn is imported when the model is
built, not with the package: without it the constructor raises
ImportError.
"""

import logging
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.ops.stats import pearson_r
from litcoder_core_torch.utils.device import as_f32, resolve_device, to_numpy

logger = logging.getLogger(__name__)


def _sklearn():
    """The scikit-learn names the wrapper uses, imported on first use."""
    try:
        from sklearn import linear_model, model_selection
    except ImportError as e:
        raise ImportError(
            "SklearnPredictivityModel needs scikit-learn, which is not "
            "installed"
        ) from e
    return linear_model, model_selection


class SklearnPredictivityModel(BasePredictivityModel):
    """Any sklearn regressor under Group/KFold CV with optional tuning."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config.get("model_name", "sklearn"))
        self._linear_model, self._model_selection = _sklearn()
        self.config = config
        self.model_type = config.get("model_type", "linear")
        self.model_kwargs = config.get("model_kwargs", {})
        self.estimator = self._get_estimator()
        self.n_folds = config.get("n_folds", 5)
        self.use_groups = config.get("use_groups", True)
        self.param_grid = config.get("param_grid", None)
        self.inner_cv = config.get("inner_cv", 3)
        self.scoring = config.get("scoring", "r2")
        self.output_dir = config.get("output_dir", None)
        self.device = config.get("device", "cuda")
        self.best_model = None
        self.best_score = -np.inf
        self.models = []
        self.scores = []
        self.feature_importances_ = None

    def _get_estimator(self):
        lm = self._linear_model
        model_map = {"linear": lm.LinearRegression, "ridge": lm.Ridge,
                     "lasso": lm.Lasso}
        if self.model_type not in model_map:
            raise ValueError(f"Unsupported model type: {self.model_type}")
        return model_map[self.model_type](**self.model_kwargs)

    def fit_predict(self, features, targets, groups=None, **kwargs):
        """BasePredictivityModel interface: delegates to fit()."""
        return self.fit(features, targets, groups=groups, **kwargs)

    def fit(self, features: np.ndarray, targets: np.ndarray,
            groups: Optional[np.ndarray] = None, **kwargs) -> Dict[str, Any]:
        dev = resolve_device(self.device)
        ms = self._model_selection
        use_groups = self.use_groups and groups is not None
        if use_groups:
            cv = ms.GroupKFold(n_splits=self.n_folds)
            fold_split = cv.split(features, targets, groups=groups)
        else:
            if self.use_groups and groups is None:
                warnings.warn(
                    "Group-based CV requested but no groups provided; "
                    "falling back to shuffled KFold."
                )
            cv = ms.KFold(n_splits=self.n_folds, shuffle=True,
                          random_state=42)
            fold_split = cv.split(features, targets)

        fold_scores, fold_models = [], []
        best_model, best_score = None, -np.inf

        for fold_idx, (train_idx, test_idx) in enumerate(fold_split):
            X_train = np.asarray(features)[train_idx]
            X_test = np.asarray(features)[test_idx]
            if X_train.ndim == 1:
                X_train = X_train.reshape(-1, 1)
            if X_test.ndim == 1:
                X_test = X_test.reshape(-1, 1)
            y_train = np.asarray(targets)[train_idx]
            y_test = np.asarray(targets)[test_idx]

            if self.param_grid is not None:
                logger.info("Fold %d/%d: hyperparameter tuning...",
                            fold_idx + 1, self.n_folds)
                grid = ms.GridSearchCV(self._get_estimator(),
                                       param_grid=self.param_grid,
                                       cv=self.inner_cv, scoring=self.scoring)
                grid.fit(X_train, y_train)
                model = grid.best_estimator_
                logger.info("Best parameters: %s", grid.best_params_)
            else:
                model = self._get_estimator()
                model.fit(X_train, y_train)

            y_pred = model.predict(X_test)
            corr = to_numpy(pearson_r(as_f32(y_test, dev),
                                      as_f32(y_pred, dev)))
            correlations = corr[~np.isnan(corr)].tolist()
            median_corr = float(np.median(correlations))
            logger.info("Fold %d/%d - Median correlation: %.3f",
                        fold_idx + 1, self.n_folds, median_corr)
            fold_scores.append(correlations)
            fold_models.append(model)
            if median_corr > best_score:
                best_score, best_model = median_corr, model

        self.scores = fold_scores
        self.models = fold_models
        self.best_model = best_model
        self.best_score = best_score
        if hasattr(best_model, "coef_"):
            self.feature_importances_ = best_model.coef_
        if self.output_dir is not None:
            self.save(Path(self.output_dir))

        all_correlations = np.concatenate(fold_scores)
        metrics: Dict[str, Any] = {
            "median_score": float(np.median(all_correlations)),
            "mean_score": float(np.mean(all_correlations)),
            "std_score": float(np.std(all_correlations)),
            "min_score": float(np.min(all_correlations)),
            "max_score": float(np.max(all_correlations)),
            "best_fold_score": float(best_score),
            "correlations": all_correlations.tolist(),
        }
        if self.best_model is not None and hasattr(self.best_model,
                                                   "get_params"):
            best_params = self.best_model.get_params()
            metrics["best_model_params"] = {
                k: float(v) if isinstance(v, (int, float)) else v
                for k, v in best_params.items()
            }
            if "alpha" in best_params:
                metrics["alpha"] = float(best_params["alpha"])
        return metrics

    def predict(self, features: np.ndarray) -> np.ndarray:
        if self.best_model is None:
            raise ValueError("Model has not been fitted yet")
        features = np.asarray(features)
        if features.ndim == 1:
            features = features.reshape(-1, 1)
        return self.best_model.predict(features)

    def save(self, path: Path) -> None:
        if self.best_model is None:
            raise ValueError("No model to save")
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "model_info.npy", {
            "model_type": self.model_type,
            "model_kwargs": self.model_kwargs,
            "best_score": self.best_score,
        })
        if hasattr(self.best_model, "coef_"):
            np.save(path / "best_model_coefficients.npy",
                    self.best_model.coef_)
        if hasattr(self.best_model, "intercept_"):
            np.save(path / "best_model_intercept.npy",
                    self.best_model.intercept_)

    def load(self, path: Path) -> None:
        path = Path(path)
        info_path = path / "model_info.npy"
        if not info_path.exists():
            raise FileNotFoundError(f"No model info found at {info_path}")
        info = np.load(info_path, allow_pickle=True).item()
        self.model_type = info["model_type"]
        self.model_kwargs = info["model_kwargs"]
        self.best_score = info["best_score"]
        self.best_model = self._get_estimator()
        coef_path = path / "best_model_coefficients.npy"
        if coef_path.exists():
            self.best_model.coef_ = np.load(coef_path)
            self.feature_importances_ = self.best_model.coef_
        intercept_path = path / "best_model_intercept.npy"
        if intercept_path.exists():
            self.best_model.intercept_ = np.load(intercept_path)

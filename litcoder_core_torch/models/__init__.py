"""Encoding models of the port: nested-CV ridge (train/test and full-CV
modes, every alpha-search path), banded ridge, stacked regression and
variance partitioning over feature spaces, the reference-API ridge
wrappers, the train-statistics normalizer, and the least-squares and
scikit-learn models (scikit-learn is imported only when the latter is
built)."""

from litcoder_core_torch.models.banded import (
    BandedRidgeModel,
    fit_banded_ridge,
)
from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.linear import LinearPredictivityModel
from litcoder_core_torch.models.nested_cv import NestedCVModel, fit_nested_cv
from litcoder_core_torch.models.normalizer import DataNormalizer
from litcoder_core_torch.models.ridge import (
    ridge_corr,
    ridge_corr_pred,
    ridge_fit,
    svd_masked,
)
from litcoder_core_torch.models.sklearn_model import SklearnPredictivityModel
from litcoder_core_torch.models.stacking import (
    StackedRidgeModel,
    fit_stacked_ridge,
)
from litcoder_core_torch.models.variance_partition import (
    variance_partitioning,
)

__all__ = ["BandedRidgeModel", "BasePredictivityModel", "DataNormalizer",
           "LinearPredictivityModel", "NestedCVModel",
           "SklearnPredictivityModel", "StackedRidgeModel", "create_folds",
           "fit_banded_ridge", "fit_nested_cv", "fit_stacked_ridge",
           "ridge_corr", "ridge_corr_pred", "ridge_fit", "svd_masked",
           "variance_partitioning"]

"""Encoding models of the port: nested-CV ridge (train/test and full-CV
modes, every alpha-search path), the reference-API ridge wrappers and the
train-statistics normalizer."""

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.models.nested_cv import NestedCVModel, fit_nested_cv
from litcoder_core_torch.models.normalizer import DataNormalizer
from litcoder_core_torch.models.ridge import (
    ridge_corr,
    ridge_corr_pred,
    ridge_fit,
    svd_masked,
)

__all__ = ["BasePredictivityModel", "DataNormalizer", "NestedCVModel",
           "create_folds", "fit_nested_cv", "ridge_corr", "ridge_corr_pred",
           "ridge_fit", "svd_masked"]

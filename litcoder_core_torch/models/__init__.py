"""Encoding models of the port: nested-CV ridge (train/test and full-CV
modes) and the train-statistics normalizer."""

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.nested_cv import NestedCVModel, fit_nested_cv
from litcoder_core_torch.models.normalizer import DataNormalizer

__all__ = ["BasePredictivityModel", "DataNormalizer", "NestedCVModel",
           "fit_nested_cv"]

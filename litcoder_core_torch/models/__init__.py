"""Encoding models of the port: nested-CV ridge (train/test mode)."""

from litcoder_core_torch.models.base import BasePredictivityModel
from litcoder_core_torch.models.nested_cv import NestedCVModel, fit_nested_cv

__all__ = ["BasePredictivityModel", "NestedCVModel", "fit_nested_cv"]

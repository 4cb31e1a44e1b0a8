"""Abstract base for predictivity models (twin of
litcoder_core_tpu/models/base.py; reference encoding/models/base.py)."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np


class BasePredictivityModel(ABC):
    """Interface contract: fit_predict(features, targets, ...) -> metrics."""

    def __init__(self, model_name: str):
        self.model_name = model_name

    @abstractmethod
    def fit_predict(
        self,
        features: np.ndarray,
        targets: np.ndarray,
        groups: Optional[np.ndarray] = None,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """Fit on features/targets and return an evaluation-metrics dict."""
        raise NotImplementedError

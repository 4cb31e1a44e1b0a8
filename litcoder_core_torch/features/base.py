"""Feature-extractor ABC (twin of litcoder_core_tpu/features/base.py)."""

from abc import ABC, abstractmethod
from typing import Any, Dict

import numpy as np


class BaseFeatureExtractor(ABC):
    """Interface: extract_features(stimuli, **kwargs) -> np.ndarray."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self._validate_config()

    @abstractmethod
    def extract_features(self, stimuli: Any, **kwargs) -> np.ndarray:
        """Extract features from stimuli."""
        raise NotImplementedError

    def _validate_config(self) -> None:
        """Subclasses override to validate their config dict."""

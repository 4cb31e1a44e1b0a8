"""Wordrate passthrough extractor (twin of
litcoder_core_tpu/features/simple_features.py)."""

from typing import Any, Dict

import numpy as np

from litcoder_core_torch.features.base import BaseFeatureExtractor


class WordRateFeatureExtractor(BaseFeatureExtractor):
    """Reshapes assembly-precomputed word rates to (n_TRs, 1); they are
    already TR-binned, so the trainer does not downsample them."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)

    def extract_features(self, stimuli: Any, **kwargs) -> np.ndarray:
        if isinstance(stimuli, list):
            stimuli = np.array(stimuli)
        if stimuli.ndim == 1:
            stimuli = stimuli.reshape(-1, 1)
        elif not (stimuli.ndim == 2 and stimuli.shape[1] == 1):
            raise ValueError(f"Unexpected stimuli shape: {stimuli.shape}")
        return stimuli

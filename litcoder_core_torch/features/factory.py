"""Feature-extractor factory (twin of litcoder_core_tpu/features/factory.py),
for the wordrate and embeddings modalities. The language-model and speech
extractors are queued in ROADMAP.md."""

from typing import Any, Dict

import numpy as np

from litcoder_core_torch.features.base import BaseFeatureExtractor
from litcoder_core_torch.features.embeddings import (
    StaticEmbeddingFeatureExtractor,
)
from litcoder_core_torch.features.simple_features import (
    WordRateFeatureExtractor,
)

_NOT_PORTED = ("language_model", "speech")


class FeatureExtractorFactory:
    """Creates extractors and dispatches per-story extraction."""

    _extractors = {
        "wordrate": WordRateFeatureExtractor,
        "embeddings": StaticEmbeddingFeatureExtractor,
    }

    @classmethod
    def create_extractor(cls, modality: str, model_name: str,
                         config: Dict[str, Any],
                         cache_dir: str = "cache") -> BaseFeatureExtractor:
        """Create an extractor; `cache_dir` is kept for API parity (these
        modalities keep no activation cache)."""
        del cache_dir
        if modality in _NOT_PORTED:
            raise NotImplementedError(
                f"modality {modality!r} is not ported to litcoder_core_torch "
                "yet (see ROADMAP.md, queue A)"
            )
        if modality not in cls._extractors:
            raise ValueError(
                f"Unsupported modality '{modality}'. "
                f"Supported modalities: {list(cls._extractors.keys())}"
            )
        if "model_name" not in config:
            config["model_name"] = model_name
        return cls._extractors[modality](config)

    @classmethod
    def extract_features_with_caching(
        cls, extractor: BaseFeatureExtractor, assembly: Any, story: str,
        idx: int, layer_idx: int = 9, lookback: int = 256,
        dataset_type: str = "narratives",
    ) -> np.ndarray:
        """Per-story extraction (the name is the JAX package's)."""
        modality = cls._get_modality_from_extractor(extractor)
        if modality == "wordrate":
            return extractor.extract_features(assembly.get_word_rates()[idx])
        return extractor.extract_features(assembly.get_words()[idx])

    @classmethod
    def _get_modality_from_extractor(cls,
                                     extractor: BaseFeatureExtractor) -> str:
        for modality, klass in cls._extractors.items():
            if isinstance(extractor, klass):
                return modality
        raise ValueError(f"Unknown extractor type: {type(extractor)}")

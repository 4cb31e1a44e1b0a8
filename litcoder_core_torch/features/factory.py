"""Feature-extractor factory with cache-aware dispatch (twin of
litcoder_core_tpu/features/factory.py).

The same registry, create/extract API and cache-key semantics: a
language-model or speech miss computes ALL layers in one batched pass,
caches them under the JAX package's key (LM: story, lookback, model,
context type, pooling, dataset; speech: audio path, model, chunk and
context sizes, pooling, sample rate, dataset, layer_mode 'all'; the dtype
only when it is not fp32) and serves the requested layer (speech: with its
window end times), so caches written by either package serve the
other."""

from datetime import datetime
from typing import Any, Dict, Tuple, Union

import numpy as np

from litcoder_core_torch.features.base import BaseFeatureExtractor
from litcoder_core_torch.features.embeddings import (
    StaticEmbeddingFeatureExtractor,
)
from litcoder_core_torch.features.language_model import (
    LanguageModelFeatureExtractor,
)
from litcoder_core_torch.features.simple_features import (
    WordRateFeatureExtractor,
)
from litcoder_core_torch.features.speech_model import SpeechFeatureExtractor
from litcoder_core_torch.utils.caches import (
    ActivationCache,
    SpeechActivationCache,
)


class FeatureExtractorFactory:
    """Creates extractors and dispatches cache-aware extraction."""

    _extractors = {
        "language_model": LanguageModelFeatureExtractor,
        "speech": SpeechFeatureExtractor,
        "wordrate": WordRateFeatureExtractor,
        "embeddings": StaticEmbeddingFeatureExtractor,
    }

    @classmethod
    def create_extractor(cls, modality: str, model_name: str,
                         config: Dict[str, Any],
                         cache_dir: str = "cache") -> BaseFeatureExtractor:
        """Create an extractor; a language-model one gets `cache_dir` and an
        ActivationCache there, a speech one (built from keyword arguments)
        `cache_dir` and a SpeechActivationCache."""
        if modality not in cls._extractors:
            raise ValueError(
                f"Unsupported modality '{modality}'. "
                f"Supported modalities: {list(cls._extractors.keys())}"
            )
        if "model_name" not in config:
            config["model_name"] = model_name
        extractor_class = cls._extractors[modality]
        if modality == "speech":
            extractor = extractor_class(**config)
            extractor.cache_dir = cache_dir
            extractor.speech_cache = SpeechActivationCache(cache_dir=cache_dir)
        else:
            extractor = extractor_class(config)
        if modality == "language_model":
            extractor.cache_dir = cache_dir
            extractor.activation_cache = ActivationCache(cache_dir=cache_dir)
        return extractor

    @classmethod
    def extract_features_with_caching(
        cls, extractor: BaseFeatureExtractor, assembly: Any, story: str,
        idx: int, layer_idx: int = 9, lookback: int = 256,
        dataset_type: str = "narratives",
    ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Per-story extraction, through the activation caches for the
        language model and speech; speech gives (features, times)."""
        modality = cls._get_modality_from_extractor(extractor)
        if modality == "language_model":
            return cls._extract_language_model_features(
                extractor, assembly, story, idx, layer_idx, lookback,
                dataset_type,
            )
        if modality == "speech":
            return cls._extract_speech_features(
                extractor, assembly, story, idx, layer_idx, dataset_type)
        if modality == "wordrate":
            return extractor.extract_features(assembly.get_word_rates()[idx])
        if modality == "embeddings":
            return extractor.extract_features(assembly.get_words()[idx])
        raise ValueError(f"Unknown modality: {modality}")

    @classmethod
    def _get_modality_from_extractor(cls,
                                     extractor: BaseFeatureExtractor) -> str:
        for modality, klass in cls._extractors.items():
            if isinstance(extractor, klass):
                return modality
        raise ValueError(f"Unknown extractor type: {type(extractor)}")

    @classmethod
    def _extract_language_model_features(
        cls, extractor, assembly, story: str, idx: int, layer_idx: int,
        lookback: int = 256, dataset_type: str = "narratives",
    ) -> np.ndarray:
        """LM path: all layers cached on a miss, the requested layer
        served."""
        texts = assembly.get_stimuli()[idx]
        key_params = dict(
            story=story,
            lookback=lookback,
            model_name=extractor.model_name,
            context_type=getattr(extractor, "context_type", "fullcontext"),
            last_token=getattr(extractor, "last_token", False),
            dataset_type=dataset_type,
            raw=True,
        )
        # Non-default compute dtypes key separately (bf16 features must not
        # collide with fp32 ones); the default is OMITTED so existing fp32
        # caches keep their keys.
        dtype = getattr(extractor, "compute_dtype", "float32")
        if dtype != "float32":
            key_params["dtype"] = dtype
        cache_key = extractor.activation_cache._get_cache_key(**key_params)
        lazy_cache = extractor.activation_cache.load_multi_layer_activations(
            cache_key
        )
        if lazy_cache is not None:
            return lazy_cache.get_layer(layer_idx)

        all_features = extractor.extract_all_layers(texts)
        metadata = {
            "model_name": extractor.model_name,
            "story": story,
            "lookback": lookback,
            "context_type": getattr(extractor, "context_type", "fullcontext"),
            "hook_type": extractor.hook_type,
            "last_token": getattr(extractor, "last_token", False),
            "dataset_type": dataset_type,
            "available_layers": list(all_features.keys()),
            "created_at": datetime.now().isoformat(),
        }
        extractor.activation_cache.save_multi_layer_activations(
            cache_key, all_features, metadata
        )
        return all_features[layer_idx]

    @classmethod
    def _extract_speech_features(
        cls, extractor, assembly, story: str, idx: int, layer_idx: int,
        dataset_type: str,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Speech path: all layers and the window times cached on a miss;
        a hit is checked against the extractor's parameters, then the
        requested layer is served with its times."""
        wav_path = assembly.get_audio_path()[idx]
        extra = {"layer_mode": "all"}
        dtype = getattr(extractor, "compute_dtype", "float32")
        if dtype != "float32":
            extra["dtype"] = dtype
        params = {
            "model_name": extractor.model_name,
            "chunk_size": extractor.chunk_size,
            "context_size": extractor.context_size,
            "pool": extractor.pool,
            "target_sample_rate": extractor.target_sample_rate,
            "dataset_type": dataset_type,
        }
        cache_key = extractor.speech_cache.get_cache_key(
            audio_id=wav_path, extra=extra, **params)
        lazy = extractor.speech_cache.load_multi_layer_activations(cache_key)
        if lazy is not None:
            lazy.validate_params(expected=params)
            return lazy.get_layer(layer_idx), lazy.get_times()

        layer_to_feats, times = extractor.extract_all_layers(wav_path)
        if len(layer_to_feats) == 0:
            raise RuntimeError(
                "extract_all_layers returned no layers (audio too short?)."
            )
        metadata = {
            "modality": "speech",
            "audio_id": wav_path,
            **params,
            "available_layers": sorted(layer_to_feats.keys()),
        }
        extractor.speech_cache.save_multi_layer_activations(
            cache_key, all_layer_activations=layer_to_feats,
            metadata=metadata, times=times,
        )
        return layer_to_feats[layer_idx], times

    @classmethod
    def get_supported_modalities(cls) -> list:
        return list(cls._extractors.keys())

    @classmethod
    def register_extractor(cls, modality: str, extractor_class: type):
        """Plugin hook for custom extractors (see features/custom.py)."""
        cls._extractors[modality] = extractor_class

"""Activation caches with lazy per-layer reads (twin of
litcoder_core_tpu/utils/caches.py; host-only, no torch).

Same cache keys (md5 of the sorted-key JSON of the parameters), file names
and layout as the JAX package, so a cache written by either package loads
in the other under the same key: .npz archives whose metadata is a JSON
member and whose layers are independent members (get_layer reads one
layer's bytes), plus read-only support for legacy .pkl blobs. A .pkl cache
is unpickled: load only caches this project wrote.
"""

import json
import hashlib
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

logger = logging.getLogger(__name__)

_META_KEY = "__metadata_json__"
_TIMES_KEY = "__times__"


def _save_npz_cache(path: Path, layers: Dict[int, np.ndarray],
                    metadata: Dict[str, Any],
                    times: Optional[np.ndarray] = None) -> None:
    arrays = {f"layer_{int(k)}": np.asarray(v) for k, v in layers.items()}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(metadata, default=str).encode(), dtype=np.uint8
    )
    if times is not None:
        arrays[_TIMES_KEY] = np.asarray(times)
    np.savez(path, **arrays)


class LazyLayerCache:
    """Per-layer lazy reader over an .npz cache (or a legacy .pkl blob)."""

    def __init__(self, cache_file_path: Union[str, Path]):
        self.cache_file_path = Path(cache_file_path)
        self._metadata: Optional[Dict[str, Any]] = None
        self._loaded_layers: Dict[int, np.ndarray] = {}
        self._npz = None
        self._legacy_blob = None

    def _open(self):
        if self._npz is not None or self._legacy_blob is not None:
            return
        if not self.cache_file_path.exists():
            raise FileNotFoundError(
                f"Cache file not found: {self.cache_file_path}"
            )
        if self.cache_file_path.suffix == ".pkl":
            with open(self.cache_file_path, "rb") as f:
                self._legacy_blob = pickle.load(f)
        else:
            self._npz = np.load(self.cache_file_path, allow_pickle=False)

    def get_metadata(self) -> Dict[str, Any]:
        if self._metadata is None:
            self._open()
            if self._legacy_blob is not None:
                self._metadata = self._legacy_blob["metadata"]
            else:
                raw = bytes(self._npz[_META_KEY].tobytes())
                self._metadata = json.loads(raw.decode())
        return self._metadata

    def get_layer(self, layer_idx: int) -> np.ndarray:
        if layer_idx not in self._loaded_layers:
            self._open()
            if self._legacy_blob is not None:
                layers = self._legacy_blob["layers"]
                if layer_idx not in layers:
                    raise ValueError(
                        f"Layer {layer_idx} not found in cache. "
                        f"Available layers: {sorted(layers.keys())}"
                    )
                self._loaded_layers[layer_idx] = np.asarray(layers[layer_idx])
            else:
                key = f"layer_{layer_idx}"
                if key not in self._npz.files:
                    raise ValueError(
                        f"Layer {layer_idx} not found in cache. "
                        f"Available layers: {self.get_available_layers()}"
                    )
                self._loaded_layers[layer_idx] = self._npz[key]
        return self._loaded_layers[layer_idx]

    def get_layers(self, layer_indices: List[int]) -> List[np.ndarray]:
        return [self.get_layer(i) for i in layer_indices]

    def clear_loaded_layers(self) -> None:
        self._loaded_layers.clear()

    def get_available_layers(self) -> List[int]:
        self._open()
        if self._legacy_blob is not None:
            return sorted(int(k) for k in self._legacy_blob["layers"].keys())
        return sorted(
            int(name[len("layer_"):])
            for name in self._npz.files
            if name.startswith("layer_")
        )

    def validate_context_type(self, expected_context_type: str) -> None:
        cached = self.get_metadata().get("context_type")
        if cached != expected_context_type:
            raise ValueError(
                f"Cache context_type mismatch: expected "
                f"{expected_context_type}, got {cached}"
            )


class ActivationCache:
    """LM activation cache keyed by md5(json(params))."""

    def __init__(self, cache_dir: str = "cache"):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _get_cache_key(self, story: str, lookback: int, model_name: str,
                       context_type: str, last_token: bool,
                       dataset_type: str, raw: bool, **extra) -> str:
        """md5(json(params)) key. `extra` admits non-default knobs (e.g.
        dtype='bfloat16') WITHOUT changing the keys of existing
        default-config caches."""
        params = {
            "story": story,
            "lookback": lookback,
            "model_name": model_name,
            "context_type": context_type,
            "last_token": last_token,
            "dataset_type": dataset_type,
            "raw": raw,
            **extra,
        }
        return hashlib.md5(
            json.dumps(params, sort_keys=True).encode()
        ).hexdigest()

    def get_cache_path(self, cache_key: str) -> Path:
        return self.cache_dir / f"{cache_key}.npz"

    def _find_existing(self, cache_key: str) -> Optional[Path]:
        for suffix in (".npz", ".pkl"):  # .pkl = legacy pickled caches
            p = self.cache_dir / f"{cache_key}{suffix}"
            if p.exists():
                return p
        return None

    def save_multi_layer_activations(
        self, cache_key: str,
        all_layer_activations: Dict[int, np.ndarray],
        metadata: Dict[str, Any],
    ) -> None:
        path = self.get_cache_path(cache_key)
        _save_npz_cache(path, all_layer_activations, metadata)
        logger.info("Saved multi-layer activations to %s", path)

    def load_multi_layer_activations(
        self, cache_key: str
    ) -> Optional[LazyLayerCache]:
        path = self._find_existing(cache_key)
        if path is not None:
            logger.info("Loading multi-layer activations from %s", path)
            return LazyLayerCache(path)
        return None

    # Backward-compatible single-layer API.
    def save_activations(self, cache_key: str, activations: np.ndarray):
        path = self.cache_dir / f"{cache_key}.single.npy"
        np.save(path, np.asarray(activations))
        logger.info("Saved activations to %s", path)

    def load_activations(self, cache_key: str) -> Optional[np.ndarray]:
        path = self.cache_dir / f"{cache_key}.single.npy"
        if path.exists():
            return np.load(path)
        legacy = self.cache_dir / f"{cache_key}.pkl"
        if legacy.exists():
            with open(legacy, "rb") as f:
                return pickle.load(f)
        return None


class SpeechLazyLayerCache(LazyLayerCache):
    """Speech variant: adds times + param validation."""

    def get_times(self) -> Optional[np.ndarray]:
        self._open()
        if self._legacy_blob is not None:
            t = self._legacy_blob.get("times")
            return np.asarray(t) if t is not None else None
        if _TIMES_KEY in self._npz.files:
            return self._npz[_TIMES_KEY]
        return None

    def validate_params(self, *, expected: Dict[str, Any]) -> None:
        md = self.get_metadata()
        mismatches = [
            (k, md.get(k), v) for k, v in expected.items() if md.get(k) != v
        ]
        if mismatches:
            raise ValueError(
                "Speech cache parameter mismatch:\n" + "\n".join(
                    f"  - {k}: cached={got} vs expected={exp}"
                    for (k, got, exp) in mismatches
                )
            )


class SpeechActivationCache:
    """Speech activation cache."""

    def __init__(self, cache_dir: str = "speech_cache"):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _hash_from_params(self, params: Dict[str, Any]) -> str:
        safe = json.loads(json.dumps(params, sort_keys=True, default=str))
        return hashlib.md5(json.dumps(safe, sort_keys=True).encode()).hexdigest()

    def get_cache_key(self, *, audio_id: str, model_name: str,
                      chunk_size: float, context_size: float, pool: str,
                      target_sample_rate: int, dataset_type: str = "speech",
                      extra: Optional[Dict[str, Any]] = None) -> str:
        params = {
            "modality": "speech",
            "audio_id": audio_id,
            "model_name": model_name,
            "chunk_size": float(chunk_size),
            "context_size": float(context_size),
            "pool": pool,
            "target_sample_rate": int(target_sample_rate),
            "dataset_type": dataset_type,
        }
        if extra:
            params["extra"] = extra
        return self._hash_from_params(params)

    def get_cache_path(self, cache_key: str) -> Path:
        return self.cache_dir / f"{cache_key}.npz"

    def _find_existing(self, cache_key: str) -> Optional[Path]:
        for suffix in (".npz", ".pkl"):
            p = self.cache_dir / f"{cache_key}{suffix}"
            if p.exists():
                return p
        return None

    def save_multi_layer_activations(
        self, cache_key: str,
        all_layer_activations: Dict[int, np.ndarray],
        metadata: Dict[str, Any],
        times: Optional[np.ndarray] = None,
    ) -> None:
        path = self.get_cache_path(cache_key)
        layers = {int(k): np.asarray(v) for k, v in all_layer_activations.items()}
        _save_npz_cache(path, layers, dict(metadata), times=times)
        logger.info("[SpeechActivationCache] Saved to %s", path)

    def load_multi_layer_activations(
        self, cache_key: str
    ) -> Optional[SpeechLazyLayerCache]:
        path = self._find_existing(cache_key)
        if path is not None:
            logger.info("[SpeechActivationCache] Loading from %s", path)
            return SpeechLazyLayerCache(path)
        return None

    def save_activations(self, cache_key: str, activations: np.ndarray):
        np.save(self.cache_dir / f"{cache_key}.single.npy",
                np.asarray(activations))

    def load_activations(self, cache_key: str) -> Optional[np.ndarray]:
        path = self.cache_dir / f"{cache_key}.single.npy"
        return np.load(path) if path.exists() else None

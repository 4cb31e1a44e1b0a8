"""Surface-projection cache keyed on md5(subject:path:mtime) (twin of
litcoder_core_tpu/brain_projection/simple_cache.py): the same keys and .npy
files, so entries written by either package serve the other."""

import hashlib
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


class SimpleSurfaceCache:
    """Processed (time, vertices) surface matrices, one .npy per NIfTI file
    and subject; the file's mtime is part of the key, so touching the file
    invalidates its entry."""

    def __init__(self, cache_dir: str = "surface_cache"):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _key(self, subject: str, volume_path: str) -> str:
        mtime = (os.path.getmtime(volume_path)
                 if os.path.exists(volume_path) else 0)
        raw = f"{subject}:{volume_path}:{mtime}"
        return hashlib.md5(raw.encode()).hexdigest()

    def _path(self, key: str) -> Path:
        return self.cache_dir / f"{key}.npy"

    def get(self, subject: str, volume_path: str) -> Optional[np.ndarray]:
        path = self._path(self._key(subject, volume_path))
        if not path.exists():
            return None
        try:
            data = np.load(path)
        except Exception as e:
            # A corrupt or partly written entry (a run killed mid-save) is
            # a miss, and is removed so the next store replaces it.
            logger.warning("Surface cache corrupt, recomputing %s: %s",
                           path, e)
            path.unlink(missing_ok=True)
            return None
        logger.info("Surface cache hit: %s", path)
        return data

    def set(self, subject: str, volume_path: str, data: np.ndarray) -> None:
        path = self._path(self._key(subject, volume_path))
        # Atomic publish: a reader never sees a half-written file.
        tmp = path.with_name(f".{path.stem}.tmp.npy")
        np.save(tmp, np.asarray(data))
        os.replace(tmp, path)
        logger.info("Surface cache store: %s", path)

    def clear(self) -> None:
        for p in self.cache_dir.glob("*.npy"):
            p.unlink()


_GLOBAL_CACHE: Optional[SimpleSurfaceCache] = None


def get_surface_cache(cache_dir: Optional[str] = None) -> SimpleSurfaceCache:
    """The process's surface cache. cache_dir=None returns the current one
    (created at './surface_cache' on first use); an explicit cache_dir
    re-points it there."""
    global _GLOBAL_CACHE
    if cache_dir is not None and (
        _GLOBAL_CACHE is None
        or str(_GLOBAL_CACHE.cache_dir) != str(cache_dir)
    ):
        _GLOBAL_CACHE = SimpleSurfaceCache(cache_dir)
    elif _GLOBAL_CACHE is None:
        _GLOBAL_CACHE = SimpleSurfaceCache("surface_cache")
    return _GLOBAL_CACHE

"""Brain projection: volume to fsaverage5 surface, volume flattening, and
the surface cache (host numpy)."""

from litcoder_core_torch.brain_projection.project import (
    BaseBrainDataProcessor,
    SurfaceData,
    SurfaceProcessor,
    VolumeData,
    VolumeProcessor,
)
from litcoder_core_torch.brain_projection.simple_cache import (
    SimpleSurfaceCache,
    get_surface_cache,
)

__all__ = [
    "BaseBrainDataProcessor", "SurfaceData", "SurfaceProcessor",
    "VolumeData", "VolumeProcessor", "SimpleSurfaceCache",
    "get_surface_cache",
]

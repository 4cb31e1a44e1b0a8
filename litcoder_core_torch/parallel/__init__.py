"""The fused nested-CV step. The JAX package's mesh and tensor-parallel
helpers (parallel/mesh.py, parallel/tp.py) are not ported (ROADMAP.md)."""

from litcoder_core_torch.parallel.step import (
    NestedCVResult,
    make_nested_cv_step,
    nested_cv_step,
    pad_voxels,
)

__all__ = ["NestedCVResult", "make_nested_cv_step", "nested_cv_step",
           "pad_voxels"]

"""Scale-out layer: device meshes, the voxel-sharded fused nested-CV step
and tensor-parallel extraction (twin of litcoder_core_tpu/parallel).

One process drives every device, as JAX's single-controller mesh does:
responses, alphas, weights and metrics shard on the voxel axis, stimuli
replicate, and the solve moves no voxel data between shards
(parallel/mesh.py, parallel/step.py); language-model and speech encoders
shard Megatron-style over a ('data', 'model') mesh (parallel/tp.py).
"""

from litcoder_core_torch.parallel.mesh import (
    VOX_AXIS,
    Mesh,
    VoxelShards,
    make_mesh,
    replicate,
    shard_voxels,
)
from litcoder_core_torch.parallel.step import (
    NestedCVResult,
    make_nested_cv_step,
    nested_cv_step,
    pad_voxels,
)
from litcoder_core_torch.parallel.tp import (
    DATA_AXIS,
    MODEL_AXIS,
    make_lm_mesh,
    shard_lm_params,
)

__all__ = [
    "make_mesh", "shard_voxels", "replicate", "VOX_AXIS",
    "make_nested_cv_step", "nested_cv_step", "pad_voxels",
    "make_lm_mesh", "shard_lm_params", "DATA_AXIS", "MODEL_AXIS",
    "Mesh", "VoxelShards", "NestedCVResult",
]

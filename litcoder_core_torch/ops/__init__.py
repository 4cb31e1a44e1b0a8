"""Tensor ops of the port: stats, interpolation, FIR, segment pooling. The
fused Lanczos+FIR kernel is litcoder_core_torch.ops.lanczos_fir (not
re-exported here: the function would shadow its module)."""

from litcoder_core_torch.ops.fir import make_delayed
from litcoder_core_torch.ops.interp import (
    gabor_xfm,
    gabor_xfm2D,
    interpdata,
    lanczos_matrix,
    lanczosfun,
    lanczosinterp2D,
    sincfun,
    sincinterp2D,
)
from litcoder_core_torch.ops.segment import (
    boundaries_to_segment_ids,
    rect_pool,
    segment_last_pool,
    segment_mean_pool,
    segment_sum_pool,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection,
    bh_fdrcorrection_np,
    fisher_combine_pvalues,
    pearson_pvalues,
    pearson_pvalues_f64,
    pearson_r,
    trainer_zscore,
    zscore,
)

__all__ = [
    "make_delayed",
    "gabor_xfm",
    "gabor_xfm2D",
    "interpdata",
    "lanczos_matrix",
    "lanczosfun",
    "lanczosinterp2D",
    "sincfun",
    "sincinterp2D",
    "boundaries_to_segment_ids",
    "rect_pool",
    "segment_last_pool",
    "segment_mean_pool",
    "segment_sum_pool",
    "bh_fdrcorrection",
    "bh_fdrcorrection_np",
    "fisher_combine_pvalues",
    "pearson_pvalues",
    "pearson_pvalues_f64",
    "pearson_r",
    "trainer_zscore",
    "zscore",
]

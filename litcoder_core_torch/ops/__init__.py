"""Tensor ops of the port: stats, interpolation, FIR. The fused Lanczos+FIR
kernel is litcoder_core_torch.ops.lanczos_fir."""

from litcoder_core_torch.ops.fir import make_delayed
from litcoder_core_torch.ops.interp import (
    lanczos_matrix,
    lanczosfun,
    lanczosinterp2D,
)
from litcoder_core_torch.ops.stats import (
    bh_fdrcorrection_np,
    pearson_pvalues_f64,
    pearson_r,
    trainer_zscore,
    zscore,
)

__all__ = [
    "make_delayed",
    "lanczos_matrix",
    "lanczosfun",
    "lanczosinterp2D",
    "bh_fdrcorrection_np",
    "pearson_pvalues_f64",
    "pearson_r",
    "trainer_zscore",
    "zscore",
]

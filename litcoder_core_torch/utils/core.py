"""Host column-stat helpers (twin of litcoder_core_tpu/utils/core.py). The
device-side twin of `zs` is litcoder_core_torch.ops.stats.trainer_zscore."""

import numpy as np


def zscore(v: np.ndarray) -> np.ndarray:
    """Z-scores each column of [v] (ddof=0); zero-variance columns are left
    demeaned. Accepts 1-D vectors."""
    s = v.std(0)
    m = v - v.mean(0)
    if m.ndim == 1:
        return m / s if s != 0.0 else m
    nonzero = s != 0.0
    m[:, nonzero] /= s[nonzero]
    return m


zs = zscore

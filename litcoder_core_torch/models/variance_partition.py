"""Variance partitioning across feature spaces (twin of
litcoder_core_tpu/models/variance_partition.py).

Every non-empty subset of the feature spaces is fitted with the same
nested-CV ridge (fit_nested_cv in train/test mode, no weights), and each
voxel's explained variance, the signed squared held-out correlation r * |r|
in float64, is split into unique and shared parts by inclusion-exclusion:
- 2 spaces: unique_A = R2_AB - R2_B; shared = R2_A + R2_B - R2_AB;
- 3 spaces: the same over the 7 subset fits.
Negative components are reported as they are.
"""

import itertools
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from litcoder_core_torch.models.nested_cv import fit_nested_cv
from litcoder_core_torch.utils.device import as_f32, resolve_device

logger = logging.getLogger(__name__)


def _fit_r2(Xs, Y, X_tests, y_test, **fit_kwargs) -> np.ndarray:
    """Signed R^2 (V,) of one subset fit: its spaces concatenated on the
    fit's device."""
    dev = resolve_device(fit_kwargs.get("device", "cuda"))
    X = torch.cat([as_f32(x, dev) for x in Xs], dim=1)
    Xt = torch.cat([as_f32(x, dev) for x in X_tests], dim=1)
    metrics, _, _ = fit_nested_cv(X, Y, X_test=Xt, y_test=y_test,
                                  return_weights=False, **fit_kwargs)
    r = np.asarray(metrics["correlations"], np.float64)
    return r * np.abs(r)


def variance_partitioning(
    Xs: Sequence,
    Y,
    X_tests: Sequence,
    y_test,
    names: Optional[List[str]] = None,
    device="cuda",
    **fit_kwargs,
) -> Dict[str, np.ndarray]:
    """Unique/shared variance per voxel over 2 or 3 feature spaces, each
    subset fitted on `device`.

    Args:
        Xs / X_tests: per-space train/test designs (same rows; numpy or
            tensors).
        Y / y_test: responses.
        names: space labels (default "A", "B", "C").
        fit_kwargs: forwarded to fit_nested_cv (alphas, chunk_length,
            n_inner_folds, seed, method, fast_scan, ...).

    Returns a dict of (V,) float64 arrays: 'r2_<subset>' for every subset
    (e.g. 'r2_A', 'r2_AB'), 'unique_<name>' per space, and 'shared'
    (2 spaces) or 'shared_<pair>' and 'shared_<all three names>' (3).
    """
    n_spaces = len(Xs)
    if n_spaces not in (2, 3):
        raise ValueError(
            f"variance partitioning supports 2 or 3 spaces, got {n_spaces}"
        )
    if len(X_tests) != n_spaces:
        raise ValueError("X_tests must match Xs per space")
    if names is None:
        names = ["A", "B", "C"][:n_spaces]

    subsets = [
        tuple(sorted(c))
        for k in range(1, n_spaces + 1)
        for c in itertools.combinations(range(n_spaces), k)
    ]
    r2: Dict[tuple, np.ndarray] = {}
    for sub in subsets:
        label = "".join(names[i] for i in sub)
        logger.info("variance partitioning: fitting subset %s", label)
        r2[sub] = _fit_r2([Xs[i] for i in sub], Y,
                          [X_tests[i] for i in sub], y_test, device=device,
                          **fit_kwargs)

    out: Dict[str, np.ndarray] = {
        "r2_" + "".join(names[i] for i in sub): v for sub, v in r2.items()
    }
    full = tuple(range(n_spaces))
    if n_spaces == 2:
        a, b = (0,), (1,)
        out[f"unique_{names[0]}"] = r2[full] - r2[b]
        out[f"unique_{names[1]}"] = r2[full] - r2[a]
        out["shared"] = r2[a] + r2[b] - r2[full]
    else:
        a, b, c = (0,), (1,), (2,)
        ab, ac, bc = (0, 1), (0, 2), (1, 2)
        out[f"unique_{names[0]}"] = r2[full] - r2[bc]
        out[f"unique_{names[1]}"] = r2[full] - r2[ac]
        out[f"unique_{names[2]}"] = r2[full] - r2[ab]
        out[f"shared_{names[0]}{names[1]}"] = (
            r2[ac] + r2[bc] - r2[c] - r2[full]
        )
        out[f"shared_{names[0]}{names[2]}"] = (
            r2[ab] + r2[bc] - r2[b] - r2[full]
        )
        out[f"shared_{names[1]}{names[2]}"] = (
            r2[ab] + r2[ac] - r2[a] - r2[full]
        )
        out[f"shared_{names[0]}{names[1]}{names[2]}"] = (
            r2[a] + r2[b] + r2[c] - r2[ab] - r2[ac] - r2[bc] + r2[full]
        )
    return out

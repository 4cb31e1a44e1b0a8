"""LeBel train/test structuring (the reference LITcoder's train_simple.py).

The last story is held out. Each story's delayed design and responses are
z-scored per column on their own (ddof 0; a constant column is only
demeaned; NaN -> 0 in the design) after trimming: training designs keep TR
rows 10..n-5 and test designs 50..n-5, against response rows 0.. and 40..
(a story's responses start at TR 10), then the training stories stack.
"""

from typing import Dict, List, Tuple

import torch

TRIM = {"train_features": (10, -5), "test_features": (50, -5),
        "train_targets": (0, None), "test_targets": (40, None)}


def zscore_columns(x: torch.Tensor) -> torch.Tensor:
    m = x - x.mean(0)
    s = x.std(0, correction=0)
    return torch.where(s == 0, m, m / torch.where(s == 0, 1.0, s))


def structure(designs: Dict[str, torch.Tensor],
              responses: Dict[str, torch.Tensor],
              order: List[str]) -> Tuple[torch.Tensor, ...]:
    """(X_train, Y_train, X_test, Y_test)."""
    def stack(source, names, key, design):
        lo, hi = TRIM[key]
        parts = [zscore_columns(source[n][lo:hi]) for n in names]
        out = torch.vstack(parts)
        return torch.nan_to_num(out) if design else out

    train, test = order[:-1], order[-1:]
    return (stack(designs, train, "train_features", True),
            stack(responses, train, "train_targets", False),
            stack(designs, test, "test_features", True),
            stack(responses, test, "test_targets", False))

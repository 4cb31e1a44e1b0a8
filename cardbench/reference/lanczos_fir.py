"""Lanczos downsampling onto the TR grid, then FIR delays.

The reference LITcoder's lanczosinterp2D and make_delayed, in torch:
weight(t) = window sin(pi t c) sin(pi t c / window) / (pi t c)^2 for
|t c| <= window (1 at t = 0, 0 beyond), c = cutoff_mult / mean(diff(TR
times)), t = TR time - word time; the delayed design holds, for each
delay d in order, the downsampled rows shifted down by d with zeros above.
"""

import math
from typing import Sequence

import torch


def lanczos_matrix(word_times: torch.Tensor, tr_times: torch.Tensor,
                   window: int = 3, cutoff_mult: float = 1.0) -> torch.Tensor:
    cutoff = cutoff_mult / torch.diff(tr_times).mean()
    t = (tr_times[:, None] - word_times[None, :]) * cutoff
    nonzero = torch.where(t == 0, torch.ones_like(t), t)
    w = (window * torch.sin(math.pi * nonzero)
         * torch.sin(math.pi * nonzero / window) / (math.pi * nonzero) ** 2)
    w = torch.where(t == 0, torch.ones_like(w), w)
    return torch.where(t.abs() > window, torch.zeros_like(w), w)


def delayed(x: torch.Tensor, delays: Sequence[int]) -> torch.Tensor:
    blocks = []
    for d in delays:
        shifted = torch.zeros_like(x)
        if d > 0:
            shifted[d:] = x[:-d]
        elif d < 0:
            shifted[:d] = x[-d:]
        else:
            shifted = x.clone()
        blocks.append(shifted)
    return torch.cat(blocks, dim=1)


def lanczos_fir(features: torch.Tensor, word_times: torch.Tensor,
                tr_times: torch.Tensor, delays: Sequence[int],
                window: int = 3, cutoff_mult: float = 1.0) -> torch.Tensor:
    K = lanczos_matrix(word_times, tr_times, window, cutoff_mult)
    return delayed(K @ features, delays)

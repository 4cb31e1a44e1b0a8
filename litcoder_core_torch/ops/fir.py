"""FIR delay expansion on tensors (twin of litcoder_core_tpu/ops/fir.py)."""

from typing import Iterable

import torch


def make_delayed(stim: torch.Tensor, delays: Iterable[int],
                 circpad: bool = False) -> torch.Tensor:
    """(T, D) -> (T, D * len(delays)): for each delay d the rows shifted down
    by d (zero- or circular-padded), column blocks in the order of `delays`."""
    nt = stim.shape[0]
    rows = torch.arange(nt, device=stim.device)
    blocks = []
    for d in delays:
        d = int(d)
        if d == 0:
            blocks.append(stim)
            continue
        rolled = torch.roll(stim, d, dims=0)
        if circpad:
            blocks.append(rolled)
            continue
        valid = rows >= d if d > 0 else rows < nt + d
        blocks.append(torch.where(valid[:, None], rolled, 0.0))
    return torch.cat(blocks, dim=1)

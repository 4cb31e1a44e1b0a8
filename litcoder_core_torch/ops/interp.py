"""Lanczos interpolation on tensors (twin of litcoder_core_tpu/ops/interp.py).

The kernel matrix is one broadcast expression over newtime - oldtime, in the
same float32 arithmetic as the JAX package; the fused CUDA kernel in
csrc/lanczos_fir.cu evaluates the same expression tile by tile.
"""

import math

import torch


def lanczosfun(cutoff, t: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Lanczos kernel at times `t` with `window` lobes: 1 at t == 0, 0 where
    |t * cutoff| > window."""
    t = t.to(torch.float32) * cutoff
    pi = math.pi
    safe_t = torch.where(t == 0.0, 1.0, t)
    val = (
        window
        * torch.sin(pi * safe_t)
        * torch.sin(pi * safe_t / window)
        / (pi**2 * safe_t**2)
    )
    val = torch.where(t == 0.0, 1.0, val)
    return torch.where(torch.abs(t) > window, 0.0, val)


def lanczos_cutoff(newtime: torch.Tensor, cutoff_mult: float) -> torch.Tensor:
    """0-d float32 cutoff 1 / mean(diff(newtime)) * cutoff_mult."""
    return 1.0 / torch.mean(torch.diff(newtime.to(torch.float32))) * cutoff_mult


def lanczos_matrix(oldtime: torch.Tensor, newtime: torch.Tensor,
                   window: int = 3, cutoff_mult: float = 1.0) -> torch.Tensor:
    """Dense (n_new, n_old) Lanczos interpolation matrix."""
    oldtime = oldtime.to(torch.float32)
    newtime = newtime.to(torch.float32)
    cutoff = lanczos_cutoff(newtime, cutoff_mult)
    return lanczosfun(cutoff, newtime[:, None] - oldtime[None, :], window)


def lanczosinterp2D(data: torch.Tensor, oldtime: torch.Tensor,
                    newtime: torch.Tensor, window: int = 3,
                    cutoff_mult: float = 1.0,
                    rectify: bool = False) -> torch.Tensor:
    """Lanczos-interpolate the columns of (n_old, n_feat) `data` onto
    `newtime`; `rectify` hstacks the negative- and positive-clipped parts."""
    data = data.to(torch.float32)
    sincmat = lanczos_matrix(oldtime, newtime, window, cutoff_mult)
    if rectify:
        neg = sincmat @ torch.clamp(data, max=0.0)
        pos = sincmat @ torch.clamp(data, min=0.0)
        return torch.cat([neg, pos], dim=1)
    return sincmat @ data

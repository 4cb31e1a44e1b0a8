"""Interpolation for temporal downsampling on tensors (twin of
litcoder_core_tpu/ops/interp.py): Lanczos, sinc, linear and Gabor.

Each kernel matrix is one broadcast expression over newtime - oldtime, in
the same float32 arithmetic as the JAX package; the fused CUDA kernel in
csrc/lanczos_fir.cu evaluates the Lanczos one tile by tile.
"""

import math

import numpy as np
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


def sincfun(B, t: torch.Tensor, window=math.inf, causal: bool = False,
            renorm: bool = True) -> torch.Tensor:
    """Sinc kernel rows with cutoff B over the last axis of `t`, with the
    reference's quirks: the +1e-20 denominator makes the value at t == 0
    zero, and renorm divides only rows whose sum is nonzero."""
    t = t.to(torch.float32)
    val = 2 * B * torch.sin(2 * math.pi * B * t) / (2 * math.pi * B * t
                                                     + 1e-20)
    val = torch.where(torch.abs(t) > window / (2 * B), 0.0, val)
    if causal:
        val = torch.where(t < 0.0, 0.0, val)
    if renorm:
        s = torch.sum(val, dim=-1, keepdim=True)
        val = torch.where(s != 0.0, val / torch.where(s == 0.0, 1.0, s), val)
    return val


def sincinterp2D(data: torch.Tensor, oldtime: torch.Tensor,
                 newtime: torch.Tensor, cutoff_mult: float = 1.0,
                 window: int = 1, causal: bool = False,
                 renorm: bool = True) -> torch.Tensor:
    """Sinc-interpolate the columns of `data` onto `newtime`."""
    oldtime = oldtime.to(torch.float32)
    newtime = newtime.to(torch.float32)
    sincmat = sincfun(lanczos_cutoff(newtime, cutoff_mult),
                      newtime[:, None] - oldtime[None, :], window, causal,
                      renorm)
    return sincmat @ data.to(torch.float32)


def interpdata(data: torch.Tensor, oldtime: torch.Tensor,
               newtime: torch.Tensor) -> torch.Tensor:
    """Columnwise linear interpolation with jnp.interp's semantics: the end
    values outside [oldtime[0], oldtime[-1]], and the left value where two
    old times coincide (oldtime ascending)."""
    data = data.to(torch.float32)
    xp = oldtime.to(torch.float32)
    x = newtime.to(torch.float32)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    step = (x - xp[i - 1]) / torch.where(dx0, 1.0, dx)
    left = data[i - 1]
    f = torch.where(dx0[:, None], left,
                    left + step[:, None] * (data[i] - left))
    f = torch.where((x < xp[0])[:, None], data[0], f)
    return torch.where((x > xp[-1])[:, None], data[-1], f)


def _gabor_real_imag(data: torch.Tensor, oldtimes: torch.Tensor,
                     newtimes: torch.Tensor, freqs: torch.Tensor, sigma):
    """(cprod, sprod), each (n_feat, n_freqs, n_new): the Gabor products of
    the rows of (n_feat, n_old) `data`.

    The JAX package forms the (n_feat, n_new, n_old) Gaussian-windowed data
    (about 1.6 GB at a LeBel story) and multiplies it by the carriers. The
    port contracts the other way round: the carrier-modulated rows
    (n_feat * n_freqs, n_old) times the (n_old, n_new) window, one matmul
    each for cos and sin, so nothing larger than the output is formed."""
    data = data.to(torch.float32)
    oldtimes = oldtimes.to(torch.float32)
    newtimes = newtimes.to(torch.float32)
    freqs = freqs.to(torch.float32)
    phase = oldtimes[None, :] * freqs[:, None] * 2.0 * math.pi
    # The reference divides by 2 sigma^2 inside an extra 0.5 factor.
    gauss = torch.exp(
        -0.5 * (oldtimes[None, :] - newtimes[:, None]) ** 2
        / (2.0 * sigma**2))                                  # (n_new, n_old)
    n_feat, n_freq = data.shape[0], freqs.shape[0]
    out = []
    for carrier in (torch.cos(phase), torch.sin(phase)):   # (n_freqs, n_old)
        mod = (data[:, None, :] * carrier[None, :, :]).reshape(n_feat * n_freq,
                                                               -1)
        out.append((mod @ gauss.T).reshape(n_feat, n_freq, -1))
    return out[0], out[1]


def gabor_xfm(data: torch.Tensor, oldtimes: torch.Tensor,
              newtimes: torch.Tensor, freqs: torch.Tensor,
              sigma) -> torch.Tensor:
    """Gabor transform of a 1-D signal: complex (n_new, n_freqs)."""
    cprod, sprod = _gabor_real_imag(data.reshape(1, -1), oldtimes, newtimes,
                                    freqs, sigma)
    return torch.complex(cprod[0], sprod[0]).T


def gabor_xfm2D(data: torch.Tensor, oldtimes: torch.Tensor,
                newtimes: torch.Tensor, freqs: torch.Tensor,
                sigma) -> torch.Tensor:
    """Row-wise Gabor transform of (n_feat, n_old): complex
    (n_feat * n_freqs, n_new), row f * n_freqs + k for feature f and
    frequency k (the reference's vstack of transposes)."""
    cprod, sprod = _gabor_real_imag(torch.atleast_2d(data), oldtimes,
                                    newtimes, freqs, sigma)
    return torch.complex(cprod, sprod).reshape(-1, cprod.shape[-1])

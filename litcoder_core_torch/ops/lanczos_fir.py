"""Fused Lanczos downsampling + FIR delay stacking.

Port of litcoder_core_tpu/ops/pallas_kernels.py. The TPU kernel
(_lanczos_fir_kernel) becomes the hand-written CUDA kernel in
csrc/lanczos_fir.cu, launched by `lanczos_fir_cuda`. Its plain version,
`lanczos_fir_reference`, is the stacked-shifted-K product of the JAX
package's lanczos_fir_xla. `lanczos_fir` dispatches on the device: the
plain version for the CPU only, the kernel for CUDA (it launches or raises;
nothing falls back).

`launches` counts kernel launches, so a run can show that its main path
went through the kernel. `live_word_tiles` is the plain version of the
kernel's band skip: which word tiles each block visits.
"""

import ctypes
import math
from typing import Sequence, Tuple

import torch

from litcoder_core_torch.ops.interp import lanczos_cutoff, lanczos_matrix
from litcoder_core_torch.utils.device import as_f32, resolve_device

launches = 0

_KERNEL = "lanczos_fir"

# The kernel's TR rows per block and words per tile (kRows and kTileW in
# csrc/lanczos_fir.cu).
TILE_ROWS = 8
TILE_WORDS = 32


def shifted_lanczos_stack(data_times: torch.Tensor, tr_times: torch.Tensor,
                          delays: Sequence[int], window: int = 3,
                          cutoff_mult: float = 1.0) -> torch.Tensor:
    """(n_delays * T_tr, T_w): the Lanczos matrix shifted down by each delay,
    rows shifted in from outside zeroed, stacked in delay order."""
    K = lanczos_matrix(data_times, tr_times, window, cutoff_mult)
    t_tr = K.shape[0]
    rows = torch.arange(t_tr, device=K.device)
    blocks = []
    for d in delays:
        Kd = torch.roll(K, d, dims=0) if d else K
        if d > 0:
            Kd = torch.where((rows >= d)[:, None], Kd, 0.0)
        elif d < 0:
            Kd = torch.where((rows < t_tr + d)[:, None], Kd, 0.0)
        blocks.append(Kd)
    return torch.cat(blocks, dim=0)


def lanczos_fir_reference(data: torch.Tensor, data_times: torch.Tensor,
                          tr_times: torch.Tensor,
                          delays: Sequence[int] = (1, 2, 3, 4),
                          window: int = 3,
                          cutoff_mult: float = 1.0) -> torch.Tensor:
    """Plain version: (T_tr, n_delays * D) as one stacked product, column
    blocks ordered by delay, equal to make_delayed(lanczosinterp2D(...))."""
    delays = tuple(int(d) for d in delays)
    t_tr, dim = tr_times.shape[0], data.shape[1]
    K_all = shifted_lanczos_stack(data_times, tr_times, delays, window,
                                  cutoff_mult)
    out = K_all @ data.to(torch.float32)
    return (out.reshape(len(delays), t_tr, dim)
            .permute(1, 0, 2)
            .reshape(t_tr, len(delays) * dim))


def live_word_tiles(data_times: torch.Tensor, tr_times: torch.Tensor,
                    tile_rows: int = TILE_ROWS, tile_words: int = TILE_WORDS,
                    window: int = 3, cutoff_mult: float = 1.0) -> torch.Tensor:
    """(n_tr_tiles, n_word_tiles) bool: the word tiles the kernel visits for
    each tile of `tile_rows` TR rows.

    Mirrors the kernel's fp32 predicate: word w is live when
    |(tr - w) * cutoff| > window is false at the tile's smallest or largest
    TR time, or when w lies between them; a tile is visited when it holds a
    live word. NaN compares false, so a NaN cutoff leaves every tile live.
    The extremes skip NaN TR times as fminf/fmaxf do."""
    data_times = data_times.to(torch.float32)
    tr_times = tr_times.to(torch.float32)
    cutoff = lanczos_cutoff(tr_times, cutoff_mult)
    t_tr, t_w = tr_times.shape[0], data_times.shape[0]
    n_tr_tiles = math.ceil(t_tr / tile_rows)
    n_word_tiles = math.ceil(t_w / tile_words)
    # Padding rows are NaN, which torch.fmin/fmax skip as the kernel skips
    # rows past T_tr.
    tr = torch.full((n_tr_tiles * tile_rows,), math.nan)
    tr[:t_tr] = tr_times.cpu()
    tr = tr.reshape(n_tr_tiles, tile_rows)
    lo, hi = tr[:, 0], tr[:, 0]
    for r in range(1, tile_rows):
        lo, hi = torch.fmin(lo, tr[:, r]), torch.fmax(hi, tr[:, r])
    w = data_times.cpu()[None, :]
    cutoff = cutoff.cpu()

    def outside(edge):
        return torch.abs((edge[:, None] - w) * cutoff) > window

    live = (~outside(lo) | ~outside(hi)
            | ((lo[:, None] <= w) & (w <= hi[:, None])))
    padded = torch.zeros((n_tr_tiles, n_word_tiles * tile_words),
                         dtype=torch.bool)
    padded[:, :t_w] = live
    return padded.reshape(n_tr_tiles, n_word_tiles, tile_words).any(dim=2)


def build():
    """Build (or load) the kernel's library; returns (C entry point, build
    report). The entry point's argument types are declared here, so ctypes
    passes pointers and the stream as 64-bit values."""
    from litcoder_core_torch.ops import cuda_build

    lib, report = cuda_build.load(_KERNEL)
    fn = lib.lanczos_fir_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn, report


def prepare_launch(data: torch.Tensor, data_times: torch.Tensor,
                   tr_times: torch.Tensor, delays: Sequence[int],
                   cutoff_mult: float) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Check the inputs and make the kernel's small operands: returns
    (cutoff (1,) float32, delays (n,) int32, out (T_tr, n * D) uninitialised),
    all on the data's device."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"lanczos_fir_cuda needs CUDA tensors, got {dev}")
    for name, t, ndim in (("data", data, 2), ("data_times", data_times, 1),
                          ("tr_times", tr_times, 1)):
        if t.device != dev or t.dtype != torch.float32 or t.ndim != ndim \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {ndim}-D float32 tensor on "
                f"{dev}; got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if data_times.shape[0] != data.shape[0]:
        raise ValueError(
            f"data has {data.shape[0]} rows but data_times has "
            f"{data_times.shape[0]} entries"
        )
    if not delays:
        raise ValueError("delays must not be empty")
    cutoff = lanczos_cutoff(tr_times, cutoff_mult).reshape(1).contiguous()
    delays_t = torch.tensor([int(d) for d in delays], dtype=torch.int32,
                            device=dev)
    out = torch.empty((tr_times.shape[0], len(delays) * data.shape[1]),
                      dtype=torch.float32, device=dev)
    return cutoff, delays_t, out


def launch(data: torch.Tensor, data_times: torch.Tensor,
           tr_times: torch.Tensor, cutoff: torch.Tensor,
           delays: torch.Tensor, out: torch.Tensor, window: float) -> None:
    """Launch the kernel on the current stream with operands from
    `prepare_launch`; raises if CUDA refuses the launch."""
    global launches
    fn, _ = build()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = fn(
        data.data_ptr(), data_times.data_ptr(), tr_times.data_ptr(),
        cutoff.data_ptr(), delays.data_ptr(), out.data_ptr(),
        data.shape[0], tr_times.shape[0], data.shape[1], delays.shape[0],
        float(window), stream,
    )
    if err != 0:
        raise RuntimeError(f"lanczos_fir kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1


def lanczos_fir_cuda(data: torch.Tensor, data_times: torch.Tensor,
                     tr_times: torch.Tensor,
                     delays: Sequence[int] = (1, 2, 3, 4), window: int = 3,
                     cutoff_mult: float = 1.0) -> torch.Tensor:
    """The CUDA kernel on contiguous float32 CUDA tensors."""
    cutoff, delays_t, out = prepare_launch(data, data_times, tr_times,
                                           delays, cutoff_mult)
    launch(data, data_times, tr_times, cutoff, delays_t, out, window)
    return out


def lanczos_fir(data, data_times, tr_times,
                delays: Sequence[int] = (1, 2, 3, 4), window: int = 3,
                cutoff_mult: float = 1.0, device="cuda") -> torch.Tensor:
    """Fused Lanczos downsample + FIR delays on `device`.

    data (T_w, D), data_times (T_w,), tr_times (T_tr,) as arrays or tensors
    -> (T_tr, n_delays * D) float32 on `device`. On the CPU this is the
    plain version; on CUDA it is the hand-written kernel."""
    dev = resolve_device(device)
    data = as_f32(data, dev).contiguous()
    data_times = as_f32(data_times, dev).contiguous()
    tr_times = as_f32(tr_times, dev).contiguous()
    delays = tuple(int(d) for d in delays)
    if dev.type == "cpu":
        return lanczos_fir_reference(data, data_times, tr_times, delays,
                                     window, cutoff_mult)
    return lanczos_fir_cuda(data, data_times, tr_times, delays, window,
                            cutoff_mult)

"""Device resolution shared by the port's entry points, and the copy of
large results to the host.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without a usable card raises: nothing falls back to
the CPU behind the caller's back.
"""

import contextlib
import threading
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def _fp32_precision(flags, enabled: bool):
    saved = flags.fp32_precision
    flags.fp32_precision = "tf32" if enabled else "ieee"
    try:
        yield
    finally:
        flags.fp32_precision = saved


def matmul_tf32(enabled: bool):
    """Scope the CUDA float32 matmul precision: TF32 tensor-core products
    when `enabled`, full fp32 (IEEE) otherwise; the caller's setting is
    restored on exit, exceptions included. CPU products are untouched.

    Uses torch's per-backend `fp32_precision` flag (torch >= 2.9); reading
    the legacy `allow_tf32` after a caller set the new one raises."""
    return _fp32_precision(torch.backends.cuda.matmul, enabled)


@contextlib.contextmanager
def matmul_conv_tf32(enabled: bool):
    """matmul_tf32 that also scopes cuDNN convolutions, which torch lets
    run in TF32 by default (`torch.backends.cudnn.conv.fp32_precision`):
    the extractors' forwards, whose speech encoders open with
    convolutions."""
    with matmul_tf32(enabled), _fp32_precision(torch.backends.cudnn.conv,
                                               enabled):
        yield


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """Float32 tensor on `device` from a numpy array, list or tensor (no
    copy when `x` already is one there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


STAGING_SLOT_BYTES = 64 << 20


class _StagingRing:
    """Two pinned host slots of STAGING_SLOT_BYTES, their copy events and a
    copy stream: one per CUDA device, made on first use and kept for the
    process."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device)
        self.slots = [torch.empty(STAGING_SLOT_BYTES, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]


_staging_rings: Dict[torch.device, _StagingRing] = {}
_staging_lock = threading.Lock()   # one copy through the rings at a time


def _row_blocks(rows: int, cols: int, per_slot: int):
    """(row slice, column slice) blocks of a C-contiguous (rows, cols)
    array, each at most `per_slot` elements and contiguous: whole rows, or
    pieces of one row where a row outgrows a slot."""
    if cols <= per_slot:
        step = per_slot // cols
        return [(slice(r, min(r + step, rows)), slice(0, cols))
                for r in range(0, rows, step)]
    return [(slice(r, r + 1), slice(c, min(c + per_slot, cols)))
            for r in range(rows) for c in range(0, cols, per_slot)]


def copy_to_host(dst: np.ndarray, src: torch.Tensor) -> int:
    """Copy the (rows, cols) tensor `src` into the host array `dst` of the
    same shape and dtype (a strided view, such as a column slice of a
    larger array, is fine); returns the number of blocks copied.

    On the CPU one copy. On CUDA the rows go in blocks of at most one slot
    through the device's pinned staging ring (_StagingRing): each block's
    non-blocking copy runs on the ring's stream, after an event recorded
    on the current stream (so after `src`'s producer), while the host
    copies the block before it out of its slot with torch's multithreaded
    CPU copy. Returns once the last block is in `dst`, so `src` may be
    freed right after."""
    host = torch.from_numpy(dst)
    if host.shape != src.shape or host.dtype != src.dtype:
        raise ValueError(f"cannot copy a {src.dtype} {tuple(src.shape)} "
                         f"tensor into a {dst.dtype} {dst.shape} array")
    src = src.detach()
    if not src.is_cuda:
        dst[...] = src.numpy()
        return 1
    if src.numel() == 0:
        return 0
    src = src.contiguous()
    with _staging_lock:
        ring = _staging_rings.get(src.device)
        if ring is None:
            ring = _staging_rings[src.device] = _StagingRing(src.device)
        blocks = _row_blocks(*src.shape,
                             ring.slots[0].numel() // src.element_size())
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        ring.stream.wait_event(ready)
        pending = None
        for k, (rs, cs) in enumerate(blocks):
            block = src[rs, cs]
            staged = ring.slots[k % 2][:block.numel() * src.element_size()]
            staged = staged.view(src.dtype).view(block.shape)
            with torch.cuda.stream(ring.stream):
                staged.copy_(block, non_blocking=True)
                ring.events[k % 2].record(ring.stream)
            if pending is not None:
                _drain(ring, host, *pending)
            pending = (k % 2, staged, rs, cs)
        _drain(ring, host, *pending)
    return len(blocks)


def _drain(ring: _StagingRing, host: torch.Tensor, slot: int,
           staged: torch.Tensor, rs: slice, cs: slice) -> None:
    """Wait for a block's copy into its slot, then copy it into `host`."""
    ring.events[slot].synchronize()
    host[rs, cs].copy_(staged)


def synchronizer(device: torch.device):
    """Barrier for stage timing: CUDA work is asynchronous, so a stage's
    wall time is only real once the card has finished it."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None

"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without a usable card raises: nothing falls back to
the CPU behind the caller's back.
"""

import contextlib

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


def synchronizer(device: torch.device):
    """Barrier for stage timing: CUDA work is asynchronous, so a stage's
    wall time is only real once the card has finished it."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return None

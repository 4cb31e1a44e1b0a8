"""TF32 scoping for the reference (off) and its control (on)."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """CUDA float32 matmuls and cuDNN convolutions in TF32 when `enabled`,
    in full float32 otherwise; the previous settings come back on exit."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    saved = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "tf32" if enabled else "ieee"
    try:
        yield
    finally:
        for f, s in zip(flags, saved):
            f.fp32_precision = s

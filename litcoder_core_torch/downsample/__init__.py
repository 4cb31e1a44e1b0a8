"""Temporal downsampling of word-level features onto TRs."""

from litcoder_core_torch.downsample.downsampling import Downsampler

__all__ = ["Downsampler"]

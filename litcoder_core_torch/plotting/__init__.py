"""Experiment loggers of the port."""

from litcoder_core_torch.plotting.plotting_utils import Logger, NullLogger

__all__ = ["Logger", "NullLogger"]

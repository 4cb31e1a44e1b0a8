"""Experiment loggers and brain plots of the port."""

from litcoder_core_torch.plotting.plotting_utils import (
    BrainPlotter,
    Logger,
    NullLogger,
    TensorBoardLogger,
    WandBLogger,
)

__all__ = [
    "Logger", "NullLogger", "TensorBoardLogger", "WandBLogger", "BrainPlotter",
]

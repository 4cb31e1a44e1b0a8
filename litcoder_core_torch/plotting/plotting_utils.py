"""Experiment logger interface (twin of
litcoder_core_tpu/plotting/plotting_utils.py): the Logger ABC and the
NullLogger. The TensorBoard and W&B backends and the brain plots are queued
in ROADMAP.md."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np


class Logger(ABC):
    """Abstract logging backend."""

    @abstractmethod
    def log_scalar(self, name: str, value: float,
                   step: Optional[int] = None) -> None: ...

    @abstractmethod
    def log_image(self, name: str, figure: Any,
                  step: Optional[int] = None) -> None: ...

    @abstractmethod
    def log_histogram(self, name: str, values: np.ndarray,
                      step: Optional[int] = None) -> None: ...


class NullLogger(Logger):
    """Drops everything; records names for tests and headless runs."""

    def __init__(self):
        self.scalars: Dict[str, float] = {}
        self.images = []
        self.histograms = []

    def log_scalar(self, name, value, step=None):
        self.scalars[name] = value

    def log_image(self, name, figure, step=None):
        self.images.append(name)

    def log_histogram(self, name, values, step=None):
        self.histograms.append(name)

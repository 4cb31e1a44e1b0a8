"""FIR expander class API (twin of litcoder_core_tpu/features/fir_expander.py).

The math is litcoder_core_torch.ops.fir.make_delayed; this class keeps the
reference's object API. It returns tensors on the input's device (numpy
input is taken as a CPU tensor)."""

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

from litcoder_core_torch.ops import fir as fir_ops


@dataclass
class FIR:
    """FIR.make_delayed(stim, delays) or FIR(delays, circpad).expand(stim)."""

    delays: Optional[Iterable[int]] = None
    circpad: bool = False

    def expand(self, stim) -> torch.Tensor:
        if self.delays is None:
            raise ValueError("delays must be provided for instance usage of FIR")
        return FIR.make_delayed(stim, self.delays, self.circpad)

    @staticmethod
    def make_delayed(stim, delays: Iterable[int],
                     circpad: bool = False) -> torch.Tensor:
        """Delayed-copies design matrix, (T, D * len(delays))."""
        return fir_ops.make_delayed(torch.as_tensor(stim), delays, circpad)

    def n_delays(self) -> int:
        return len(list(self.delays)) if self.delays is not None else 0

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.n_delays()

    def valid_length(self, nt: int) -> int:
        """Non-padded timepoints; nt when circpad."""
        if self.delays is None:
            raise ValueError("delays must be provided")
        if self.circpad:
            return nt
        return max(0, nt - max(abs(d) for d in self.delays))

    def summary(self, input_dim: Optional[int] = None,
                nt: Optional[int] = None) -> str:
        msg = f"FIR(delays={list(self.delays)}, circpad={self.circpad})"
        if input_dim is not None:
            msg += f"\n- Output dim: {self.output_dim(input_dim)}"
        if nt is not None:
            msg += f"\n- Valid length: {self.valid_length(nt)}"
        return msg

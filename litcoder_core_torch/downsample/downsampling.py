"""Downsampler facade (twin of litcoder_core_tpu/downsample/downsampling.py),
'lanczos' method only: the two-stage path the fused kernel is held against.
The other nine methods are queued in ROADMAP.md."""

import torch

from litcoder_core_torch.ops import interp as interp_ops
from litcoder_core_torch.utils.device import as_f32, resolve_device

_NOT_PORTED = ("rect", "average", "sinc", "last", "gabor", "legacy_average",
               "legacy_last", "sum", "legacy_sum")


class Downsampler:
    """Downsampler().downsample(data, data_times, tr_times, method, ...)."""

    METHOD_PARAMS = {
        "lanczos": {"required": ["window", "cutoff_mult"],
                    "optional": ["rectify"]},
    }

    def _validate_method_params(self, method: str, **kwargs) -> dict:
        """Filter kwargs to the method's declared params."""
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"downsampling method {method!r} is not ported to "
                "litcoder_core_torch yet (see ROADMAP.md, queue A)"
            )
        if method not in self.METHOD_PARAMS:
            raise ValueError(f"Unsupported downsampling method: {method}")
        spec = self.METHOD_PARAMS[method]
        filtered = {}
        for param in spec["required"]:
            if param not in kwargs:
                raise ValueError(
                    f"Required parameter '{param}' missing for method "
                    f"'{method}'"
                )
            filtered[param] = kwargs[param]
        for param in spec["optional"]:
            if param in kwargs:
                filtered[param] = kwargs[param]
        return filtered

    def downsample(self, data, data_times, tr_times, method: str = "lanczos",
                   device="cuda", **kwargs) -> torch.Tensor:
        """Downsample `data` onto `tr_times` on `device`; returns a float32
        tensor there."""
        filtered = self._validate_method_params(method, **kwargs)
        dev = resolve_device(device)
        return interp_ops.lanczosinterp2D(
            as_f32(data, dev), as_f32(data_times, dev), as_f32(tr_times, dev),
            **filtered,
        )

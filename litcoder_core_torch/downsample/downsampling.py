"""Downsampler facade with the reference's ten methods (twin of
litcoder_core_tpu/downsample/downsampling.py).

Downsampler().downsample(data, data_times, tr_times, method=..., **kwargs)
validates the method's required and optional parameters (METHOD_PARAMS)
and returns a float32 tensor on `device`. Kernel-matrix matmuls serve
lanczos, sinc, gabor and rect, segment ops the split-index poolers; the
split indices themselves stay host data.
"""

from typing import List

import numpy as np
import torch

from litcoder_core_torch.ops import interp as interp_ops
from litcoder_core_torch.ops import segment as segment_ops
from litcoder_core_torch.utils.device import (
    as_f32,
    matmul_tf32,
    resolve_device,
)


def _per_word_pool(pool_fn, data, split_indices, tr_times):
    """Pool per-word rows into TRs by the word -> TR map, emitting
    max(max id + 1, len(tr_times)) rows: the reference sizes its output as
    max(split_indices) + 1, which drops trailing TRs no word maps to; the
    extra rows are the zeros its own zero-init implies for wordless TRs."""
    if split_indices is None:
        raise ValueError("split_indices must be provided for this method")
    ids = np.asarray(split_indices)
    n_trs = int(ids.max()) + 1
    if tr_times is not None:
        n_trs = max(n_trs, len(tr_times))
    return pool_fn(data, torch.as_tensor(ids, device=data.device), n_trs)


def _legacy_pool(pool_fn, data, split_indices):
    """np.split boundary semantics: len(split_indices) + 1 rows."""
    if split_indices is None:
        raise ValueError(
            "split_indices must be provided for Legacy downsampling")
    boundaries = torch.as_tensor(np.asarray(split_indices),
                                 device=data.device)
    ids = segment_ops.boundaries_to_segment_ids(data.shape[0], boundaries)
    return pool_fn(data, ids, len(boundaries) + 1)


class Downsampler:
    """Downsampler().downsample(data, data_times, tr_times, method, ...)."""

    METHOD_PARAMS = {
        "lanczos": {"required": ["window", "cutoff_mult"],
                    "optional": ["rectify"]},
        "sinc": {"required": ["window", "cutoff_mult"],
                 "optional": ["causal", "renorm"]},
        "average": {"required": ["split_indices"], "optional": []},
        "sum": {"required": ["split_indices"], "optional": []},
        "last": {"required": ["split_indices"], "optional": []},
        "legacy_average": {"required": ["split_indices"], "optional": []},
        "legacy_sum": {"required": ["split_indices"], "optional": []},
        "legacy_last": {"required": ["split_indices"], "optional": []},
        "rect": {"required": [], "optional": []},
        "gabor": {"required": ["freqs", "sigma"], "optional": []},
    }

    def __init__(self):
        self._methods = {
            "rect": self._rect,
            "average": self._average,
            "sinc": self._sinc,
            "lanczos": self._lanczos,
            "last": self._last,
            "gabor": self._gabor,
            "legacy_average": self._legacy_average,
            "legacy_last": self._legacy_last,
            "sum": self._sum,
            "legacy_sum": self._legacy_sum,
        }

    # --- methods: data and times are float32 tensors on one device (the
    # split-index methods accept None times) ---------------------------------

    @staticmethod
    def _rect(data, data_times, tr_times):
        return segment_ops.rect_pool(data, data_times, tr_times)

    @staticmethod
    def _lanczos(data, data_times, tr_times, window=3, cutoff_mult=1.0,
                 rectify=False):
        return interp_ops.lanczosinterp2D(data, data_times, tr_times,
                                          window=window,
                                          cutoff_mult=cutoff_mult,
                                          rectify=rectify)

    @staticmethod
    def _sinc(data, data_times, tr_times, window=1, cutoff_mult=1.0,
              causal=False, renorm=True):
        return interp_ops.sincinterp2D(data, data_times, tr_times,
                                       cutoff_mult=cutoff_mult, window=window,
                                       causal=causal, renorm=renorm)

    @staticmethod
    def _gabor(data, data_times, tr_times, freqs=None, sigma=None):
        # |gabor_xfm2D(data.T)|.T, the magnitude formed on the device.
        out = interp_ops.gabor_xfm2D(data.T, data_times, tr_times,
                                     as_f32(freqs, data.device), sigma)
        return torch.abs(out).T

    @staticmethod
    def _average(data, data_times, tr_times, split_indices=None):
        return _per_word_pool(segment_ops.segment_mean_pool, data,
                              split_indices, tr_times)

    @staticmethod
    def _sum(data, data_times, tr_times, split_indices=None):
        return _per_word_pool(segment_ops.segment_sum_pool, data,
                              split_indices, tr_times)

    @staticmethod
    def _last(data, data_times, tr_times, split_indices=None):
        return _per_word_pool(segment_ops.segment_last_pool, data,
                              split_indices, tr_times)

    @staticmethod
    def _legacy_average(data, data_times, tr_times, split_indices=None):
        return _legacy_pool(segment_ops.segment_mean_pool, data,
                            split_indices)

    @staticmethod
    def _legacy_sum(data, data_times, tr_times, split_indices=None):
        return _legacy_pool(segment_ops.segment_sum_pool, data, split_indices)

    @staticmethod
    def _legacy_last(data, data_times, tr_times, split_indices=None):
        return _legacy_pool(segment_ops.segment_last_pool, data,
                            split_indices)

    # --- facade -------------------------------------------------------------

    def _validate_method_params(self, method: str, **kwargs) -> dict:
        """Filter kwargs to the method's declared params."""
        if method not in self._methods:
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

    def downsample(self, data, data_times, tr_times, method: str = "rect",
                   device="cuda", **kwargs) -> torch.Tensor:
        """Downsample `data` onto `tr_times` with the chosen method on
        `device`; returns a float32 tensor there."""
        filtered = self._validate_method_params(method, **kwargs)
        dev = resolve_device(device)
        # The split-index methods take no times, and None may stand for them.
        data_times, tr_times = (None if t is None else as_f32(t, dev)
                                for t in (data_times, tr_times))
        # fp32 products, as the JAX package's Precision.HIGHEST.
        with matmul_tf32(False):
            return self._methods[method](as_f32(data, dev), data_times,
                                         tr_times, **filtered)

    @property
    def available_methods(self) -> List[str]:
        return list(self._methods.keys())

    def get_method_params(self, method: str) -> dict:
        if method not in self._methods:
            raise ValueError(f"Unsupported downsampling method: {method}")
        return self.METHOD_PARAMS[method]

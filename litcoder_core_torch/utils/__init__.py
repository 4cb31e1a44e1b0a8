"""Utilities of the port: column stats, activation caches, model saver,
stage timer and profiler trace, device rules."""

from litcoder_core_torch.utils.caches import (
    ActivationCache,
    LazyLayerCache,
    SpeechActivationCache,
    SpeechLazyLayerCache,
)
from litcoder_core_torch.utils.core import (
    demean, dm, zscore, zs, rescale, rs, mcorr, xcorr, make_delayed,
    unmask_correlations_for_plotting,
)
from litcoder_core_torch.utils.profiling import StageTimer, annotate, trace
from litcoder_core_torch.utils.saver import ModelSaver

__all__ = [
    "demean", "dm", "zscore", "zs", "rescale", "rs", "mcorr", "xcorr",
    "make_delayed", "unmask_correlations_for_plotting",
    "ActivationCache", "LazyLayerCache",
    "SpeechActivationCache", "SpeechLazyLayerCache",
    "ModelSaver",
    "StageTimer", "annotate", "trace",
]

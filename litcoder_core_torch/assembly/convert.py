"""Assemblies carried over from the JAX package.

`assembly_from_reference` takes a litcoder_core_tpu SimpleNeuroidAssembly
without importing that package: it reads `.stories`, `.validation_method`
and, per story, the StoryData fields of `.story_data[name]`.
"""

import dataclasses

import numpy as np

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.story_data import StoryData

_ARRAYS = ("brain_data", "tr_times", "data_times", "temporal_baseline",
           "word_rates", "mask_indices")


def assembly_from_reference(obj) -> SimpleNeuroidAssembly:
    """The port's assembly holding the same stories and arrays as `obj`."""
    stories = []
    for name in obj.stories:
        src = obj.story_data[name]
        fields = {}
        for f in dataclasses.fields(StoryData):
            value = getattr(src, f.name, None)
            if f.name in _ARRAYS and value is not None:
                value = np.asarray(value)
            fields[f.name] = value
        stories.append(StoryData(**fields))
    return SimpleNeuroidAssembly(stories, obj.validation_method)

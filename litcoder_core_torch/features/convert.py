"""Carry a Flax model's weights to its Hugging Face torch twin.

The JAX package extracts LM and speech features with Flax models; the port
runs the torch twins of the same architectures. torch_state_dict_from_flax
turns a Flax parameter tree into the torch model's state dict without
importing jax or flax (leaves are read through numpy's array protocol), so
features from the two packages can be held against each other on the same
weights:

    model = GPT2Model(config)
    model.load_state_dict(torch_state_dict_from_flax(flax_model.params))

The rule is the one Hugging Face's twins follow: the key is the parameter
path joined with '.'; the leaves `kernel`, `scale` and `embedding` are
named `weight`; every `kernel` has its axes reversed (GPT-2's Conv1D keeps
(out, in) where torch's keeps (in, out), a Dense kernel is (in, out)
against torch's (out, in), and a convolution's (k, in/groups, out)
against torch's (out, in/groups, k)). The weight-normed positional
convolution of Wav2Vec2/HuBERT keeps torch's layout in Flax:
`weight_g` (1, 1, k), the norm of `weight_v` over its output and input
axes at each kernel tap (torch's weight_norm with dim=2), and `weight_v`
(out, in/groups, k) become the parametrization's `original0` and
`original1` unchanged.
"""

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_RENAMED_LEAVES = ("kernel", "scale", "embedding")
_WEIGHT_NORM_LEAVES = {"weight_g": ("parametrizations", "weight",
                                    "original0"),
                       "weight_v": ("parametrizations", "weight",
                                    "original1")}


def _leaves(params: Mapping) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested tree or of a flattened one, whose keys
    are tuples of names or '.'-joined strings."""
    for key, value in params.items():
        if isinstance(value, Mapping):
            for path, leaf in _leaves(value):
                yield (str(key),) + path, leaf
        elif isinstance(key, tuple):
            yield tuple(str(k) for k in key), value
        else:
            yield tuple(str(key).split(".")), value


def torch_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the torch twin of a Flax model, from its parameter
    tree (nested mappings) or the flattened form {path: array}."""
    state = {}
    for path, leaf in _leaves(params):
        array = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            array = array.T
        if name in _RENAMED_LEAVES:
            name = "weight"
        tail = _WEIGHT_NORM_LEAVES.get(name, (name,))
        state[".".join(path[:-1] + tail)] = torch.from_numpy(
            np.array(array, order="C"))
    return state

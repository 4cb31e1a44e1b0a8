"""Carry a Flax language model's weights to its Hugging Face torch twin.

The JAX package extracts LM features with Flax models; the port runs the
torch twins of the same architectures. torch_state_dict_from_flax turns a
Flax parameter tree into the torch model's state dict without importing jax
or flax (leaves are read through numpy's array protocol), so features from
the two packages can be held against each other on the same weights:

    model = GPT2Model(config)
    model.load_state_dict(torch_state_dict_from_flax(flax_model.params))

The rule is the one Hugging Face's GPT-2 twins follow: the key is the
parameter path joined with '.'; the leaves `kernel`, `scale` and
`embedding` are named `weight`; every `kernel` is transposed (Flax's
Conv1D keeps (out, in), torch's (in, out)).
"""

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_RENAMED_LEAVES = ("kernel", "scale", "embedding")


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
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.array(array, order="C"))
    return state

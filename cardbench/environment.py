"""The process environment of a run, set before torch, numpy or
transformers load: no Flax, TensorFlow or JAX backends in transformers, no
network, few host threads, and every build cache of the program at a fixed
place inside the checkout."""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "litcoder_core_torch" / "_build"


def prepare() -> None:
    os.environ.update({
        "USE_FLAX": "0", "USE_TF": "0", "USE_JAX": "0", "USE_TORCH": "1",
        "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
        "TOKENIZERS_PARALLELISM": "false",
        "OMP_NUM_THREADS": "4", "MKL_NUM_THREADS": "4",
        "TRITON_CACHE_DIR": str(BUILD / "triton"),
        "TORCH_EXTENSIONS_DIR": str(BUILD / "torch_extensions"),
    })

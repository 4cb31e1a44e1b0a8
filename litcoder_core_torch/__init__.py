"""litcoder_core_torch — the PyTorch/CUDA port of litcoder_core_tpu.

It keeps the JAX package's public names and metrics contract and runs on an
NVIDIA card: the fused Lanczos+FIR step is a hand-written CUDA kernel
(csrc/lanczos_fir.cu), the rest plain torch ops. Entry points run on the
card by default and raise without one; pass device='cpu' for the CPU.

Ported so far: the dataset processors (assembly.AssemblyGenerator for
LeBel, Narratives and LPP, with brain projection and the surface cache),
AbstractTrainer with wordrate, static-embedding, language-model and speech
features (the LM and speech extractors run torch models on the card, with
the JAX package's activation caches; speech comes as (features, times))
and its TensorBoard, W&B or null logger with the brain plots, all ten
Downsampler methods with FIR delays (Lanczos fused or two-stage, the others
two-stage), both structuring modes, fit_nested_cv with every argument of
the JAX fit (every alpha-search path, voxel chunking, fast_scan,
permutation significance, mesh/n_devices voxel sharding), banded ridge, stacked regression and
variance partitioning over feature spaces (models.fit_banded_ridge,
models.fit_stacked_ridge, models.variance_partitioning, fed by the
trainer's concat_features=False), the fused step parallel.nested_cv_step,
load_assembly/save_assembly, the config-driven command line (cli.main,
the `litcoder-torch` console script, and cli.run), its layer and grid
sweeps (sweeps.run_layer_sweep, sweeps.run_grid_sweep), and the
least-squares and scikit-learn models (models.LinearPredictivityModel,
models.SklearnPredictivityModel), and the scale-out layer (parallel: the
1-D voxel mesh of the fits and the step, and the ('data', 'model') tensor-
parallel mesh of the extractors; a mesh may repeat a device), and the
benchmark guard (utils.benchguard). Optional
packages (transformers, tensorboard,
matplotlib, seaborn, wandb, nibabel, nilearn, soundfile, scikit-learn) are
imported only where they are used; pandas is not needed.
"""

__version__ = "0.1.0"

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.assembly_loader import (
    load_assembly,
    save_assembly,
)
from litcoder_core_torch.assembly.story_data import StoryData
from litcoder_core_torch.downsample.downsampling import Downsampler
from litcoder_core_torch.features.factory import FeatureExtractorFactory
from litcoder_core_torch.features.fir_expander import FIR
from litcoder_core_torch.models.nested_cv import NestedCVModel, fit_nested_cv
from litcoder_core_torch.trainer import AbstractTrainer

__all__ = [
    "AbstractTrainer",
    "Downsampler",
    "FIR",
    "FeatureExtractorFactory",
    "NestedCVModel",
    "SimpleNeuroidAssembly",
    "StoryData",
    "fit_nested_cv",
    "load_assembly",
    "save_assembly",
    "__version__",
]

"""Assembly pickle load/save (twin of
litcoder_core_tpu/assembly/assembly_loader.py).

Pickles name their classes by module path. Those written by the original
LITcoder package (`encoding.assembly.*`) and by the JAX package
(`litcoder_core_tpu.assembly.*`) load into the port's own classes through
an Unpickler that maps those paths, so neither package is imported. Only
unpickle files this program or a trusted source wrote: unpickling can run
arbitrary code.
"""

import io
import logging
import pickle
from pathlib import Path

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.story_data import StoryData

logger = logging.getLogger(__name__)

# Module paths of the other packages -> the port's classes.
_CLASS_ALIASES = {
    ("encoding.assembly.assemblies", "SimpleNeuroidAssembly"):
        SimpleNeuroidAssembly,
    ("encoding.assembly.story_data", "StoryData"): StoryData,
    ("encoding.assembly.assembly_generator", "StoryData"): StoryData,
    ("litcoder_core_tpu.assembly.assemblies", "SimpleNeuroidAssembly"):
        SimpleNeuroidAssembly,
    ("litcoder_core_tpu.assembly.story_data", "StoryData"): StoryData,
}


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        alias = _CLASS_ALIASES.get((module, name))
        if alias is not None:
            return alias
        return super().find_class(module, name)


class AssemblyLoaderError(Exception):
    """Exception for assembly loading errors."""


def validate_assembly(func):
    """Decorator validating the assembly's structure after a load."""

    def wrapper(self, *args, **kwargs):
        assembly = func(self, *args, **kwargs)
        if not self._validate_assembly(assembly):
            raise AssemblyLoaderError("Assembly validation failed")
        return assembly

    return wrapper


class AssemblyLoader:
    """Pickle-based assembly loader with structure validation."""

    def _validate_assembly(self, assembly) -> bool:
        if not getattr(assembly, "stories", None):
            logger.error("Assembly missing stories")
            return False
        if not getattr(assembly, "story_data", None):
            logger.error("Assembly missing story_data")
            return False
        return True

    @validate_assembly
    def load(self, filepath: str) -> SimpleNeuroidAssembly:
        filepath = Path(filepath)
        if not filepath.exists():
            raise FileNotFoundError(f"Assembly file not found: {filepath}")
        try:
            with open(filepath, "rb") as f:
                assembly = _CompatUnpickler(io.BufferedReader(f)).load()
            logger.info("Assembly loaded from %s", filepath)
            return assembly
        except FileNotFoundError:
            raise
        except Exception as e:
            raise AssemblyLoaderError(
                f"Failed to load assembly from {filepath}: {e}"
            ) from e

    def save(self, assembly: SimpleNeuroidAssembly, filepath: str) -> None:
        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        try:
            with open(filepath, "wb") as f:
                pickle.dump(assembly, f, protocol=pickle.HIGHEST_PROTOCOL)
            logger.info("Assembly saved to %s", filepath)
        except Exception as e:
            raise AssemblyLoaderError(
                f"Failed to save assembly to {filepath}: {e}"
            ) from e


def load_assembly(filepath: str) -> SimpleNeuroidAssembly:
    return AssemblyLoader().load(filepath)


def save_assembly(assembly: SimpleNeuroidAssembly, filepath: str) -> None:
    AssemblyLoader().save(assembly, filepath)

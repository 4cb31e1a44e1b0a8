"""Assembly containers of the port and their pickle loader."""

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.assembly_loader import (
    AssemblyLoader,
    AssemblyLoaderError,
    load_assembly,
    save_assembly,
)
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.assembly.story_data import StoryData

__all__ = ["AssemblyLoader", "AssemblyLoaderError", "SimpleNeuroidAssembly",
           "StoryData", "assembly_from_reference", "load_assembly",
           "save_assembly"]

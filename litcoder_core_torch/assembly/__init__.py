"""Data layer of the port: story records, assemblies, the pickle loader and
the dataset processors (host numpy; no pandas, and transformers, nibabel
and nilearn only where they are used)."""

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.assembly_generator import AssemblyGenerator
from litcoder_core_torch.assembly.assembly_loader import (
    AssemblyLoader,
    AssemblyLoaderError,
    load_assembly,
    save_assembly,
)
from litcoder_core_torch.assembly.base_processor import BaseAssemblyGenerator
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.assembly.lebel_processor import LebelAssemblyGenerator
from litcoder_core_torch.assembly.lpp_processor import LPPAssemblyGenerator
from litcoder_core_torch.assembly.narratives_processor import (
    NarrativesAssemblyGenerator,
)
from litcoder_core_torch.assembly.story_data import StoryData

__all__ = ["AssemblyGenerator", "AssemblyLoader", "AssemblyLoaderError",
           "BaseAssemblyGenerator", "LPPAssemblyGenerator",
           "LebelAssemblyGenerator", "NarrativesAssemblyGenerator",
           "SimpleNeuroidAssembly", "StoryData", "assembly_from_reference",
           "load_assembly", "save_assembly"]

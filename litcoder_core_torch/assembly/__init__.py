"""Assembly containers of the port."""

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.assembly.story_data import StoryData

__all__ = ["SimpleNeuroidAssembly", "StoryData", "assembly_from_reference"]

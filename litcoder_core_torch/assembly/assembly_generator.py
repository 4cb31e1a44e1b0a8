"""Dataset type -> processor (twin of
litcoder_core_tpu/assembly/assembly_generator.py)."""

from typing import Optional

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.base_processor import BaseAssemblyGenerator
from litcoder_core_torch.assembly.lebel_processor import LebelAssemblyGenerator
from litcoder_core_torch.assembly.lpp_processor import LPPAssemblyGenerator
from litcoder_core_torch.assembly.narratives_processor import (
    NarrativesAssemblyGenerator,
)


class AssemblyGenerator:
    """Factory for dataset-specific assembly generators."""

    _generators = {
        "narratives": NarrativesAssemblyGenerator,
        "lpp": LPPAssemblyGenerator,
        "lebel": LebelAssemblyGenerator,
    }

    @staticmethod
    def create(dataset_type: str, data_dir: str, tr: float = 1.5,
               use_volume: bool = False, mask_path: Optional[str] = None,
               analysis_mask_path: Optional[str] = None,
               tokenizer=None) -> BaseAssemblyGenerator:
        """The generator for `dataset_type`."""
        if dataset_type not in AssemblyGenerator._generators:
            raise ValueError(f"Unsupported dataset type: {dataset_type}")
        return AssemblyGenerator._generators[dataset_type](
            data_dir, dataset_type, tr, use_volume, mask_path,
            analysis_mask_path, tokenizer,
        )

    @staticmethod
    def generate_assembly(dataset_type: str, data_dir: str, subject: str,
                          tr: float = 1.5, lookback: int = 256,
                          context_type: str = "fullcontext",
                          correlation_length: int = 100,
                          use_volume: bool = False,
                          mask_path: Optional[str] = None,
                          generate_temporal_baseline: bool = False,
                          analysis_mask_path: Optional[str] = None,
                          tokenizer=None) -> SimpleNeuroidAssembly:
        """One call: create the generator and generate the subject's
        assembly."""
        generator = AssemblyGenerator.create(
            dataset_type, data_dir, tr, use_volume, mask_path,
            analysis_mask_path, tokenizer,
        )
        return generator.generate_assembly(
            subject, lookback, context_type, correlation_length,
            generate_temporal_baseline,
        )

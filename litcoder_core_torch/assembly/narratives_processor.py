"""Narratives dataset processor (twin of
litcoder_core_tpu/assembly/narratives_processor.py).

The 21styear BOLD NIfTI of a subject (BIDS names) and 21styear.wav beside
the transcript; responses come from the surface cache when it holds the
file, else from nibabel and the volume or surface processor (a surface
result is stored in the cache); validation_method='inner'."""

import glob
import logging
from pathlib import Path
from typing import Dict, List, Optional

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.base_processor import (
    BaseAssemblyGenerator,
    _word_list,
)
from litcoder_core_torch.assembly.story_data import StoryData
from litcoder_core_torch.brain_projection.simple_cache import (
    get_surface_cache,
)

logger = logging.getLogger(__name__)


class NarrativesAssemblyGenerator(BaseAssemblyGenerator):
    """Generator for Narratives dataset assemblies."""

    STORY_NAME = "21styear"

    def generate_assembly(self, subject: str, lookback: int = 256,
                          context_type: str = "fullcontext",
                          correlation_length: int = 100,
                          generate_temporal_baseline: bool = False,
                          ) -> SimpleNeuroidAssembly:
        subject_dir = self.data_dir / subject
        if not subject_dir.exists():
            raise FileNotFoundError(
                f"Subject directory not found: {subject_dir}"
            )
        story_configs = self._discover_stories(subject_dir)
        if not story_configs:
            raise ValueError(f"No stories found for subject {subject}")

        self.context_type = context_type
        self.lookback = lookback
        story_data_list = [
            self._process_single_story(
                subject=subject,
                story_name=cfg["name"],
                volume_path=cfg["volume_path"],
                correlation_length=correlation_length,
                generate_temporal_baseline=generate_temporal_baseline,
                audio_path=cfg["audio_path"],
            )
            for cfg in story_configs
        ]
        return SimpleNeuroidAssembly(story_data_list,
                                     validation_method="inner")

    def _discover_stories(self, subject_dir: Path) -> List[Dict[str, str]]:
        """The 21styear BOLD NIfTI of the subject and the story's audio."""
        volume_files = glob.glob(str(
            subject_dir / "sub-*_task-21styear_space-MNI152NLin2009cAsym"
                          "_res-2_desc-preproc_bold.nii.gz"
        ))
        audio_files = glob.glob(str(self.data_dir / f"{self.STORY_NAME}.wav"))
        if not volume_files:
            return []
        return [{
            "name": self.STORY_NAME,
            "volume_path": volume_files[0],
            "audio_path": audio_files[0] if audio_files else None,
        }]

    def _load_brain_data(self, subject: str, volume_path: str):
        """(T, V) responses: the surface cache's entry for this subject and
        file, else the NIfTI read with nibabel and processed (shared with
        LPP)."""
        surface_cache = get_surface_cache()
        cached = surface_cache.get(subject, volume_path)
        if cached is not None:
            logger.info("Using cached brain data for subject %s", subject)
            return cached
        import nibabel as nib

        volume = nib.load(volume_path)
        processed = self.brain_processor.process_brain_data(
            volume.get_fdata(), volume.affine
        )
        if hasattr(processed, "combined"):  # surface
            brain_data = processed.combined
            surface_cache.set(subject, volume_path, brain_data)
        else:
            brain_data = processed.data
        return brain_data

    def _process_single_story(self, subject: str, story_name: str,
                              volume_path: str, correlation_length: int = 100,
                              generate_temporal_baseline: bool = False,
                              audio_path: Optional[str] = None) -> StoryData:
        brain_data = self._load_brain_data(subject, volume_path)
        transcript, split_indices, tr_times, data_times, _ = (
            self.process_transcript(self.data_dir, story_name)
        )

        mask_indices = None
        if self.analysis_mask is not None:
            brain_data, mask_indices = self.apply_analysis_mask(brain_data)

        stimuli = self.generate_stimuli_with_context(transcript, self.lookback)
        temporal_baseline = (
            self.create_temporal_baseline(
                stimuli, correlation_length=correlation_length
            ) if generate_temporal_baseline else None
        )
        word_rates = self.compute_word_rate_features(transcript, tr_times)

        return StoryData(
            name=story_name,
            brain_data=brain_data,
            stimuli=stimuli,
            temporal_baseline=temporal_baseline,
            split_indices=split_indices,
            tr_times=tr_times,
            data_times=data_times,
            word_rates=word_rates,
            words=_word_list(transcript),
            mask_indices=mask_indices,
            audio_path=audio_path,
        )

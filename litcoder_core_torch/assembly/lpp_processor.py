"""Le Petit Prince (LPP) dataset processor (twin of
litcoder_core_tpu/assembly/lpp_processor.py).

Runs run-01..09 (BIDS names, `_fixed.nii.gz`); the first 4 TRs are dropped,
then the rows at the TR_onset values are kept, in the order of their set;
validation_method='inner'."""

import logging
from pathlib import Path
from typing import Dict, List, Optional

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.base_processor import _word_list
from litcoder_core_torch.assembly.narratives_processor import (
    NarrativesAssemblyGenerator,
)
from litcoder_core_torch.assembly.story_data import StoryData

logger = logging.getLogger(__name__)


class LPPAssemblyGenerator(NarrativesAssemblyGenerator):
    """Generator for LPP dataset assemblies (the cache-aware volume loading
    of the Narratives one)."""

    RUNS = ["01", "02", "03", "04", "05", "06", "07", "08", "09"]

    def __init__(self, data_dir: str, dataset_type: str, tr: float = 2.0,
                 use_volume: bool = False, mask_path: Optional[str] = None,
                 analysis_mask_path: Optional[str] = None, tokenizer=None):
        super().__init__(data_dir, dataset_type, tr, use_volume, mask_path,
                         analysis_mask_path, tokenizer)

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
        run_configs = self._discover_stories(subject_dir, subject)
        if not run_configs:
            raise ValueError(f"No runs found for subject {subject}")

        self.context_type = context_type
        self.lookback = lookback
        story_data_list = [
            self._process_single_story(
                subject, cfg["name"], cfg["volume_path"],
                correlation_length, generate_temporal_baseline,
                audio_path=None,
            )
            for cfg in run_configs
        ]
        return SimpleNeuroidAssembly(story_data_list,
                                     validation_method="inner")

    def _discover_stories(self, subject_dir: Path,
                          subject: Optional[str] = None
                          ) -> List[Dict[str, str]]:
        """The subject's run-01..09 BOLD NIfTIs that exist."""
        subject = subject or subject_dir.name
        run_configs = []
        for run, section in zip(self.RUNS, range(1, len(self.RUNS) + 1)):
            volume_file = (
                subject_dir / f"{subject}_task-lppEN_run-{run}_space-"
                              "MNI152NLin2009cAsym_res-2_desc-preproc_bold"
                              "_fixed.nii.gz"
            )
            if volume_file.exists():
                run_configs.append({
                    "name": f"run_{run}",
                    "volume_path": str(volume_file),
                    "section": section,
                })
        return run_configs

    def _process_single_story(self, subject: str, story_name: str,
                              volume_path: str, correlation_length: int = 100,
                              generate_temporal_baseline: bool = False,
                              audio_path: Optional[str] = None) -> StoryData:
        brain_data = self._load_brain_data(subject, volume_path)
        transcript, split_indices, tr_times, data_times, TR_onset = (
            self.process_transcript(self.data_dir, story_name)
        )

        # LPP's rows: drop the first 4 TRs, then keep the rows at the
        # TR_onset values in the iteration order of their set (not sorted).
        brain_data = brain_data[4:, :]
        unique_trs = [int(tr) for tr in set(TR_onset)]
        sampled = brain_data[unique_trs, :]

        mask_indices = None
        if self.analysis_mask is not None:
            sampled, mask_indices = self.apply_analysis_mask(sampled)

        stimuli = self.generate_stimuli_with_context(transcript, self.lookback)
        temporal_baseline = (
            self.create_temporal_baseline(
                stimuli, correlation_length=correlation_length
            ) if generate_temporal_baseline else None
        )
        word_rates = self.compute_word_rate_features(transcript, tr_times)

        return StoryData(
            name=story_name,
            brain_data=sampled,
            stimuli=stimuli,
            temporal_baseline=temporal_baseline,
            split_indices=split_indices,
            tr_times=tr_times,
            data_times=data_times,
            words=_word_list(transcript),
            word_rates=word_rates,
            mask_indices=mask_indices,
            audio_path=audio_path,
        )

"""LeBel dataset processor (twin of
litcoder_core_tpu/assembly/lebel_processor.py).

25 stories; responses from one per-subject pickle
(noslice_sub-{subject}_story_data[_surface].pkl), loaded once per subject;
validation_method='outer' (the trainer holds the last story out)."""

import pickle
from pathlib import Path
from typing import Dict, List, Optional

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.assembly.base_processor import (
    BaseAssemblyGenerator,
    _word_list,
)
from litcoder_core_torch.assembly.story_data import StoryData

LEBEL_STORIES = [
    "adollshouse", "adventuresinsayingyes", "alternateithicatom", "avatar",
    "buck", "exorcism", "eyespy", "fromboyhoodtofatherhood", "hangtime",
    "haveyoumethimyet", "howtodraw", "inamoment", "itsabox", "legacy",
    "naked", "odetostepfather", "sloth", "souls", "stagefright",
    "swimmingwithastronauts", "thatthingonmyarm",
    "theclosetthatateeverything", "tildeath", "undertheinfluence",
    "wheretheressmoke",
]


class LebelAssemblyGenerator(BaseAssemblyGenerator):
    """Generator for LeBel dataset assemblies."""

    def __init__(self, data_dir: str, dataset_type: str, tr: float = 1.5,
                 use_volume: bool = False, mask_path: Optional[str] = None,
                 analysis_mask_path: Optional[str] = None, tokenizer=None):
        super().__init__(data_dir, dataset_type, tr, use_volume, mask_path,
                         analysis_mask_path, tokenizer)
        self.stories = list(LEBEL_STORIES)
        self._resp_dict = None
        self._resp_subject = None

    def generate_assembly(self, subject: str, lookback: int = 256,
                          context_type: str = "fullcontext",
                          correlation_length: int = 100,
                          generate_temporal_baseline: bool = False,
                          ) -> SimpleNeuroidAssembly:
        self.lookback = lookback
        self.context_type = context_type
        story_data_list = [
            self._process_single_story(
                subject, story, None, correlation_length,
                generate_temporal_baseline,
                audio_path=f"{self.data_dir}/audio_files/{story}.wav",
            )
            for story in self.stories
        ]
        return SimpleNeuroidAssembly(story_data_list,
                                     validation_method="outer")

    def _discover_stories(self, subject_dir: Path) -> List[Dict[str, str]]:
        """LeBel's stories are fixed (LEBEL_STORIES)."""
        return []

    def _load_responses(self, subject: str):
        # Keyed by subject: a generator serving several subjects must not
        # hand a later one the previous subject's responses.
        if self._resp_dict is None or self._resp_subject != subject:
            suffix = "" if self.use_volume else "_surface"
            path = (self.data_dir /
                    f"noslice_sub-{subject}_story_data{suffix}.pkl")
            with open(path, "rb") as f:
                self._resp_dict = pickle.load(f)
            self._resp_subject = subject
        return self._resp_dict

    def _process_single_story(self, subject: str, story_name: str,
                              volume_path, correlation_length: int = 100,
                              generate_temporal_baseline: bool = False,
                              audio_path: Optional[str] = None) -> StoryData:
        brain_data = self._load_responses(subject).get(story_name)
        transcript, split_indices, tr_times, data_times, _ = (
            self.process_transcript(self.data_dir, story_name)
        )
        stimuli = self.generate_stimuli_with_context(transcript, self.lookback)

        mask_indices = None
        if self.analysis_mask is not None:
            brain_data, mask_indices = self.apply_analysis_mask(brain_data)

        temporal_baseline = (
            self.create_temporal_baseline(
                stimuli, correlation_length=correlation_length
            ) if generate_temporal_baseline else None
        )
        word_rates = self.compute_word_rate_features(transcript, tr_times)

        return StoryData(
            name=story_name,
            brain_data=brain_data,
            words=_word_list(transcript),
            stimuli=stimuli,
            temporal_baseline=temporal_baseline,
            split_indices=split_indices,
            tr_times=tr_times,
            data_times=data_times,
            word_rates=word_rates,
            mask_indices=mask_indices,
            audio_path=audio_path,
        )

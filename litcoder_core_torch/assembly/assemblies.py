"""SimpleNeuroidAssembly container (twin of
litcoder_core_tpu/assembly/assemblies.py). Host numpy: the device sees only
the matrices the trainer builds from it."""

from typing import Dict, List

import numpy as np


class SimpleNeuroidAssembly:
    """Story-separated container with a stacked (presentation, neuroid) view."""

    def __init__(self, story_data_list: List, validation_method: str):
        self.stories = [story.name for story in story_data_list]
        self.story_data = {story.name: story for story in story_data_list}
        self.validation_method = validation_method
        self.data = np.vstack([story.brain_data for story in story_data_list])
        self.dims = ("presentation", "neuroid")
        self.shape = self.data.shape
        self.coords = {
            "story_id": {
                "dim": "presentation",
                "values": np.repeat(
                    self.stories,
                    [len(story.stimuli) for story in story_data_list],
                ),
            },
            "stimulus_id": {
                "dim": "presentation",
                "values": np.concatenate(
                    [np.arange(len(story.stimuli))
                     for story in story_data_list]
                ),
            },
        }

    def get_stimuli(self) -> List[List[str]]:
        return [self.story_data[s].stimuli for s in self.stories]

    def get_split_indices(self) -> List[List[int]]:
        return [self.story_data[s].split_indices for s in self.stories]

    def get_audio_path(self) -> List[str]:
        return [self.story_data[s].audio_path for s in self.stories]

    def get_validation_method(self) -> str:
        """'inner' = nested CV (narratives/lpp); 'outer' = held-out test
        story (lebel)."""
        return self.validation_method

    def get_data_times(self) -> List[np.ndarray]:
        return [self.story_data[s].data_times for s in self.stories]

    def get_tr_times(self) -> List[np.ndarray]:
        return [self.story_data[s].tr_times for s in self.stories]

    def get_brain_data(self) -> List[np.ndarray]:
        return [self.story_data[s].brain_data for s in self.stories]

    def get_temporal_baseline(self, story_name: str) -> np.ndarray:
        if story_name not in self.story_data:
            raise ValueError(f"Story {story_name} not found in assembly")
        return self.story_data[story_name].temporal_baseline

    def get_all_temporal_baselines(self) -> List[np.ndarray]:
        return [self.story_data[s].temporal_baseline for s in self.stories]

    def get_words(self) -> List[List[str]]:
        return [self.story_data[s].words for s in self.stories]

    def get_word_rates(self) -> List[np.ndarray]:
        return [self.story_data[s].word_rates for s in self.stories]

    def get_coord(self, name: str) -> np.ndarray:
        return self.coords[name]["values"]

    def coords_for_dim(self, dim_name: str) -> Dict[str, np.ndarray]:
        return {name: info["values"] for name, info in self.coords.items()
                if info["dim"] == dim_name}

    def __getitem__(self, idx):
        return self.data[idx]

    def __repr__(self) -> str:
        return (f"<SimpleNeuroidAssembly {self.shape}: "
                f"{len(self.stories)} stories>")

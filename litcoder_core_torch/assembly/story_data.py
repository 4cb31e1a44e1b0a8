"""Per-story data record (twin of litcoder_core_tpu/assembly/story_data.py)."""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class StoryData:
    """One story/run of aligned stimulus and brain data (host numpy).

    Attributes:
        name: story/run identifier.
        brain_data: (n_timepoints, n_voxels_or_vertices) responses.
        stimuli: context-window text stimulus per word.
        split_indices: word -> TR map (or legacy boundary list).
        tr_times: TR timestamps.
        data_times: per-word timestamps.
        temporal_baseline: optional synthesized temporal-baseline features.
        word_rates: optional per-TR word counts.
        words: optional raw word list.
        mask_indices: optional indices of kept voxels in the original space.
        audio_path: optional path to the story audio.
    """

    name: str
    brain_data: np.ndarray
    stimuli: List[str]
    split_indices: List[int]
    tr_times: np.ndarray
    data_times: np.ndarray
    temporal_baseline: Optional[np.ndarray] = None
    word_rates: Optional[np.ndarray] = None
    words: Optional[List[str]] = None
    mask_indices: Optional[np.ndarray] = None
    audio_path: Optional[str] = None

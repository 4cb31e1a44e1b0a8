"""Shared dataset-processing logic for assembly generation (twin of
litcoder_core_tpu/assembly/base_processor.py).

Token-budgeted context windows per word (fullcontext, nocontext,
halfcontext), the analysis mask, the content-agnostic temporal baseline,
word rates per TR and the transcript pickle. Host numpy without pandas:
process_transcript returns the transcript as a mapping of numpy columns,
{"word_orig": the words as given, "word_times": float64}, and every
function here takes that mapping or a pandas DataFrame with those
columns. Words are read as pandas' `.astype(str)` reads them (str() of
each item). The tokenizer is injectable; GPT-2's is loaded, by name, only
when none was given.
"""

import logging
import os
import pickle
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from litcoder_core_torch.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_torch.brain_projection.project import (
    SurfaceProcessor,
    VolumeProcessor,
)

logger = logging.getLogger(__name__)


def _word_strings(transcript: Mapping) -> List[str]:
    """The transcript's words as strings (pandas `.astype(str)`)."""
    return [str(w) for w in np.asarray(transcript["word_orig"], dtype=object)]


def _word_list(transcript: Mapping) -> list:
    """The transcript's words as given (pandas `.tolist()`)."""
    return np.asarray(transcript["word_orig"], dtype=object).tolist()


class BaseAssemblyGenerator(ABC):
    """Abstract base for dataset-specific assembly generators."""

    def __init__(
        self,
        data_dir: str,
        dataset_type: str,
        tr: float = 1.5,
        use_volume: bool = False,
        mask_path: Optional[str] = None,
        analysis_mask_path: Optional[str] = None,
        tokenizer=None,
    ):
        self.data_dir = Path(data_dir)
        self.tr = tr
        self.analysis_mask = analysis_mask_path
        self._tokenizer = tokenizer
        self.dataset_type = dataset_type
        self.use_volume = use_volume
        self._brain_processor = None
        self._mask_path = mask_path
        # Defaults; generate_assembly sets both per call.
        self.context_type = "fullcontext"
        self.lookback = 256

    @property
    def tokenizer(self):
        """The injected tokenizer, else GPT-2's (loaded on first use)."""
        if self._tokenizer is None:
            from transformers import GPT2Tokenizer

            self._tokenizer = GPT2Tokenizer.from_pretrained("gpt2")
        return self._tokenizer

    @property
    def brain_processor(self):
        """Volume or surface processor, built on first use (the surface one
        needs nilearn)."""
        if self._brain_processor is None:
            self._brain_processor = (
                VolumeProcessor(mask_path=self._mask_path)
                if self.use_volume else SurfaceProcessor()
            )
        return self._brain_processor

    # ------------------------------------------------------------- abstract

    @abstractmethod
    def generate_assembly(self, subject: str, lookback: int = 256,
                          context_type: str = "fullcontext",
                          correlation_length: int = 100,
                          generate_temporal_baseline: bool = False,
                          ) -> SimpleNeuroidAssembly:
        """Generate an assembly for a subject."""

    @abstractmethod
    def _discover_stories(self, subject_dir: Path) -> List[Dict[str, str]]:
        """Discover stories/runs for a subject."""

    # -------------------------------------------------- stimulus construction

    def generate_stimuli_with_context(self, transcript: Mapping,
                                      lookback: int) -> List[str]:
        """One token-budgeted context window per word."""
        if self.context_type == "fullcontext":
            return self._process_fullcontext(transcript, lookback)
        if self.context_type == "nocontext":
            return self._process_nocontext(transcript, lookback)
        if self.context_type == "halfcontext":
            return self._process_halfcontext(transcript, lookback)
        raise ValueError(f"Invalid context type: {self.context_type}")

    def _process_fullcontext(self, transcript: Mapping,
                             lookback: int) -> List[str]:
        """The preceding `lookback` words and this one; over `lookback`
        tokens, the last `lookback` tokens decoded."""
        words = _word_strings(transcript)
        stimuli: List[str] = []
        for i, w in enumerate(words):
            if w != "":
                text = " ".join(words[max(0, i - lookback):i + 1])
                tokens = self.tokenizer.encode(text, add_special_tokens=False)
                if len(tokens) > lookback:
                    tokens = tokens[-lookback:]
                    text = self.tokenizer.decode(tokens)
                stimuli.append(text.strip())
            else:
                stimuli.append("")
        return stimuli

    def _process_nocontext(self, transcript: Mapping,
                           lookback: int) -> List[str]:
        """Words accumulated from a reset point; once the window reaches
        `lookback` tokens the next word starts a new one."""
        words = _word_strings(transcript)
        stimuli: List[str] = []
        start_idx = 0
        for i, w in enumerate(words):
            if w != "":
                text = " ".join(words[start_idx:i + 1])
                tokens = self.tokenizer.encode(text, add_special_tokens=False)
                stimuli.append(text.strip())
                if len(tokens) >= lookback:
                    start_idx = i + 1
            else:
                stimuli.append("")
        return stimuli

    def _process_halfcontext(self, transcript: Mapping,
                             lookback: int) -> List[str]:
        """A window whose start moves on by lookback // 2 words whenever it
        would exceed `lookback` tokens."""
        words = _word_strings(transcript)
        stimuli: List[str] = []
        start = 0
        i = 0
        half_lookback = lookback // 2
        while i < len(words):
            if words[i] != "":
                text = " ".join(words[start:i + 1])
                tokens = self.tokenizer.encode(text, add_special_tokens=False)
                if len(tokens) > lookback:
                    start += half_lookback
                    continue
                stimuli.append(text.strip())
            else:
                stimuli.append("")
            i += 1
        return stimuli

    # ------------------------------------------------------------- masking

    def apply_analysis_mask(
        self, brain_data: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(masked data, kept column indices)."""
        if self.analysis_mask is None:
            return brain_data, np.arange(brain_data.shape[1])
        mask = np.asarray(self.analysis_mask, dtype=bool)
        if mask.shape[0] != brain_data.shape[1]:
            raise ValueError(
                f"Analysis mask size ({mask.shape[0]}) doesn't match brain "
                f"data ({brain_data.shape[1]})"
            )
        masked = brain_data[:, mask]
        logger.info("Applied analysis mask: %d -> %d voxels/vertices",
                    brain_data.shape[1], masked.shape[1])
        return masked, np.where(mask)[0]

    # ----------------------------------------------------- temporal baseline

    def create_temporal_baseline(self, stimuli_list, d_model: int = 128,
                                 correlation_length: int = 75) -> np.ndarray:
        """Content-agnostic temporal features: the spectral embedding of the
        exp(-|i - j| / correlation_length) autocorrelation matrix."""
        n = len(stimuli_list)
        logger.info("Creating temporal baseline for %d stimuli "
                    "(d_model=%d, correlation_length=%d)",
                    n, d_model, correlation_length)
        return self._create_temporal_baseline(n, d_model, correlation_length)

    @staticmethod
    def _create_temporal_baseline(n_stimuli: int, d_model: int = 128,
                                  correlation_length: int = 75) -> np.ndarray:
        idx = np.arange(n_stimuli)
        autocorr = np.exp(
            -np.abs(idx[:, None] - idx[None, :]) / correlation_length
        )
        # Symmetric PSD: eigh, descending, gives U * sqrt(s) up to column
        # signs.
        evals, evecs = np.linalg.eigh(autocorr)
        evals, evecs = evals[::-1], evecs[:, ::-1]
        d = min(d_model, n_stimuli)
        return evecs[:, :d] * np.sqrt(np.maximum(evals[:d], 0.0))

    # ------------------------------------------------------------ word rates

    def compute_word_rate_features(self, transcript: Mapping,
                                   tr_times: np.ndarray) -> np.ndarray:
        """Non-empty words per TR, (n_trs, 1): bins [t_i, t_{i+1}), the last
        one [t_last, t_last + tr)."""
        nonempty = np.array([w.strip() != ""
                             for w in _word_strings(transcript)], dtype=bool)
        times = np.asarray(transcript["word_times"], float)[nonempty]
        tr_times = np.asarray(tr_times, float)
        edges = np.concatenate([tr_times, [tr_times[-1] + self.tr]])
        # np.histogram closes its last bin on the right; these bins are
        # half-open, so words exactly at the final edge are dropped.
        times = times[times < edges[-1]]
        counts, _ = np.histogram(times, bins=edges)
        return counts.astype(float).reshape(-1, 1)

    # -------------------------------------------------------------- transcript

    def process_transcript(self, data_dir, story_name: str):
        """Read {dataset_type}_data.pkl and return (transcript mapping,
        split_indices, tr_times, data_times, TR_onset)."""
        with open(os.path.join(data_dir, f"{self.dataset_type}_data.pkl"),
                  "rb") as f:
            data = pickle.load(f)
        story = next(
            (s for s in data if s.get("story_name") == story_name), None
        )
        if story is None:
            available = [s.get("story_name") for s in data]
            raise ValueError(
                f"Story '{story_name}' not found in "
                f"{self.dataset_type}_data.pkl. Available stories: {available}"
            )
        words = np.empty(len(story["words"]), dtype=object)
        words[:] = list(story["words"])
        word_times = np.asarray(story["data_times"], dtype=float)
        if words.shape != word_times.shape:
            raise ValueError("All arrays must be of the same length")
        transcript = {"word_orig": words, "word_times": word_times}
        return (transcript, story["split_indices"], story["tr_times"],
                story["data_times"], story.get("TR_onset"))

"""LeBel-shaped stories of fullcontext windows, and the stub tokenizer.

Frozen copies of chip_smoke.make_story's timing, chip_smoke.
fullcontext_windows and litcoder_core_torch.utils.testing.HashStubTokenizer,
so that later changes to the program cannot move the traffic. Every seed
gives every story the same number of words (`words_per_story`), so every
seed asks for the same windows, tokens and forwards; only the words, their
times and the weights differ.
"""

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np


class StubTokenizer:
    """Whitespace tokenizer with stable ids 3 + md5(word) % 500 (one token
    per word), BOS 1, EOS 2, pad 0: the tokenizer surface the LM extractor
    uses."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0

    def encode(self, text: str) -> List[int]:
        return [3 + int(hashlib.md5(w.encode()).hexdigest(), 16) % 500
                for w in text.split()]


def fullcontext_windows(words: List[str], lookback: int) -> List[str]:
    """For word i, the words max(0, i - lookback)..i joined by spaces and
    cut to their last `lookback` tokens (the stub tokenizer gives one token
    per word, so a window holds its last `lookback` words)."""
    return [" ".join(words[max(0, i - lookback):i + 1][-lookback:])
            for i in range(len(words))]


@dataclass
class Story:
    """Host-side timing and text of one story; responses come later."""

    name: str
    words: List[str]
    windows: List[str]
    data_times: np.ndarray   # (n_words,) float32, sorted
    tr_times: np.ndarray     # (n_tr,) float32
    split: np.ndarray        # (n_words,) int: the TR of each word


def lebel_stories(seed: int, n_stories: int, n_tr: int, tr_seconds: float,
                  words_per_story: int, vocab_size: int,
                  lookback: int) -> List[Story]:
    """`n_stories` stories of `n_tr` TRs: word times uniform over the span
    and sorted, TR times at the middle of each TR, words drawn from a
    vocabulary of `vocab_size` names."""
    rng = np.random.default_rng(seed)
    span = n_tr * tr_seconds
    stories = []
    for i in range(n_stories):
        data_times = np.sort(rng.uniform(0, span, words_per_story)).astype(
            np.float32)
        tr_times = (np.arange(n_tr) * tr_seconds + tr_seconds / 2).astype(
            np.float32)
        words = [f"w{j}" for j in rng.integers(0, vocab_size,
                                               words_per_story)]
        split = np.clip((data_times // tr_seconds).astype(int), 0, n_tr - 1)
        stories.append(Story(f"story{i:03d}", words,
                             fullcontext_windows(words, lookback),
                             data_times, tr_times, split))
    return stories


def token_ids(story: Story) -> List[List[int]]:
    """Each window's ids as the extractor forms them: BOS, then the words'
    (one md5 per distinct word)."""
    tok = StubTokenizer()
    ids = {w: tok.encode(w)[0] for w in set(story.words)}
    return [[tok.bos_token_id] + [ids[w] for w in window.split()]
            for window in story.windows]

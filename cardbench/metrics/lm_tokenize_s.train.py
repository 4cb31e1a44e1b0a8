"""lm_tokenize_s.train: host seconds per traced train() in the
`litcoder.lm.tokenize` spans: the LM extractor's tokenizing
(metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.tokenize", "host")

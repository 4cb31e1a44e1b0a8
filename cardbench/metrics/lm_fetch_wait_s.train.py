"""lm_fetch_wait_s.train: host seconds per traced train() in the
`litcoder.lm.fetch_wait` spans: the LM extractor's waits for pooled results
(metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.fetch_wait", "host")

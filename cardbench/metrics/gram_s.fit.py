"""gram_s.fit: device-stream seconds per traced fit in the
`litcoder.fit.gram` spans: fit Gram, X^T Y and X X^T (each formed, in the
search and the refit) (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.gram", "device")

"""search_s.fit: device-stream seconds per traced fit in the
`litcoder.fit.search` spans: alpha searches (the Gram, lambda-max and
scoring inside them) (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.search", "device")

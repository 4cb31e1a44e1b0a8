"""refit_s.fit: device-stream seconds per traced fit in the
`litcoder.fit.refit` spans: refit, held-out predictions, r and the
permutation null (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.refit", "device")

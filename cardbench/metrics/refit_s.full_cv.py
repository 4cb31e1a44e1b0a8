"""refit_s.full_cv: device-stream seconds per traced fit in the
`litcoder.fit.refit` spans: refits, held-out predictions and r of every
outer fold (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.refit", "device")

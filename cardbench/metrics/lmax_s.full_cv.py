"""lmax_s.full_cv: device-stream seconds per traced fit in the
`litcoder.fit.lmax` spans: Lanczos lambda-max calls (lmax_dense, one per
inner fold) (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.lmax", "device")

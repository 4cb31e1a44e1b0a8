"""host_stats_s.full_cv: host seconds per traced fit in the
`litcoder.fit.host_stats` spans: host statistics: per-fold p-values and
BH-FDR, Fisher, the majority mask, the metrics (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.host_stats", "host")

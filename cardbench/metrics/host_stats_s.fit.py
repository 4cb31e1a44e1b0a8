"""host_stats_s.fit: host seconds per traced fit in the
`litcoder.fit.host_stats` spans: host statistics: the copies of r and p,
p-values, BH-FDR, Fisher, the metrics (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.host_stats", "host")

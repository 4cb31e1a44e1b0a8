"""lm_host_prep_s.train: host seconds per traced train() in the
`litcoder.lm.dispatch` spans (pad, bucket and enqueue of each batch), with
their `litcoder.lm.fetch_wait` children taken out (metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.dispatch", "host",
                           self_time=True)

"""weights_to_host_s.train: host seconds per traced train() in the
`litcoder.fit.weights_to_host` spans: the refit's weights copied into the
host array handed to the trainer's saver (metrics/_spans.py). None where
the program records no such span."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.fit.weights_to_host", "host")

"""train_s: seconds per AbstractTrainer.train(), the window over the
train() calls completed in it (host clock; each ends in a device
synchronize)."""

from cardbench.metrics._reads import seconds_per_job as read  # noqa: F401

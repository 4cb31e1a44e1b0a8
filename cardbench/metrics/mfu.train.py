"""mfu.train: a train()'s operations (the LM forwards under causal prefix
reuse and the fit, metrics/_counts.py) over the seconds per traced
train(), as a share of the float32 peak, in percent."""

from cardbench.metrics._reads import mfu as read  # noqa: F401

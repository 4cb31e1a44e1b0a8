"""mfu.fit: a fit's operations (metrics/_counts.py, from the cell's
shapes and folds) over the seconds per traced fit, as a share of the
float32 peak, in percent."""

from cardbench.metrics._reads import mfu as read  # noqa: F401

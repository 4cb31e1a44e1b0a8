"""fit_s: seconds per fit_nested_cv on the Cholesky-route cells, the window
over the fits completed in it (host clock; each fit ends in a device
synchronize)."""

from cardbench.metrics._reads import seconds_per_job as read  # noqa: F401

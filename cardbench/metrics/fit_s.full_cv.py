"""fit_s.full_cv: seconds per full nested-CV fit_nested_cv (the per-fold
dual route), the window over the fits completed in it (host clock; each
fit ends in a device synchronize)."""

from cardbench.metrics._reads import seconds_per_job as read  # noqa: F401

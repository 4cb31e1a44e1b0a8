"""idle_share.fit: the share of the traced window in which no kernel,
copy or memset ran on the device, in percent."""

from cardbench.metrics._reads import idle_share as read  # noqa: F401

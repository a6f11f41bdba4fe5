"""idle_share.serve: the share of the traced window with no device activity, %."""

from benchmark.readers import idle_share as read  # noqa: F401

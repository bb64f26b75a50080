"""device_idle_share.stream: the card's idle share of the stream job's
traced window, in % (``trace.idle_share``)."""

from portbench.trace import idle_share as read  # noqa: F401

"""Share of the traced window in which the device ran nothing (profiler)."""
from portbench.readers import idle_share as read  # noqa: F401

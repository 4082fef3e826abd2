"""95th percentile of every read's latency in the window, from submit
to the end of the tick that answered it (host clock)."""
from portbench.readers import p95_ms as read  # noqa: F401

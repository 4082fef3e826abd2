"""Reads aligned or probed per second of the window (host clock)."""
from portbench.readers import rate as read  # noqa: F401

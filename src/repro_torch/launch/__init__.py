"""Launchers of the port: ``serve`` (the match and stream workloads)."""

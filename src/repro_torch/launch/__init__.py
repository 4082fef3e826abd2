"""Launchers of the port: ``serve`` (the match, stream and lm workloads)
and ``train`` (the LM training loop)."""

"""Checkpoints of the port (``manager.CheckpointManager``), on the
reference's on-disk layout."""

"""Optimizers of the port (``adamw``), as tensor ops."""

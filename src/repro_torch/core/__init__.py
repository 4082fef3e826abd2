"""Encodings and the planner's cost layer (port of ``repro.core``)."""

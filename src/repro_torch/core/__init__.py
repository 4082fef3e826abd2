"""CRAM-PM core (port of ``repro.core``): the paper's contribution.

Layers (bottom-up): device/tech model -> analog gate model -> array
interpreter (a CUDA kernel on the card) -> ISA/codegen -> matcher
(Algorithm 1) -> scheduling -> cost model, plus the encodings and the
planner's cost layer (``tech``).
"""

from . import array, costmodel, encoding, gates, isa, matcher, scheduler, tech

__all__ = [
    "array", "costmodel", "encoding", "gates", "isa", "matcher",
    "scheduler", "tech",
]

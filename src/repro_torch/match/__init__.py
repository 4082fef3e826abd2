"""Match-engine subsystem of the PyTorch port (counterpart of ``repro.match``).

* ``PackedCorpus`` -- fragments packed once into device-resident SWAR and
  one-hot forms, growable in place.
* ``MatchQuery`` -- frozen, hashable, declarative query IR (exact / IUPAC
  / N-wildcard predicates, reduction spec, row subset, backend hints).
* ``Planner`` / ``Plan`` -- roofline kernel selection (swar / mxu / ref)
  priced against the H100, plus all tile/pad geometry for one query.
* ``MatchEngine`` / ``CompiledMatch`` / ``MatchResult`` -- query compiler
  over a streaming executor with fused best / top-k / threshold
  reductions per row chunk.

Later slices add ``CorpusIndex``, ``MatchService``, ``PatternBank`` and
calibration.
"""

from repro_torch.obs import MetricsRegistry, Observability, Tracer

from .corpus import PackedCorpus
from .engine import CompiledMatch, MatchEngine, MatchResult
from .feedback import EwmaRatio, FeedbackStore, kernel_key
from .planner import Plan, Planner
from .query import MatchQuery, as_masks, as_query

__all__ = ["PackedCorpus", "Planner", "Plan", "MatchQuery", "as_query",
           "as_masks", "CompiledMatch", "MatchEngine", "MatchResult",
           "EwmaRatio", "FeedbackStore", "kernel_key", "Observability",
           "Tracer", "MetricsRegistry"]
